"""ABCI: the application boundary (the port's copies of the JAX package's
abci/types.py and the kvstore test application; the socket and gRPC
servers, the CLI and the proxy come with the network slice)."""
