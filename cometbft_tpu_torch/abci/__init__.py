"""ABCI: the application boundary (the port's copies of the JAX package's
abci/types.py, the kvstore test application and the in-process proxy,
abci/proxy.py; the socket and gRPC servers and the CLI come with the
network slice)."""
