"""RPC: the JSON-RPC HTTP client and the RPC-backed light provider (the
port's copy of the JAX package's rpc/client.py; the server comes with the
network slice)."""
