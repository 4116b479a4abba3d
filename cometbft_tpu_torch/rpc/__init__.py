"""RPC: the JSON-RPC server (rpc/server.py), the HTTP client and the
RPC-backed light provider (rpc/client.py): the port's copies of the JAX
package's modules."""
