"""Node and LocalNetwork: one process, many validators (the port's copy
of the JAX package's node/node.py)."""
