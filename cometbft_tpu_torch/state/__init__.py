"""Chain state (the port's counterpart of the JAX package's state/):
`State` and its sqlite store, and the block executor."""
