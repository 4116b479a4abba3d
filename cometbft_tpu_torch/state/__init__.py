"""Chain state (the port's counterpart of the JAX package's state/): only
the validator-set serde the light store needs so far."""
