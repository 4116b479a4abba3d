"""Block storage (the port's copy of the JAX package's store/)."""
