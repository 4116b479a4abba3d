"""Node configuration and its TOML file (the port's copy of the JAX
package's config/)."""
