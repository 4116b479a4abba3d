"""Evidence: verification of duplicate-vote and light-client-attack
evidence, and the pool that holds it (the port's copies of the JAX
package's evidence/verify.py and pool.py; the reactor comes with the
network slice)."""
