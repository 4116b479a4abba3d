"""Light client: adjacent and skipping verification, the bisecting client
and its trusted stores (the port's copies of the JAX package's light/
verifier.py, client.py and store.py). Commits route through the running
verify plane by default, so on a card plane their signatures verify on
the device."""
