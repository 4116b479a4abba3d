"""Blocksync: streaming verification of consecutive commits (the port's
counterpart of the JAX package's blocksync/pipeline.py)."""
