"""Mempool: the CheckTx-gated tx queue, its admission control and the
signed-tx envelope whose signatures ride the verify plane's BULK lane (the
port's copies of the JAX package's mempool/; the gossip reactor comes with
the network slice)."""
