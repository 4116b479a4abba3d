"""The consensus state machine, its WAL, timeout ticker, height vote sets
and height ledger (the port's copies of the JAX package's consensus/
modules; the reactor comes with the network slice)."""
