"""The benchmark of cometbft_tpu_torch on one NVIDIA H100: a data-driven
harness (see README.md)."""
