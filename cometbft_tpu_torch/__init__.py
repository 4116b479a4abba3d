"""PyTorch/CUDA port of cometbft_tpu's device path.

Batched ed25519 ZIP-215 verification and the fused voting-power quorum
tally, on kernels written by hand for NVIDIA Hopper (csrc/), with a plain
PyTorch version beside each kernel. The package imports torch and numpy
and keeps its own copies of the host modules it needs (crypto, types,
libs); it imports nothing of the JAX package.
"""
