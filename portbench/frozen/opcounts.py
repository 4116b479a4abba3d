"""Work a verified signature needs, and the card's peak rate for it.

The counts are 32 x 32 -> 64 bit limb products (a field multiplication
is 100 of them, a squaring 55), copied from the program at commit
11dbd9c1db08fa78cfd421f2794b4ad265f950b7:
cometbft_tpu_torch/ops/ed25519_fused.py `verify_products_per_signature`
(1,738 multiplications and 1,530 squarings a general ZIP-215 verify) and
cometbft_tpu_torch/ops/ed25519_cached.py
`verify_cached_products_per_signature` (800 and 379 against a valset's
window table). They are fixed here whatever implements the kernels: a
share over 100 % means a count is stale, and correcting it changes the
benchmark.

The peak counts one product as one INT32 multiply-add: 64 a clock on
each streaming multiprocessor of compute capability 9.0 (the CUDA C++
Programming Guide's table of arithmetic instruction throughput), 132
multiprocessors (NVIDIA H100 SXM5), at 1,980 MHz, the H100 SXM5's
highest SM clock (`nvidia-smi --query-gpu=clocks.max.sm`). A run prints
the card's measured `clocks.sm` and `power.limit` beside it.
"""

MULADDS_PER_SIGNATURE = {
    "ed25519_verify": 1738 * 100 + 1530 * 55,   # 257,950
    "cached_verify": 800 * 100 + 379 * 55,      # 100,845
}

SMS = 132
MULADDS_PER_SM_CLOCK = 64
CLOCK_HZ = 1.98e9
PEAK_MULADDS_PER_S = SMS * MULADDS_PER_SM_CLOCK * CLOCK_HZ  # 1.673e13
