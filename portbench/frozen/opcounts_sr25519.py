"""Work a verified sr25519 signature needs, beside `frozen/opcounts.py`.

The count is of 32 x 32 -> 64 bit limb products (a field multiplication
is 100 of them, a squaring 55), copied from the program at commit
27ad187b7944f8030bffd4ac1bbd5429dd7c5740:
cometbft_tpu_torch/ops/sr25519_kernel.py `verify_products_per_signature`
(1,732 multiplications and 1,522 squarings a verify: two ristretto
decodes, [s]B over the comb and [k](-A) windowed, the coset equality).
It is fixed here whatever implements the kernel: a share over 100 %
means the count is stale, and correcting it changes the benchmark. The
peak is `opcounts.PEAK_MULADDS_PER_S`.
"""

MULADDS_PER_SIGNATURE = 1732 * 100 + 1522 * 55   # 256,910
