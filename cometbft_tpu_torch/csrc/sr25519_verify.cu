// sr25519_verify: batched schnorrkel (sr25519) verification of packed
// columns on Hopper.
//
// Replaces: cometbft_tpu/ops/sr25519_kernel.py `_kernel_sr` (launched by
// `_verify_rows_sr`, also under `_verify_tally_rows_sr`).
//
// What bounds it on an H100: integer multiply-adds. One signature costs
// about 3,300 field multiplications and squarings (two ristretto decodes,
// each a 251-squaring power chain; 63 windows of four doublings and an
// add; the 32-window comb), each 55 or 100 32 x 32 -> 64 bit limb products
// (sr25519_kernel.VERIFY_FE_* count them); the bytes are 148 B of packed
// rows in and 4 B out per signature, plus the 983 KB ed25519 comb table,
// which stays in the 50 MB L2.
//
// Design: the ed25519_verify kernel's, over the same arithmetic
// (csrc/ed25519_core.cuh: radix-2^25.5 int32 limbs, the integer niels comb
// of the ed25519 basepoint, the per-signature cached table of [d](-A) in
// local memory). One thread per signature, 128 threads a block. The
// ristretto decode (csrc/ristretto_core.cuh) replaces ZIP-215
// decompression, and the coset equality with R replaces the cofactored
// identity check. The merlin challenge is computed on the host.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ristretto_core.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
sr25519_verify_kernel(const int32_t* __restrict__ rows, int B,
                      const cbt::ge_niels* __restrict__ base,
                      int32_t* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  out[col] = cbt::verify_column_sr(rows, B, col, base);
}

}  // namespace

// rows: (>= C_KROWS, B) int32, row-major; base: (8192, 3, 10) int32 niels
// table; out: (B,) int32 verdicts. Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError().
extern "C" int cbt_sr25519_verify(const int32_t* rows, int B,
                                  const int32_t* base, int32_t* out,
                                  void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  sr25519_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, B, reinterpret_cast<const cbt::ge_niels*>(base), out);
  return (int)cudaGetLastError();
}
