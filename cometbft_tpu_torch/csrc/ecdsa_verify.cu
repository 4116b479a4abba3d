// ecdsa_verify: batched secp256k1 ECDSA verification of packed columns on
// Hopper.
//
// Replaces: cometbft_tpu/ops/ecdsa_pallas.py `_kernel` (launched by
// `_verify_rows`).
//
// What bounds it on an H100: integer multiply-adds. One signature costs
// about 3,600 field multiplications and squarings (a 253-squaring square
// root, 252 complete doublings of 6M + 2S, 63 + 14 + 32 + 1 complete
// additions of 12M), each 55 or 100 32 x 32 -> 64 bit limb products
// (ecdsa_fused.VERIFY_FE_* count them); the bytes are 188 B of packed rows
// in and 4 B out per signature, plus a 983 KB comb table of G that stays in
// the 50 MB L2.
//
// Design: one thread per signature, 128 threads a block, as
// ed25519_verify. The field is new (csrc/secp256k1_core.cuh): ten signed
// 26-bit limbs in int32, products summed in int64 columns and folded
// through 2^260 = 2^36 + 0x3D10. The points use the Renes-Costello-Batina
// complete formulas, so padding, the identity rows of the comb (d = 0)
// and doublings need no branch. The TPU kernel's float32 one-hot matmul
// for the comb of G becomes an integer gather from a device-resident
// table of projective entries, so no float rounding touches a limb. The
// 16-entry table of [d]Q (1.9 KB) lives in the thread's local memory.
// Padding and precheck-failed columns return early with verdict 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "secp256k1_core.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ecdsa_verify_kernel(const int32_t* __restrict__ rows, int B,
                    const cbt_secp::gpt* __restrict__ base,
                    int32_t* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  out[col] = cbt_secp::ecdsa_verify_column(rows, B, col, base);
}

}  // namespace

// rows: (>= E_KROWS, B) int32, row-major; base: (8192, 3, 10) int32 comb
// table; out: (B,) int32 verdicts. Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError().
extern "C" int cbt_ecdsa_verify(const int32_t* rows, int B,
                                const int32_t* base, int32_t* out,
                                void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  ecdsa_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, B, reinterpret_cast<const cbt_secp::gpt*>(base), out);
  return (int)cudaGetLastError();
}
