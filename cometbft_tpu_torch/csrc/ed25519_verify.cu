// ed25519_verify: batched ZIP-215 verification of packed columns on Hopper.
//
// Replaces: cometbft_tpu/ops/ed25519_pallas.py `_kernel` (launched by
// `_verify_rows`, also under `_verify_tally_rows`).
//
// What bounds it on an H100: integer multiply-adds. One signature costs
// about 3,300 field multiplications (two square-root chains, 63 windows of
// four doublings and an add, the 32-window comb), each 55 or 100 32 x 32 ->
// 64 bit limb products; the bytes are 148 B of packed rows in and 4 B out
// per signature, plus a 983 KB comb table that stays in the 50 MB L2.
//
// Design: one thread per signature, 128 threads a block, so a 16,384-row
// batch is 128 blocks on 132 SMs. Field elements are ten radix-2^25.5
// int32 limbs (csrc/ed25519_core.cuh) so every limb product is one
// 32-bit multiply-add pair on the integer pipe; the TPU kernel's float32
// one-hot matmul for the base comb becomes an integer gather from the
// device-resident niels table, so no float rounding can touch the limbs.
// The per-signature table of 16 cached points (2.5 KB) lives in the
// thread's local memory. Padding and precheck-failed columns return early
// with verdict 0. Field mul/square are out-of-line calls to bound code
// size and build time; inlining them is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_core.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ed25519_verify_kernel(const int32_t* __restrict__ rows, int B,
                      const cbt::ge_niels* __restrict__ base,
                      int32_t* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  out[col] = cbt::verify_column(rows, B, col, base);
}

}  // namespace

// rows: (>= C_KROWS, B) int32, row-major; base: (8192, 3, 10) int32 niels
// table; out: (B,) int32 verdicts. Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError().
extern "C" int cbt_ed25519_verify(const int32_t* rows, int B,
                                  const int32_t* base, int32_t* out,
                                  void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  ed25519_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, B, reinterpret_cast<const cbt::ge_niels*>(base), out);
  return (int)cudaGetLastError();
}
