// ed25519_verify_cached: batched ZIP-215 verification against a
// device-resident valset table, on Hopper.
//
// Replaces: cometbft_tpu/ops/ed25519_cached.py `_kernel` (launched by
// `_verify_tally_cached`), with the `valid &= ok[b mod M]` that follows it.
//
// What bounds it on an H100: integer multiply-adds. A column that runs to
// its end costs one square-root chain (R), 28 doublings and 64 mixed adds
// for h(-A) from the table, 32 mixed adds for the [s]B comb, and the
// cofactor check; the bytes are 108 B of packed rows, 4 B out and 96
// gathered table and comb entries (11.5 KB) per column, most of them from
// the table, which stays in the 50 MB L2 up to M of about 3,000.
//
// Design: one thread per column, 128 threads a block. Column b is validator
// v = b mod M; the kernel derives v from b and M, as the TPU kernel derives
// its table block from its grid index, so the packed rows carry no index.
// Table and comb entries are integer niels points gathered by digit, so no
// float rounding touches a limb. Dead lanes, failed prechecks and keys
// without ok return 0 at once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_cached.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ed25519_verify_cached_kernel(const int32_t* __restrict__ rows, int B,
                             const cbt::ge_niels* __restrict__ tab, int M,
                             const uint8_t* __restrict__ ok,
                             const cbt::ge_niels* __restrict__ base,
                             int32_t* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  out[col] = cbt::verify_column_cached(rows, B, col, tab, M, ok, base);
}

}  // namespace

// rows: (>= 27, B) int32 cached packed rows; tab: (M * 128, 3, 10) int32
// valset table; ok: (M,) bool; base: (8192, 3, 10) int32 comb table; out:
// (B,) int32 verdicts. Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
extern "C" int cbt_ed25519_verify_cached(const int32_t* rows, int B,
                                         const int32_t* tab, int M,
                                         const uint8_t* ok,
                                         const int32_t* base, int32_t* out,
                                         void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  ed25519_verify_cached_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, B, reinterpret_cast<const cbt::ge_niels*>(tab), M, ok,
      reinterpret_cast<const cbt::ge_niels*>(base), out);
  return (int)cudaGetLastError();
}
