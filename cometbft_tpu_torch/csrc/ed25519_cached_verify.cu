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
// Design: two entries with the same arguments and verdicts.
//
// The quad entry (cbt_ed25519_verify_cached) runs four threads a column
// (csrc/ed25519_cached_quad.cuh over csrc/ed25519_quad.cuh). Lane k holds
// coordinate k of the accumulator and gathers component k of each niels
// entry, from the valset table and the base comb alike, so each addition
// and doubling is two field multiplications a lane, operands moving inside
// the quad by __shfl_sync. R's decompression (a square-root chain that
// cannot be split) runs first, one column a thread on the block's first
// warp, through the out-of-line field ops, and reaches the quads as x
// through shared memory, which keeps its registers out of the quad
// program's. 128 threads a block (32 columns, so the first warp's 32
// threads all decode; 1,408 B of shared memory) and at most 168 registers,
// three blocks (twelve warps) an SM, so the cached 10k commit's 10,240
// columns are one wave over the 132 SMs. A warp runs the quad program only
// if one of its quads is live (precheck passed, ok[v], R decoded), all 32
// threads in step; other quads' verdicts are masked to 0, as are padding
// columns'. Its chain is a third of one thread's, but it issues more
// instructions a column (exchanges, lane coefficients, lane 3's product by
// Z = 1), so it wins while the card has idle schedulers and loses once
// every SM is full.
//
// The one-thread entry (cbt_ed25519_verify_cached_thread) runs
// cbt::verify_column_cached, one thread a column, 128 threads a block (160
// registers). The wrapper (ops/ed25519_cached.py verify_cached_entry)
// launches the quad up to a crossover in columns an SM and this entry
// above it.
//
// Measured by chip_smoke.py (device time; NVIDIA H100 80GB HBM3, 700.00 W;
// M = 1,024 unless stated), quad / one-thread: 0.249 / 0.584 ms at 8,192
// columns, 0.331 / 0.585 at 10,240, 0.576 / 0.583 at 16,384, 0.877 / 0.794
// at 32,768, 1.783 / 1.571 at 65,536; 0.338 / 0.680 at 10,240 columns with
// M = 16,384 (the cached 10k commit).
//
// Column b is validator v = b mod M in both entries; the kernel derives v
// from b and M, as the TPU kernel derives its table block from its grid
// index, so the packed rows carry no index.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_cached_quad.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = kThreads / 4;
// three blocks (twelve warps) an SM: at most 168 registers a thread, since
// a scheduler's 16,384 registers must hold three of them
constexpr int kBlocksPerSm = 3;

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ed25519_verify_cached_quad_kernel(const int32_t* __restrict__ rows, int B,
                                  const cbt::ge_niels* __restrict__ tab,
                                  int M, const uint8_t* __restrict__ ok,
                                  const cbt::ge_niels* __restrict__ base,
                                  int32_t* __restrict__ out) {
  __shared__ int32_t dec[kCols][11];  // R's x limbs, then ok
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kCols;
  if (tid < kCols) {  // the first warp decodes the block's 32 R's
    const int col = col0 + tid;
    cbt::fe x = cbt::fe_zero();
    const int live =
        col < B ? cbt_quad::decode_r_cached(rows, B, col, M, ok, &x) : 0;
#pragma unroll
    for (int i = 0; i < 10; i++) dec[tid][i] = x.v[i];
    dec[tid][10] = live;
  }
  __syncthreads();
  const int q = tid >> 2, col = col0 + q;
  const bool live = col < B && dec[q][10];
  const bool writer = (tid & 3) == 0 && col < B;
  if (!__any_sync(0xffffffffu, live)) {  // the whole warp is dead
    if (writer) out[col] = 0;
    return;
  }
  cbt::fe xR;
#pragma unroll
  for (int i = 0; i < 10; i++) xR.v[i] = dec[q][i];
  const int v = cbt_quad::quad_verdict_cached<1>(
      rows, B, col < B ? col : B - 1, tab, M, base, xR);
  if (writer) out[col] = live ? v : 0;
}

__global__ void __launch_bounds__(kThreads)
ed25519_verify_cached_thread_kernel(const int32_t* __restrict__ rows, int B,
                                    const cbt::ge_niels* __restrict__ tab,
                                    int M, const uint8_t* __restrict__ ok,
                                    const cbt::ge_niels* __restrict__ base,
                                    int32_t* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  out[col] = cbt::verify_column_cached(rows, B, col, tab, M, ok, base);
}

}  // namespace

// rows: (>= 27, B) int32 cached packed rows; tab: (M * 128, 3, 10) int32
// valset table; ok: (M,) bool; base: (8192, 3, 10) int32 comb table; out:
// (B,) int32 verdicts. Launches 4 B threads on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError().
extern "C" int cbt_ed25519_verify_cached(const int32_t* rows, int B,
                                         const int32_t* tab, int M,
                                         const uint8_t* ok,
                                         const int32_t* base, int32_t* out,
                                         void* stream) {
  if (B <= 0) return 0;
  const long long threads = 4LL * B;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  ed25519_verify_cached_quad_kernel<<<blocks, kThreads, 0,
                                      (cudaStream_t)stream>>>(
      rows, B, reinterpret_cast<const cbt::ge_niels*>(tab), M, ok,
      reinterpret_cast<const cbt::ge_niels*>(base), out);
  return (int)cudaGetLastError();
}

// The same arguments and verdicts, B threads, one a column.
extern "C" int cbt_ed25519_verify_cached_thread(const int32_t* rows, int B,
                                                const int32_t* tab, int M,
                                                const uint8_t* ok,
                                                const int32_t* base,
                                                int32_t* out, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  ed25519_verify_cached_thread_kernel<<<blocks, kThreads, 0,
                                        (cudaStream_t)stream>>>(
      rows, B, reinterpret_cast<const cbt::ge_niels*>(tab), M, ok,
      reinterpret_cast<const cbt::ge_niels*>(base), out);
  return (int)cudaGetLastError();
}
