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
// Design: a quad of four threads per signature (csrc/ed25519_quad.cuh).
// Lane k holds coordinate k of every point and component k of every table
// entry, so each point addition and doubling is two field multiplications
// a lane instead of eight on one thread, and a signature's serial chain is
// about a third of one thread's. The table [d](-A), the Horner loop over h
// and the 32-window comb of [s]B (an integer gather of each lane's niels
// component, so no float rounding touches the limbs) run as four-way
// additions and doublings, operands moving inside the quad by __shfl_sync;
// the field ops are inline. A's and R's decompressions (square-root chains
// that cannot be split) run first, one point a thread on the block's first
// warp, through the out-of-line field ops, and reach the quads through
// shared memory: that halves their issue slots against two lanes of every
// quad, and keeps their registers out of the quad program's (168, so an SM
// holds ten warps). The per-signature table (17 cached points, 680 B a
// lane) lives in shared memory. 64 threads a block (16 signatures, 44.9 KB
// of shared memory), five blocks an SM, so a 10,000-signature batch is one
// wave over the 132 SMs. A warp runs the quad program only if one of its
// quads is live (precheck passed, A and R decoded), all 32 threads in
// step; other quads' verdicts are masked to 0, as are padding columns'.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_quad.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kSigs = kThreads / 4;
// five blocks (ten warps) an SM: at most 168 registers a thread, since a
// scheduler's 16,384 registers must hold three of them
constexpr int kBlocksPerSm = 5;

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ed25519_verify_kernel(const int32_t* __restrict__ rows, int B,
                      const cbt::ge_niels* __restrict__ base,
                      int32_t* __restrict__ out) {
  __shared__ int32_t tab[cbt_quad::kTabEntries * 10 * kThreads];
  __shared__ int32_t dec[2 * kSigs][11];  // x limbs, then ok, of A and R
  const int tid = threadIdx.x;
  const int sig0 = blockIdx.x * kSigs;
  if (tid < 2 * kSigs) {  // the first warp decodes the block's 32 points
    const int col = sig0 + (tid >> 1);
    cbt::fe x = cbt::fe_zero();
    const int ok =
        col < B ? cbt_quad::decode_point(rows, B, col, tid & 1, &x) : 0;
#pragma unroll
    for (int i = 0; i < 10; i++) dec[tid][i] = x.v[i];
    dec[tid][10] = ok;
  }
  __syncthreads();
  const int q = tid >> 2, col = sig0 + q;
  const bool live = col < B && dec[2 * q][10] && dec[2 * q + 1][10];
  const bool writer = (tid & 3) == 0 && col < B;
  if (!__any_sync(0xffffffffu, live)) {  // the whole warp is dead
    if (writer) out[col] = 0;
    return;
  }
  cbt::fe xA, xR;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    xA.v[i] = dec[2 * q][i];
    xR.v[i] = dec[2 * q + 1][i];
  }
  cbt_quad::QTab<1> lanes{tab + tid, kThreads};
  const int v = cbt_quad::quad_verdict<1>(rows, B, col < B ? col : B - 1,
                                          base, lanes, xA, xR);
  if (writer) out[col] = live ? v : 0;
}

}  // namespace

// rows: (>= C_KROWS, B) int32, row-major; base: (8192, 3, 10) int32 niels
// table; out: (B,) int32 verdicts. Launches 4 B threads on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
extern "C" int cbt_ed25519_verify(const int32_t* rows, int B,
                                  const int32_t* base, int32_t* out,
                                  void* stream) {
  if (B <= 0) return 0;
  const long long threads = 4LL * B;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  ed25519_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, B, reinterpret_cast<const cbt::ge_niels*>(base), out);
  return (int)cudaGetLastError();
}
