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
// Design: ed25519_verify's quad of four threads per signature
// (csrc/sr25519_quad.cuh over csrc/ed25519_quad.cuh). Lane k holds
// coordinate k of every point and component k of every table entry, so
// each addition and doubling of the shared double-scalar multiplication
// (q_sb_minus_ha: the table [d](-A), the Horner loop over the challenge's
// nibbles, the 32-window comb of [s]B as integer gathers) is two field
// multiplications a lane, operands moving inside the quad by __shfl_sync.
// The ristretto decodes of A and R (power chains that cannot be split)
// run first, one point a thread on the block's first warp, through the
// out-of-line field ops, and reach the quads as x and y through shared
// memory, which keeps their registers out of the quad program's. The
// finish is the ristretto equality with R (four products, one a lane, and
// two exchanges); there is no -R entry and no cofactor doubling. The
// per-signature table (16 cached points, 640 B a lane) lives in shared
// memory. 64 threads a block (16 signatures, 43,648 B of shared memory),
// five blocks an SM. A warp runs the quad program only if one of its
// quads is live (precheck passed, A and R decoded), all 32 threads in
// step; other quads' verdicts are masked to 0, as are padding columns'.
// The merlin challenge is computed on the host.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sr25519_quad.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kSigs = kThreads / 4;
// five blocks (ten warps) an SM: at most 168 registers a thread, since a
// scheduler's 16,384 registers must hold three of them
constexpr int kBlocksPerSm = 5;
// a decoded point's words: x limbs, y limbs, then ok
constexpr int kDecX = 0, kDecY = 10, kDecOk = 20, kDecWords = 21;

// ten shared-memory words as a field element, read where it is used
__device__ __forceinline__ const cbt::fe& as_fe(const int32_t* w) {
  return *reinterpret_cast<const cbt::fe*>(w);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sr25519_verify_kernel(const int32_t* __restrict__ rows, int B,
                      const cbt::ge_niels* __restrict__ base,
                      int32_t* __restrict__ out) {
  __shared__ int32_t tab[cbt_quad::kMulEntries * 10 * kThreads];
  __shared__ int32_t dec[2 * kSigs][kDecWords];  // A and R of each column
  const int tid = threadIdx.x;
  const int sig0 = blockIdx.x * kSigs;
  if (tid < 2 * kSigs) {  // the first warp decodes the block's 32 points
    const int col = sig0 + (tid >> 1);
    cbt::fe x = cbt::fe_zero(), y = cbt::fe_zero();
    const int ok = col < B ? cbt_quad::decode_point_sr(rows, B, col,
                                                       tid & 1, &x, &y)
                           : 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
      dec[tid][kDecX + i] = x.v[i];
      dec[tid][kDecY + i] = y.v[i];
    }
    dec[tid][kDecOk] = ok;
  }
  __syncthreads();
  const int q = tid >> 2, col = sig0 + q;
  const bool live = col < B && dec[2 * q][kDecOk] && dec[2 * q + 1][kDecOk];
  const bool writer = (tid & 3) == 0 && col < B;
  if (!__any_sync(0xffffffffu, live)) {  // the whole warp is dead
    if (writer) out[col] = 0;
    return;
  }
  // x and y stay in shared memory until the program reads them, so R's
  // hold no registers through the multiplication
  const int32_t* a = dec[2 * q];
  const int32_t* r = dec[2 * q + 1];
  cbt_quad::QTab<1> lanes{tab + tid, kThreads};
  const int v = cbt_quad::quad_verdict_sr<1>(
      rows, B, col < B ? col : B - 1, base, lanes, as_fe(a + kDecX),
      as_fe(a + kDecY), as_fe(r + kDecX), as_fe(r + kDecY));
  if (writer) out[col] = live ? v : 0;
}

}  // namespace

// rows: (>= C_KROWS, B) int32, row-major; base: (8192, 3, 10) int32 niels
// table; out: (B,) int32 verdicts. Launches 4 B threads on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
extern "C" int cbt_sr25519_verify(const int32_t* rows, int B,
                                  const int32_t* base, int32_t* out,
                                  void* stream) {
  if (B <= 0) return 0;
  const long long threads = 4LL * B;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  sr25519_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, B, reinterpret_cast<const cbt::ge_niels*>(base), out);
  return (int)cudaGetLastError();
}
