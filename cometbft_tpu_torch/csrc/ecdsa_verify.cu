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
// Design: a quad of four threads per signature (csrc/secp256k1_quad.cuh),
// as ed25519_verify and sr25519_verify. Lane k holds coordinate k of every
// point, so each Renes-Costello-Batina complete addition (12 products) is
// three rounds of one field multiplication a lane and each doubling two,
// operands moving inside the quad by __shfl_sync; the serial chain of one
// signature drops from ~3,300 field operations on one thread to ~830
// multiply rounds. The field is secp256k1_core.cuh's (ten signed 26-bit
// limbs in int32, products in int64 columns). The decompression of Q (a
// 253-squaring square-root chain that cannot be split) runs first, one
// key a thread on the block's first warp, through the out-of-line field
// ops, and reaches the quads as x and y through shared memory, which keeps
// its registers out of the quad program's. The comb of [u1]G is an integer
// gather from a device-resident table of projective entries; the table
// [d]Q (16 addends, 640 B a lane) lives in shared memory. 64 threads a
// block (16 signatures, 42,304 B of shared memory), five blocks an SM. A
// warp runs the quad program only if one of its quads is live (precheck
// passed, Q decoded), all 32 threads in step; other quads' verdicts are
// masked to 0, as are padding columns'. Measured, one warp of the quad
// program already fills its scheduler's issue, so the time follows the
// warps the busiest scheduler holds (two for the light call's 6,667
// signatures, one for 3,334).
#include <cuda_runtime.h>
#include <stdint.h>

#include "secp256k1_quad.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kSigs = kThreads / 4;
// five blocks (ten warps) an SM: at most 168 registers a thread, since a
// scheduler's 16,384 registers must hold three of them
constexpr int kBlocksPerSm = 5;
// a decoded key's words: x limbs, y limbs, then ok
constexpr int kDecX = 0, kDecY = 10, kDecOk = 20, kDecWords = 21;

// ten shared-memory words as a field element, read where it is used
__device__ __forceinline__ const cbt_secp::fe& as_fe(const int32_t* w) {
  return *reinterpret_cast<const cbt_secp::fe*>(w);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ecdsa_verify_kernel(const int32_t* __restrict__ rows, int B,
                    const cbt_secp::gpt* __restrict__ base,
                    int32_t* __restrict__ out) {
  __shared__ int32_t tab[cbt_secp_quad::kEntries * 10 * kThreads];
  __shared__ int32_t dec[kSigs][kDecWords];  // Q of each column
  const int tid = threadIdx.x;
  const int sig0 = blockIdx.x * kSigs;
  if (tid < kSigs) {  // the first warp decodes the block's 16 keys
    const int col = sig0 + tid;
    cbt_secp::fe x = cbt_secp::fe_small(0), y = cbt_secp::fe_small(0);
    const int ok = col < B ? cbt_secp::decode_q(rows, B, col, &x, &y) : 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
      dec[tid][kDecX + i] = x.v[i];
      dec[tid][kDecY + i] = y.v[i];
    }
    dec[tid][kDecOk] = ok;
  }
  __syncthreads();
  const int q = tid >> 2, col = sig0 + q;
  const bool live = col < B && dec[q][kDecOk];
  const bool writer = (tid & 3) == 0 && col < B;
  if (!__any_sync(0xffffffffu, live)) {  // the whole warp is dead
    if (writer) out[col] = 0;
    return;
  }
  cbt_secp_quad::QTab<1> lanes{tab + tid, kThreads};
  const int v = cbt_secp_quad::quad_verdict_ecdsa<1>(
      rows, B, col < B ? col : B - 1, base, lanes, as_fe(dec[q] + kDecX),
      as_fe(dec[q] + kDecY));
  if (writer) out[col] = live ? v : 0;
}

}  // namespace

// rows: (>= E_KROWS, B) int32, row-major; base: (8192, 3, 10) int32 comb
// table; out: (B,) int32 verdicts. Launches 4 B threads on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
extern "C" int cbt_ecdsa_verify(const int32_t* rows, int B,
                                const int32_t* base, int32_t* out,
                                void* stream) {
  if (B <= 0) return 0;
  const long long threads = 4LL * B;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  ecdsa_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, B, reinterpret_cast<const cbt_secp::gpt*>(base), out);
  return (int)cudaGetLastError();
}
