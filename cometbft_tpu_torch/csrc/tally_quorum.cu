// tally_quorum: per-commit voting-power tally and quorum bit on Hopper.
//
// Replaces: cometbft_tpu/ops/ed25519_kernel.py `tally_core` + `quorum_core`
// (XLA, run after the Pallas verify in `ed25519_pallas._verify_tally_rows`,
// and, for the cached layout, in `ed25519_cached._verify_tally_cached`).
//
// Two entries share the reduction:
//   cbt_tally_quorum         general packed rows: power from rows C_POW..,
//                            counted from C_FLAGS bit 3, commit id row C_CID;
//   cbt_tally_quorum_cached  cached packed rows: power from the valset's
//                            power5[b mod M], counted from V_FLAGS bit 2,
//                            commit id V_FLAGS >> 3.
//
// What bounds it on an H100: bytes. It reads one verdict and a few packed
// words per column and does a handful of integer adds with them; the work is
// microseconds next to the verify kernels.
//
// Design: one block per commit. The block's threads stride over the B
// columns and sum the 13-bit power limbs of the columns that are valid,
// counted and carry this commit's id; a shared-memory tree then reduces the
// per-thread sums. The order is fixed and there are no atomics, so the
// result is bit-exact. Per-limb sums stay below 2^30 for B <= 2^17 (limbs
// < 2^13), so int32 is enough. Thread 0 carries the limbs to canonical
// 13-bit form and compares them with the threshold, top limb down.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPowerLimbs = 5;
constexpr int kTallyLimbs = 6;
constexpr int kC_FLAGS = 36, kC_POW = 37, kC_CID = 40, kC_THRESH = 41;
constexpr int kV_FLAGS = 26, kV_THRESH = 27;
constexpr uint32_t kM13 = (1u << 13) - 1;

// Reduces each thread's acc over the block, then thread 0 writes commit c's
// canonical tally and quorum bit (tally > thresh).
__device__ void reduce_and_finish(int32_t (&acc)[kPowerLimbs],
                                  const int32_t* thresh, int c,
                                  int32_t* tally, uint8_t* quorum) {
  __shared__ int32_t part[kPowerLimbs][kThreads];
#pragma unroll
  for (int k = 0; k < kPowerLimbs; k++) part[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int k = 0; k < kPowerLimbs; k++)
        part[k][threadIdx.x] += part[k][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  int32_t t[kTallyLimbs];
#pragma unroll
  for (int k = 0; k < kPowerLimbs; k++) t[k] = part[k][0];
  t[kPowerLimbs] = 0;
#pragma unroll
  for (int i = 0; i < kTallyLimbs - 1; i++) {
    const int32_t carry = t[i] >> 13;
    t[i] -= carry << 13;
    t[i + 1] += carry;
  }
  bool gt = false, eq = true;
#pragma unroll
  for (int i = kTallyLimbs - 1; i >= 0; i--) {
    gt = gt || (eq && t[i] > thresh[i]);
    eq = eq && t[i] == thresh[i];
  }
#pragma unroll
  for (int i = 0; i < kTallyLimbs; i++) tally[c * kTallyLimbs + i] = t[i];
  quorum[c] = gt ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
tally_quorum_kernel(const int32_t* __restrict__ valid,
                    const int32_t* __restrict__ rows, int B,
                    int32_t* __restrict__ tally, uint8_t* __restrict__ quorum) {
  const int c = blockIdx.x;
  int32_t acc[kPowerLimbs] = {0, 0, 0, 0, 0};
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const uint32_t flags = (uint32_t)rows[kC_FLAGS * B + b];
    if (valid[b] != 0 && ((flags >> 3) & 1u) && rows[kC_CID * B + b] == c) {
      const uint32_t p01 = (uint32_t)rows[kC_POW * B + b];
      const uint32_t p23 = (uint32_t)rows[(kC_POW + 1) * B + b];
      acc[0] += (int32_t)(p01 & kM13);
      acc[1] += (int32_t)((p01 >> 13) & kM13);
      acc[2] += (int32_t)(p23 & kM13);
      acc[3] += (int32_t)((p23 >> 13) & kM13);
      acc[4] += rows[(kC_POW + 2) * B + b];
    }
  }
  // thresholds: rows[C_THRESH:] read flat, (n_commits, 6) limbs
  reduce_and_finish(acc, rows + (size_t)kC_THRESH * B + (size_t)c * kTallyLimbs,
                    c, tally, quorum);
}

__global__ void __launch_bounds__(kThreads)
tally_quorum_cached_kernel(const int32_t* __restrict__ valid,
                           const int32_t* __restrict__ rows, int B,
                           const int32_t* __restrict__ power5, int M,
                           int32_t* __restrict__ tally,
                           uint8_t* __restrict__ quorum) {
  const int c = blockIdx.x;
  int32_t acc[kPowerLimbs] = {0, 0, 0, 0, 0};
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const int32_t flags = rows[kV_FLAGS * B + b];
    if (valid[b] != 0 && ((flags >> 2) & 1) && (flags >> 3) == c) {
      const int32_t* p = power5 + (size_t)(b % M) * kPowerLimbs;
#pragma unroll
      for (int k = 0; k < kPowerLimbs; k++) acc[k] += p[k];
    }
  }
  // thresholds: rows[V_THRESH:] read flat, (n_commits, 6) limbs
  reduce_and_finish(acc, rows + (size_t)kV_THRESH * B + (size_t)c * kTallyLimbs,
                    c, tally, quorum);
}

}  // namespace

// valid: (B,) int32 verdicts; rows: the packed (R, B) int32 array;
// tally: (n_commits, 6) int32; quorum: (n_commits,) bool (one byte each).
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int cbt_tally_quorum(const int32_t* valid, const int32_t* rows,
                                int B, int n_commits, int32_t* tally,
                                uint8_t* quorum, void* stream) {
  if (n_commits <= 0) return 0;
  tally_quorum_kernel<<<n_commits, kThreads, 0, (cudaStream_t)stream>>>(
      valid, rows, B, tally, quorum);
  return (int)cudaGetLastError();
}

// The cached layout: as above, with power5 the valset's (M, 5) int32 power
// limbs (column b is validator b mod M).
extern "C" int cbt_tally_quorum_cached(const int32_t* valid,
                                       const int32_t* rows, int B,
                                       const int32_t* power5, int M,
                                       int n_commits, int32_t* tally,
                                       uint8_t* quorum, void* stream) {
  if (n_commits <= 0) return 0;
  tally_quorum_cached_kernel<<<n_commits, kThreads, 0,
                               (cudaStream_t)stream>>>(
      valid, rows, B, power5, M, tally, quorum);
  return (int)cudaGetLastError();
}
