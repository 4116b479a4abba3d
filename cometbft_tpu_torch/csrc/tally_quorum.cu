// tally_quorum: per-commit voting-power tally and quorum bit on Hopper.
//
// Replaces: cometbft_tpu/ops/ed25519_kernel.py `tally_core` + `quorum_core`
// (XLA, run after the Pallas verify in `ed25519_pallas._verify_tally_rows`).
//
// What bounds it on an H100: bytes. It reads one verdict and five packed
// words per column (24 B) and does a handful of integer adds with them;
// the work is a few microseconds next to the verify kernel.
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
constexpr uint32_t kM13 = (1u << 13) - 1;

__global__ void __launch_bounds__(kThreads)
tally_quorum_kernel(const int32_t* __restrict__ valid,
                    const int32_t* __restrict__ rows, int B,
                    int32_t* __restrict__ tally, uint8_t* __restrict__ quorum) {
  const int c = blockIdx.x;
  __shared__ int32_t part[kPowerLimbs][kThreads];
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
  // thresholds: rows[C_THRESH:] read flat, (n_commits, 6) limbs
  const int32_t* thresh = rows + (size_t)kC_THRESH * B + (size_t)c * kTallyLimbs;
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
