// tally_quorum: per-commit voting-power tally and quorum bit on Hopper.
//
// Replaces: cometbft_tpu/ops/ed25519_kernel.py `tally_core` + `quorum_core`
// (XLA, run after the Pallas verify in `ed25519_pallas._verify_tally_rows`,
// and, for the cached layout, in `ed25519_cached._verify_tally_cached`).
//
// Two entries share one templated kernel; only the column source differs
// (csrc/tally_core.cuh):
//   cbt_tally_quorum         general packed rows: power from rows C_POW..,
//                            counted from C_FLAGS bit 3, commit id row C_CID;
//   cbt_tally_quorum_cached  cached packed rows: power from the valset's
//                            power5[b mod M], counted from V_FLAGS bit 2,
//                            commit id V_FLAGS >> 3.
// A third, cbt_carry_quorum, is the mesh's reduce (see its entry below).
//
// What bounds it on an H100: bytes, 24 B a column (general) or 8 B plus a
// gathered 20 B power entry (cached), and at the main paths' sizes (B =
// 16,384 and 65,536) that is well under a microsecond; what is left is one
// launch and one round trip of loads.
//
// Design: each column is read once, by a grid sized by B. Thread t of block
// k takes columns k * 512 + 4t .. + 3 with one 16-byte load a row (where B
// % 4 == 0), every load issued before the first is used, and sums its live
// columns into runs of one commit id. A warp whose lanes all hold the same
// commit sums each limb with __reduce_add_sync; then lane 0 adds it to the
// block's partials per (commit, limb) in shared memory (up to 256 commits;
// above that, straight into the global sums). Each block adds its non-zero
// partials into a (C, 5) int32 scratch with integer atomics, fences, and
// counts itself done; the last block carries every commit's sums to
// canonical 13-bit limbs and compares them with the threshold, top limb
// down. Integer addition is exact in any order, so the atomics give the
// same result every run; per-limb sums stay below 2^30 for B <= 2^17.
// Precondition, not checked here: power limbs < 2^13, as the host makes
// them (ops/ed25519_kernel.py power_limbs, check_power_limbs). Sums of
// larger limbs wrap modulo 2^32, as the JAX int32 sum does. One memset of
// the scratch and one launch a call; the scratch belongs to the call, so
// calls on two streams share nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tally_core.cuh"

namespace {

using namespace cbt_tally;

template <typename Src, bool kSmem>
__global__ void __launch_bounds__(kThreads)
tally_kernel(Src s, int B, int C, bool vec, int32_t* __restrict__ sums,
             unsigned* __restrict__ done, int32_t* __restrict__ tally,
             uint8_t* __restrict__ quorum) {
  extern __shared__ int32_t smem[];
  __shared__ bool last;
  Col c[kColsPerThread];
  thread_load(s, B, blockIdx.x, threadIdx.x, vec, c);
  int32_t* part = kSmem ? smem : sums;
  if (kSmem) {
    for (int i = threadIdx.x; i < C * kPowerLimbs; i += kThreads) smem[i] = 0;
    __syncthreads();
  }
  int32_t cid, acc[kPowerLimbs];
  thread_runs(c, C, part, cid, acc);
  warp_combine(cid, acc, part);
  if (kSmem) {
    __syncthreads();
    for (int i = threadIdx.x; i < C * kPowerLimbs; i += kThreads) {
      const int32_t v = smem[i];
      if (v != 0) atomicAdd(sums + i, v);
    }
  }
  // the block's adds are visible before it counts itself done
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int32_t* th = s.thresh();
  for (int k = threadIdx.x; k < C; k += kThreads) {
    int32_t sum[kPowerLimbs];
#pragma unroll
    for (int i = 0; i < kPowerLimbs; i++)
      sum[i] = __ldcg(sums + (size_t)k * kPowerLimbs + i);
    finish_commit(sum, th + (size_t)k * kTallyLimbs,
                  tally + (size_t)k * kTallyLimbs, quorum + k);
  }
}

template <typename Src>
int launch(const Src& s, int B, int C, bool vec, int32_t* scratch,
           int32_t* tally, uint8_t* quorum, cudaStream_t st) {
  if (C <= 0) return 0;
  // scratch: C * 5 sums, then the done counter
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, ((size_t)C * kPowerLimbs + 1) * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  unsigned* done = reinterpret_cast<unsigned*>(scratch +
                                               (size_t)C * kPowerLimbs);
  const int blocks = grid_blocks(B);
  if (smem_partials(C)) {
    tally_kernel<Src, true>
        <<<blocks, kThreads, C * kPowerLimbs * sizeof(int32_t), st>>>(
            s, B, C, vec, scratch, done, tally, quorum);
  } else {
    tally_kernel<Src, false><<<blocks, kThreads, 0, st>>>(
        s, B, C, vec, scratch, done, tally, quorum);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// valid: (B,) int32 verdicts; rows: the packed (R, B) int32 array;
// scratch: (n_commits * 5 + 1) int32, any contents; tally: (n_commits, 6)
// int32; quorum: (n_commits,) bool (one byte each). Zeroes the scratch and
// launches on `stream`, allocates nothing, does not synchronise; returns
// the first CUDA error.
extern "C" int cbt_tally_quorum(const int32_t* valid, const int32_t* rows,
                                int B, int n_commits, int32_t* scratch,
                                int32_t* tally, uint8_t* quorum,
                                void* stream) {
  return launch(GeneralSrc{valid, rows, B}, B, n_commits,
                vector_loads(valid, rows, B), scratch, tally, quorum,
                (cudaStream_t)stream);
}

// The cached layout: as above, with power5 the valset's (M, 5) int32 power
// limbs (column b is validator b mod M).
extern "C" int cbt_tally_quorum_cached(const int32_t* valid,
                                       const int32_t* rows, int B,
                                       const int32_t* power5, int M,
                                       int n_commits, int32_t* scratch,
                                       int32_t* tally, uint8_t* quorum,
                                       void* stream) {
  return launch(CachedSrc{valid, rows, B, power5, M}, B, n_commits,
                vector_loads(valid, rows, B), scratch, tally, quorum,
                (cudaStream_t)stream);
}

// cbt_carry_quorum: the cross-slot reduce of a sharded step
// (parallel/mesh.py), after each slot's tally kernel has written its
// partial (C, 6) tally.
//
// Replaces: cometbft_tpu/parallel/mesh.py `jax.lax.psum` of the per-device
// tallies + `_carry_tally` (:123) + `ed25519_kernel.quorum_core` (XLA,
// after every shard_map builder's local tally).
//
// What bounds it on an H100: bytes, n_dev * C * 24 B of partials in, C *
// 25 B out; at the plane's sizes (3 slots, a few commits) that is some
// hundred bytes, so one launch is all its time. Design: one thread a
// commit sums its limbs over the slots, carries and compares
// (tally_core.cuh `carry_quorum_commit`); no scratch, no atomics.
namespace {

__global__ void __launch_bounds__(cbt_tally::kThreads)
carry_quorum_kernel(const int32_t* __restrict__ parts, int n_dev, int C,
                    const int32_t* __restrict__ thresh,
                    int32_t* __restrict__ tally,
                    uint8_t* __restrict__ quorum) {
  const int k = blockIdx.x * cbt_tally::kThreads + threadIdx.x;
  if (k < C)
    cbt_tally::carry_quorum_commit(parts, n_dev, C, k, thresh, tally, quorum);
}

}  // namespace

// parts: (n_dev, n_commits, 6) int32 partial tallies; thresh: (n_commits,
// 6) int32; tally: (n_commits, 6) int32; quorum: (n_commits,) bool (one
// byte each). Launches on `stream`, allocates nothing, does not
// synchronise; returns the first CUDA error.
extern "C" int cbt_carry_quorum(const int32_t* parts, int n_dev,
                                int n_commits, const int32_t* thresh,
                                int32_t* tally, uint8_t* quorum,
                                void* stream) {
  if (n_commits <= 0) return 0;
  const int blocks =
      (n_commits + cbt_tally::kThreads - 1) / cbt_tally::kThreads;
  carry_quorum_kernel<<<blocks, cbt_tally::kThreads, 0, (cudaStream_t)stream>>>(
      parts, n_dev, n_commits, thresh, tally, quorum);
  return (int)cudaGetLastError();
}
