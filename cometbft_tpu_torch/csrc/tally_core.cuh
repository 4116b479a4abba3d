// The voting-power tally of csrc/tally_quorum.cu, in functions that build
// for the card and for the host: loading a thread's columns, summing them
// into runs of one commit id, the warp's combine, and the finish (carry to
// canonical 13-bit limbs, strict compare with the threshold); and the
// cross-slot reduce of a mesh's partial tallies (`carry_quorum_commit`).
// The kernels call them; the host build (ed25519_host.cpp
// `cbt_host_tally`, `cbt_host_carry_quorum`) runs the kernels' own block
// and thread partition with them one step at a time, so the CPU tests
// check the partition, the shared-memory cap and the branch taken above
// it, and the reduce's limb arithmetic.
//
// Every sum is of int32 limbs below 2^13 over at most 2^17 columns, so it
// stays below 2^30: integer addition is exact in any order, and the
// atomics that combine warps and blocks give the same result every run.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define CBT_TALLY_HD __host__ __device__ __forceinline__
#else
#define CBT_TALLY_HD inline
#endif

namespace cbt_tally {

constexpr int kThreads = 128;        // threads a block (four warps)
constexpr int kWarp = 32;
constexpr int kColsPerThread = 4;    // one 16-byte load a row
constexpr int kColsPerBlock = kThreads * kColsPerThread;
// Block partials per (commit, limb) live in shared memory up to this many
// commits (5 KB); above it, warps add straight into the global sums.
constexpr int kMaxSmemCommits = 256;
constexpr int kPowerLimbs = 5;
constexpr int kTallyLimbs = 6;
// packed-row layouts (ops/ed25519_fused.py C_*, ops/ed25519_cached.py V_*)
constexpr int kC_FLAGS = 36, kC_POW = 37, kC_CID = 40, kC_THRESH = 41;
constexpr int kV_FLAGS = 26, kV_THRESH = 27;
constexpr uint32_t kM13 = (1u << 13) - 1;

CBT_TALLY_HD int grid_blocks(int B) {
  const int g = (B + kColsPerBlock - 1) / kColsPerBlock;
  return g > 0 ? g : 1;  // one block still finishes every commit
}

CBT_TALLY_HD bool smem_partials(int n_commits) {
  return n_commits <= kMaxSmemCommits;
}

// 16-byte loads need B % 4 == 0 and 16-byte aligned bases.
CBT_TALLY_HD bool vector_loads(const void* a, const void* b, int B) {
  return B % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
}

// One column: the commit it counts for (-1: none) and its power limbs.
struct Col {
  int32_t cid;
  int32_t p[kPowerLimbs];
};

// The n <= 4 words at p, as one 16-byte load when `vec`.
CBT_TALLY_HD void load4(const int32_t* p, int n, bool vec, int32_t out[4]) {
#if defined(__CUDA_ARCH__)
  if (vec) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
    return;
  }
#endif
  (void)vec;
#pragma unroll
  for (int j = 0; j < kColsPerThread; j++) out[j] = j < n ? p[j] : 0;
}

// General packed rows: power from rows C_POW..C_POW+2, counted from C_FLAGS
// bit 3, commit id from row C_CID.
struct GeneralSrc {
  const int32_t* valid;
  const int32_t* rows;
  int B;

  CBT_TALLY_HD const int32_t* thresh() const {
    return rows + (size_t)kC_THRESH * B;
  }
  // every load is issued before any is used
  CBT_TALLY_HD void load(int b0, int n, bool vec, Col c[kColsPerThread]) const {
    int32_t v[4], f[4], id[4], p01[4], p23[4], p4[4];
    load4(valid + b0, n, vec, v);
    load4(rows + (size_t)kC_FLAGS * B + b0, n, vec, f);
    load4(rows + (size_t)kC_CID * B + b0, n, vec, id);
    load4(rows + (size_t)kC_POW * B + b0, n, vec, p01);
    load4(rows + (size_t)(kC_POW + 1) * B + b0, n, vec, p23);
    load4(rows + (size_t)(kC_POW + 2) * B + b0, n, vec, p4);
#pragma unroll
    for (int j = 0; j < kColsPerThread; j++) {
      const bool live = j < n && v[j] != 0 && (((uint32_t)f[j] >> 3) & 1u);
      c[j].cid = live ? id[j] : -1;
      c[j].p[0] = (int32_t)((uint32_t)p01[j] & kM13);
      c[j].p[1] = (int32_t)(((uint32_t)p01[j] >> 13) & kM13);
      c[j].p[2] = (int32_t)((uint32_t)p23[j] & kM13);
      c[j].p[3] = (int32_t)(((uint32_t)p23[j] >> 13) & kM13);
      c[j].p[4] = p4[j];
    }
  }
};

// Cached packed rows: power from the valset's power5[b mod M], counted from
// V_FLAGS bit 2, commit id V_FLAGS >> 3.
struct CachedSrc {
  const int32_t* valid;
  const int32_t* rows;
  int B;
  const int32_t* power5;
  int M;

  CBT_TALLY_HD const int32_t* thresh() const {
    return rows + (size_t)kV_THRESH * B;
  }
  CBT_TALLY_HD void load(int b0, int n, bool vec, Col c[kColsPerThread]) const {
    int32_t v[4], f[4];
    load4(valid + b0, n, vec, v);
    load4(rows + (size_t)kV_FLAGS * B + b0, n, vec, f);
#pragma unroll
    for (int j = 0; j < kColsPerThread; j++) {
      const int32_t* p = power5 + (size_t)((b0 + j) % M) * kPowerLimbs;
#pragma unroll
      for (int k = 0; k < kPowerLimbs; k++) c[j].p[k] = j < n ? p[k] : 0;
    }
#pragma unroll
    for (int j = 0; j < kColsPerThread; j++) {
      const bool live = j < n && v[j] != 0 && ((f[j] >> 2) & 1);
      c[j].cid = live ? (f[j] >> 3) : -1;
    }
  }
};

// Adds v to *p: an integer atomic on the card, a plain add on the host
// (both wrap modulo 2^32).
CBT_TALLY_HD void add_to(int32_t* p, int32_t v) {
#if defined(__CUDA_ARCH__)
  atomicAdd(p, v);
#else
  *p = (int32_t)((uint32_t)*p + (uint32_t)v);
#endif
}

CBT_TALLY_HD void add_run(int32_t* part, int32_t cid,
                          const int32_t acc[kPowerLimbs]) {
#pragma unroll
  for (int k = 0; k < kPowerLimbs; k++)
    add_to(part + (size_t)cid * kPowerLimbs + k, acc[k]);
}

// Thread t of block blk loads its columns blk * kColsPerBlock + t * 4 ..
// + 3 (neighbouring threads, neighbouring 16-byte words of each row).
template <typename Src>
CBT_TALLY_HD void thread_load(const Src& s, int B, int blk, int t, bool vec,
                              Col c[kColsPerThread]) {
  const int b0 = blk * kColsPerBlock + t * kColsPerThread;
  const int left = B - b0;
  const int n = left < kColsPerThread ? (left > 0 ? left : 0) : kColsPerThread;
  if (n > 0) {
    s.load(b0, n, vec && n == kColsPerThread, c);
  } else {
#pragma unroll
    for (int j = 0; j < kColsPerThread; j++) c[j].cid = -1;
  }
}

// Sums the thread's live columns with 0 <= cid < C into runs of one commit
// id (dead columns do not break a run). Every run but the last is added to
// part at once; the last is left in (cid, acc) for the warp's combine
// (cid -1: none).
CBT_TALLY_HD void thread_runs(const Col c[kColsPerThread], int C,
                              int32_t* part, int32_t& cid,
                              int32_t acc[kPowerLimbs]) {
  cid = -1;
#pragma unroll
  for (int k = 0; k < kPowerLimbs; k++) acc[k] = 0;
#pragma unroll
  for (int j = 0; j < kColsPerThread; j++) {
    const int32_t id = c[j].cid;
    if (id < 0 || id >= C) continue;  // the one-hot of tally_core drops it
    if (id != cid) {
      if (cid >= 0) add_run(part, cid, acc);
      cid = id;
#pragma unroll
      for (int k = 0; k < kPowerLimbs; k++) acc[k] = c[j].p[k];
    } else {
#pragma unroll
      for (int k = 0; k < kPowerLimbs; k++)  // wraps, as add_to does
        acc[k] = (int32_t)((uint32_t)acc[k] + (uint32_t)c[j].p[k]);
    }
  }
}

#if defined(__CUDACC__)
// The warp's combine: when every lane's open run has the same commit (or
// none), the warp sums each limb and lane 0 adds it once; otherwise each
// lane adds its own run. All 32 lanes must call it.
__device__ __forceinline__ void warp_combine(int32_t cid,
                                             const int32_t acc[kPowerLimbs],
                                             int32_t* part) {
  const unsigned full = 0xffffffffu;
  const int32_t top = __reduce_max_sync(full, cid);
  if (__all_sync(full, cid < 0 || cid == top)) {
    if (top < 0) return;
#pragma unroll
    for (int k = 0; k < kPowerLimbs; k++) {
      const int32_t s = (int32_t)__reduce_add_sync(full, (unsigned)acc[k]);
      if ((threadIdx.x & (kWarp - 1)) == 0)
        atomicAdd(part + (size_t)top * kPowerLimbs + k, s);
    }
  } else if (cid >= 0) {
    add_run(part, cid, acc);
  }
}
#else
// The same combine over the 32 lanes' open runs, one lane at a time.
static inline void warp_combine_host(const int32_t cid[kWarp],
                                     const int32_t acc[kWarp][kPowerLimbs],
                                     int32_t* part) {
  int32_t top = -1;
  for (int l = 0; l < kWarp; l++) top = cid[l] > top ? cid[l] : top;
  bool uniform = true;
  for (int l = 0; l < kWarp; l++) uniform &= cid[l] < 0 || cid[l] == top;
  if (uniform) {
    if (top < 0) return;
    for (int k = 0; k < kPowerLimbs; k++) {
      uint32_t s = 0;
      for (int l = 0; l < kWarp; l++) s += (uint32_t)acc[l][k];
      add_to(part + (size_t)top * kPowerLimbs + k, (int32_t)s);
    }
  } else {
    for (int l = 0; l < kWarp; l++)
      if (cid[l] >= 0) add_run(part, cid[l], acc[l]);
  }
}
#endif

// Carries six limb sums to canonical 13-bit limbs (each limb's carry into
// the next; the top limb keeps the rest), then tally > threshold compared
// from the top limb down.
CBT_TALLY_HD void carry_compare(int32_t t[kTallyLimbs], const int32_t* thresh,
                                int32_t* tally, uint8_t* quorum) {
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
  for (int i = 0; i < kTallyLimbs; i++) tally[i] = t[i];
  *quorum = gt ? 1 : 0;
}

// Commit c's finish: the five limb sums, carried and compared.
CBT_TALLY_HD void finish_commit(const int32_t sum[kPowerLimbs],
                                const int32_t* thresh, int32_t* tally,
                                uint8_t* quorum) {
  int32_t t[kTallyLimbs];
#pragma unroll
  for (int k = 0; k < kPowerLimbs; k++) t[k] = sum[k];
  t[kPowerLimbs] = 0;
  carry_compare(t, thresh, tally, quorum);
}

// The cross-slot reduce of cbt_carry_quorum for commit k: parts is the
// (n_dev, C, 6) partial tallies of the mesh's slots (canonical, so each
// limb's sum stays below n_dev * 2^13 + the top limbs'), summed limb by
// limb, then carried and compared with thresh's row k. Sums wrap modulo
// 2^32, as the JAX psum's int32 sum does.
CBT_TALLY_HD void carry_quorum_commit(const int32_t* parts, int n_dev, int C,
                                      int k, const int32_t* thresh,
                                      int32_t* tally, uint8_t* quorum) {
  uint32_t s[kTallyLimbs] = {0, 0, 0, 0, 0, 0};
  for (int d = 0; d < n_dev; d++) {
    const int32_t* p = parts + ((size_t)d * C + k) * kTallyLimbs;
#pragma unroll
    for (int i = 0; i < kTallyLimbs; i++) s[i] += (uint32_t)p[i];
  }
  int32_t t[kTallyLimbs];
#pragma unroll
  for (int i = 0; i < kTallyLimbs; i++) t[i] = (int32_t)s[i];
  carry_compare(t, thresh + (size_t)k * kTallyLimbs,
                tally + (size_t)k * kTallyLimbs, quorum + k);
}

}  // namespace cbt_tally
