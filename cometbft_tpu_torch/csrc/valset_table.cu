// valset_table_build: the per-validator niels window table of the cached
// ed25519 path, on Hopper.
//
// Replaces: cometbft_tpu/ops/ed25519_cached.py `_build_core` (XLA) and its
// relayout `_blocked_i16`; `update_table` (`_update_core`) runs this same
// kernel over a 128-slot delta and scatters the columns.
//
// What bounds it on an H100: integer multiply-adds. Each (validator, j)
// pair decompresses A (one square-root chain), doubles 32 j times, makes 15
// cached adds, one inversion and 16 conversions to canonical affine form;
// the bytes are 33 B in and 15,361 B out per validator (15.7 MB at
// M = 1,024, 252 MB at M = 16,384), a few microseconds to milliseconds of
// HBM time next to the arithmetic.
//
// Design: one thread per (validator, base j), thread index j * M + v, so
// the 32 threads of a warp share j and run the same number of doublings (no
// divergence; warps of larger j simply run longer). Each thread writes its
// 16 entries (1,920 B) and recomputes the decompression of A, which is
// cheaper than a second launch to share it. That buys parallelism with
// repeated work: a validator's 8 threads run 8 decompressions and 8
// inversion chains where one of each suffices, and 896 doublings where 224
// chained ones suffice, 2.8x the multiplications the table needs (the
// bound counts only those, ed25519_cached.BUILD_NEEDED_FE_*). The 16
// extended points and their prefix products live in local memory. The
// entries are canonical, so the table bytes do not depend on the order of
// operations.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_cached.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
valset_table_kernel(const uint8_t* __restrict__ pub_raw,
                    const uint8_t* __restrict__ lenok, int M,
                    cbt::ge_niels* __restrict__ tab, uint8_t* __restrict__ ok) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= M * cbt::TAB_NJ) return;
  const int j = t / M, v = t % M;
  cbt::ge_niels* out =
      tab + (size_t)v * cbt::TAB_PER_VAL + (size_t)j * cbt::TAB_NENT;
  const bool dec = cbt::table_entries(pub_raw + (size_t)v * 32, j, out);
  if (j == 0) ok[v] = (dec && lenok[v]) ? 1 : 0;
}

}  // namespace

// pub_raw: (M, 32) uint8 key bytes (zero for dead or malformed slots);
// lenok: (M,) uint8, 1 where the key had 32 bytes; tab: (M * 128, 3, 10)
// int32 niels entries; ok: (M,) bool. Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError().
extern "C" int cbt_valset_table_build(const uint8_t* pub_raw,
                                      const uint8_t* lenok, int M,
                                      int32_t* tab, uint8_t* ok,
                                      void* stream) {
  if (M <= 0) return 0;
  const int n = M * cbt::TAB_NJ;
  const int blocks = (n + kThreads - 1) / kThreads;
  valset_table_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pub_raw, lenok, M, reinterpret_cast<cbt::ge_niels*>(tab), ok);
  return (int)cudaGetLastError();
}
