// valset_table_build: the per-validator niels window table of the cached
// ed25519 path, on Hopper.
//
// Replaces: cometbft_tpu/ops/ed25519_cached.py `_build_core` (XLA) and its
// relayout `_blocked_i16`; `update_table` (`_update_core`) runs this same
// kernel over a 128-slot delta and scatters the columns.
//
// What bounds it on an H100: integer multiply-adds. A validator's table
// needs one decompression of A, 224 chained doublings (base_j = 2^(32 j)
// (-A)), 8 x 14 additions, one inversion shared by its 120 Z's and 120
// conversions to canonical affine form (ed25519_cached.BUILD_NEEDED_FE_*);
// the bytes are 33 B in and 15,361 B out per validator (15.7 MB at
// M = 1,024, 252 MB at M = 16,384), a few microseconds to milliseconds of
// HBM time next to the arithmetic.
//
// Design: two entries with the same arguments and outputs, over the lane
// programs of csrc/valset_table_quad.cuh (on csrc/ed25519_quad.cuh: four
// threads hold the four coordinates of a point, so a doubling or an
// addition is two field products a lane). A 128-thread block's first warp
// decodes the block's keys (one a thread, the out-of-line field ops, so
// the square-root chain's registers stay out of the lane program) and
// hands A's (x, y) over in shared memory; after the forward half of
// Montgomery's trick it inverts the block's 32 Z products, one a thread.
// No per-thread array, so nothing in local memory; at most 128 registers
// a thread, four blocks an SM.
//
// The quad entry (cbt_valset_table_build_quad): one quad a validator, 32
// a block. The quad chains the 224 doublings, makes each base's 15
// entries as the base comes, and carries one running product over the
// validator's 120 Z's; the entries' numerators wait in their own output
// slots and the Z's in a scratch of 4,800 B a validator. It issues the
// fewest products a validator, so it wins once the card is full.
//
// The warp entry (cbt_valset_table_build_warp): eight quads a validator,
// four a block, quad j for base j. All eight run the 224 doublings in step
// (the warp issues them once for its 32 threads), quad j keeps the point
// after 32 j, makes base j's entries and inverts their 15 Z's. Its chain
// holds one base's entries where the quad's holds eight, for 3.7x the
// products a validator, so it wins while schedulers sit idle.
//
// The wrapper (ops/ed25519_cached.py table_build_entry) launches the warp
// entry up to a crossover in validators an SM and the quad entry above.
// The entries are canonical, so the table bytes do not depend on the
// order of operations.
#include <cuda_runtime.h>
#include <stdint.h>

#include "valset_table_quad.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQuads = kThreads / 4;
// four blocks (sixteen warps) an SM: at most 128 registers a thread, so
// M = 16,384 (2,048 warps of the quad entry) is one wave on 132 SMs
constexpr int kBlocksPerSm = 4;

// The first warp's one-thread chains, out of line: their registers are
// allocated apart from the lane program's, which so keeps within 128
// registers without a spill.
__device__ __noinline__ bool decode_chain(const uint8_t* pub, cbt::fe* x,
                                          cbt::fe* y) {
  return cbt_quad::decode_key(pub, x, y);
}

__device__ __noinline__ cbt::fe invert_chain(cbt::fe z) {
  return cbt::fe_invert(z);
}

// kQuadsPerVal = 1: the quad program; 8: the warp program.
template <int kQuadsPerVal>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
valset_table_quad_kernel(const uint8_t* __restrict__ pub_raw,
                         const uint8_t* __restrict__ lenok, int M,
                         int32_t* __restrict__ tab, int32_t* __restrict__ zs,
                         uint8_t* __restrict__ ok) {
  using namespace cbt_quad;
  constexpr int kVals = kQuads / kQuadsPerVal;
  __shared__ alignas(8) int32_t key[kVals][2][kFeWords];  // A's x and y
  __shared__ alignas(8) int32_t prod[kQuads][kFeWords];   // Z product, 1/it
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * kVals;
  if (tid < kVals) {  // the first warp decodes the block's keys
    const int v = v0 + tid;
    fe x = cbt::fe_zero(), y = cbt::fe_one();
    if (v < M) {
      const bool dec = decode_chain(pub_raw + (size_t)v * 32, &x, &y);
      ok[v] = (dec && lenok[v]) ? 1 : 0;
    }
    st_fe(key[tid][0], x);
    st_fe(key[tid][1], y);
  }
  __syncthreads();
  const int q = tid >> 2, vq = q / kQuadsPerVal, j = q % kQuadsPerVal;
  const bool live = v0 + vq < M;
  const size_t v = live ? (size_t)(v0 + vq) : 0;
  const TabIO io{tab + v * cbt::TAB_PER_VAL * kNielsWords,
                 zs + v * kValZs * kFeWords, live};
  const fe x = ld_fe(key[vq][0]), y = ld_fe(key[vq][1]);
  Q<1> pre;
  if constexpr (kQuadsPerVal == 1)
    pre = q_table_fwd<1>(io, x, y);
  else
    pre = q_warp_fwd<1>(io, j, x, y);
  if ((tid & 3) == 3) st_fe(prod[q], pre.v[0]);
  __syncthreads();
  if (tid < kQuads) {  // the first warp inverts the block's 32 products
    st_fe(prod[tid], invert_chain(ld_fe(prod[tid])));
  }
  __syncthreads();
  const Q<1> inv = q_all<1>(ld_fe(prod[q]));
  if constexpr (kQuadsPerVal == 1)
    q_entries_bwd<1>(io, 0, kValZs, inv);
  else
    q_entries_bwd<1>(io, j * kBaseZs, (j + 1) * kBaseZs, inv);
}

template <int kQuadsPerVal>
int launch_quad(const uint8_t* pub_raw, const uint8_t* lenok, int M,
                int32_t* tab, int32_t* zs, uint8_t* ok, void* stream) {
  if (M <= 0) return 0;
  constexpr int kVals = kQuads / kQuadsPerVal;
  const int blocks = (M + kVals - 1) / kVals;
  valset_table_quad_kernel<kQuadsPerVal>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(pub_raw, lenok, M, tab,
                                                      zs, ok);
  return (int)cudaGetLastError();
}

}  // namespace

// pub_raw: (M, 32) uint8 key bytes (zero for dead or malformed slots);
// lenok: (M,) uint8, 1 where the key had 32 bytes; tab: (M * 128, 3, 10)
// int32 niels entries; zs: (M * 120 * 10) int32 scratch; ok: (M,) bool.
// Each entry launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
extern "C" int cbt_valset_table_build_quad(const uint8_t* pub_raw,
                                           const uint8_t* lenok, int M,
                                           int32_t* tab, int32_t* zs,
                                           uint8_t* ok, void* stream) {
  return launch_quad<1>(pub_raw, lenok, M, tab, zs, ok, stream);
}

extern "C" int cbt_valset_table_build_warp(const uint8_t* pub_raw,
                                           const uint8_t* lenok, int M,
                                           int32_t* tab, int32_t* zs,
                                           uint8_t* ok, void* stream) {
  return launch_quad<8>(pub_raw, lenok, M, tab, zs, ok, stream);
}
