// stamp_rows and stamp_rows_general: device sign-bytes stamping of packed
// rows, on Hopper.
//
// stamp_rows replaces: cometbft_tpu/ops/ed25519_cached.py `_stamp_rows_core`
// (XLA), the prologue of `verify_tally_delta_cached`. stamp_rows_general
// replaces no TPU kernel: the JAX package packs the general chunk's rows on
// the host (blocksync/pipeline.py, its native commit pack, then
// `pack_rows`), and so did the port. It was added because that host pack
// set the blocksync stream's pace while the card idled: here the rows of a
// chunk of mixed validator sets are built on the card from per-row deltas,
// in the general layout (ops/ed25519_fused.py C_*), and go straight to
// ed25519_verify and tally_quorum.
//
// What bounds both on an H100: integer operations. A live row hashes 64 +
// ~150 bytes with SHA-512 (two 128-byte blocks of 80 rounds of 26 64-bit
// operations and 64 schedule steps of 13, which the card executes as
// 32-bit halves; ed25519_stamp.SHA512_OPS_PER_BLOCK counts them), then
// reduces the digest mod L (ref10 sc_reduce, 84 int64 products). The bytes
// are 80 B of deltas and 32 B of key in, 108 B of rows out per cached row;
// 120 B in (the key and the power ride the deltas) and 164 B out per
// general row.
//
// Design: one thread per row, 128 threads a block (a row's SHA-512 chain
// is serial; 64,000 rows give ~4 blocks an SM). The thread's program
// (stamp_core.cuh) reads the signature and the key with 16-byte loads and
// the template's prefix and suffix as aligned words (the rows of a warp
// share one template, so those loads are broadcasts). It stages each
// 128-byte block as 16 big-endian words in its own column of shared
// memory, each segment of the message funnel-shifted into the words it
// overlaps, reads them back at constant indices into registers, and runs
// the compression there (16 rounds unrolled); the digest is reduced mod L
// on 21-bit limbs cut from its words. Nothing lives in local memory, and no
// padded message exists anywhere. The thread writes its whole column, the
// threshold rows included (threshold word k of the flat matrix sits at
// column k mod B of the first threshold row + k / B), so the output needs
// no zero fill and the stamped rows go straight to the verify kernel
// without leaving the device. The general entry differs only in its column
// writer: the key comes with the row instead of from a table, and the
// column also carries the key's limbs, the power and the commit id.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stamp_core.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
stamp_rows_kernel(const uint8_t* __restrict__ sig,
                  const int32_t* __restrict__ ts,
                  const int32_t* __restrict__ flags, int B,
                  cbt_stamp::StampTemplate tp,
                  const uint8_t* __restrict__ pub_raw, int M,
                  const int32_t* __restrict__ thr, int n_thr, int t_rows,
                  int32_t* __restrict__ out) {
  // one staged SHA block a thread, word k of thread t at k * kThreads + t:
  // a warp's accesses to one word fall in distinct banks
  __shared__ uint64_t staged[16 * kThreads];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // no barrier: each thread reads only its own words
  cbt_stamp::stamp_column(b, B, sig, ts, flags, tp, pub_raw, M, thr, n_thr,
                          t_rows, out, staged + threadIdx.x, kThreads);
}

__global__ void __launch_bounds__(kThreads)
stamp_rows_general_kernel(const uint8_t* __restrict__ sig,
                          const uint8_t* __restrict__ key,
                          const int32_t* __restrict__ ts,
                          const int32_t* __restrict__ flags,
                          const int64_t* __restrict__ power, int B,
                          cbt_stamp::StampTemplate tp,
                          const int32_t* __restrict__ thr, int n_thr,
                          int t_rows, int32_t* __restrict__ out) {
  __shared__ uint64_t staged[16 * kThreads];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  cbt_stamp::stamp_column_general(b, B, sig, key, ts, flags, power, tp, thr,
                                  n_thr, t_rows, out, staged + threadIdx.x,
                                  kThreads);
}

bool template_misaligned(const uint8_t* pre, const uint8_t* suf, int pm,
                         int sm) {
  return (((uintptr_t)pre | (uintptr_t)suf | (uintptr_t)pm | (uintptr_t)sm) &
          7) != 0;
}

}  // namespace

// sig (B, 64) uint8, ts (B, 3) int32, flags (B,) int32; the template:
// pre (n_sites, pm) uint8, pre_len (n_sites,) int32, suf (n_sites, sm)
// uint8, suf_len and ts_tag (n_sites,) int32; pub_raw (M, 32) uint8;
// thr: n_thr int32 threshold words; out: (27 + t_rows, B) int32. Launches
// on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorMisalignedAddress without launching when
// sig or pub_raw is not 16-byte aligned or a template row not 8-byte
// aligned.
extern "C" int cbt_stamp_rows(const uint8_t* sig, const int32_t* ts,
                              const int32_t* flags, int B, const uint8_t* pre,
                              const int32_t* pre_len, int pm,
                              const uint8_t* suf, const int32_t* suf_len,
                              int sm, const int32_t* ts_tag, int n_sites,
                              const uint8_t* pub_raw, int M,
                              const int32_t* thr, int n_thr, int t_rows,
                              int32_t* out, void* stream) {
  if (B <= 0) return 0;
  if ((((uintptr_t)sig | (uintptr_t)pub_raw) & 15) ||
      template_misaligned(pre, suf, pm, sm))
    return (int)cudaErrorMisalignedAddress;
  const cbt_stamp::StampTemplate tp{pre, pre_len, suf, suf_len, ts_tag,
                                    pm, sm, n_sites};
  const int blocks = (B + kThreads - 1) / kThreads;
  stamp_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sig, ts, flags, B, tp, pub_raw, M, thr, n_thr, t_rows, out);
  return (int)cudaGetLastError();
}

// sig (B, 64) and key (B, 32) uint8, ts (B, 3) int32, flags (B,) int32,
// power (B,) int64; the template as cbt_stamp_rows'; thr: n_thr int32
// threshold words; out: (41 + t_rows, B) int32. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError(), or
// cudaErrorMisalignedAddress without launching when sig or key is not
// 16-byte aligned, power not 8-byte aligned or a template row not 8-byte
// aligned.
extern "C" int cbt_stamp_rows_general(
    const uint8_t* sig, const uint8_t* key, const int32_t* ts,
    const int32_t* flags, const int64_t* power, int B, const uint8_t* pre,
    const int32_t* pre_len, int pm, const uint8_t* suf,
    const int32_t* suf_len, int sm, const int32_t* ts_tag, int n_sites,
    const int32_t* thr, int n_thr, int t_rows, int32_t* out, void* stream) {
  if (B <= 0) return 0;
  if ((((uintptr_t)sig | (uintptr_t)key) & 15) || ((uintptr_t)power & 7) ||
      template_misaligned(pre, suf, pm, sm))
    return (int)cudaErrorMisalignedAddress;
  const cbt_stamp::StampTemplate tp{pre, pre_len, suf, suf_len, ts_tag,
                                    pm, sm, n_sites};
  const int blocks = (B + kThreads - 1) / kThreads;
  stamp_rows_general_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sig, key, ts, flags, power, B, tp, thr, n_thr, t_rows, out);
  return (int)cudaGetLastError();
}
