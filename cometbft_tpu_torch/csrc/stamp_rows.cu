// stamp_rows: device sign-bytes stamping of the cached packed rows, on
// Hopper.
//
// Replaces: cometbft_tpu/ops/ed25519_cached.py `_stamp_rows_core` (XLA),
// the prologue of `verify_tally_delta_cached`.
//
// What bounds it on an H100: integer operations. A live row hashes 64 +
// ~150 bytes with SHA-512 (two 128-byte blocks of 80 rounds of 26 64-bit
// operations and 64 schedule steps of 13, which the card executes as
// 32-bit halves; ed25519_stamp.SHA512_OPS_PER_BLOCK counts them), then
// reduces the digest mod L (ref10 sc_reduce, 84 int64 products); the
// bytes are 80 B of deltas and 32 B of key in, 108 B of rows out per row.
//
// Design: one thread per row, 128 threads a block. The thread streams the
// row's message (R, A, the sign-bytes assembled from the template and the
// timestamp varints) byte by byte into a 128-byte block buffer in local
// memory and compresses whenever it fills, so no padded message matrix
// exists anywhere. It writes its whole column, the threshold rows included
// (threshold word k of the flat matrix sits at column k mod B of row
// 27 + k / B), so the output needs no zero fill and the stamped rows go
// straight to ed25519_verify_cached without leaving the device.
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
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  cbt_stamp::stamp_column(b, B, sig, ts, flags, tp, pub_raw, M, thr, n_thr,
                          t_rows, out);
}

}  // namespace

// sig (B, 64) uint8, ts (B, 3) int32, flags (B,) int32; the template:
// pre (n_sites, pm) uint8, pre_len (n_sites,) int32, suf (n_sites, sm)
// uint8, suf_len and ts_tag (n_sites,) int32; pub_raw (M, 32) uint8;
// thr: n_thr int32 threshold words; out: (27 + t_rows, B) int32. Launches
// on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int cbt_stamp_rows(const uint8_t* sig, const int32_t* ts,
                              const int32_t* flags, int B, const uint8_t* pre,
                              const int32_t* pre_len, int pm,
                              const uint8_t* suf, const int32_t* suf_len,
                              int sm, const int32_t* ts_tag, int n_sites,
                              const uint8_t* pub_raw, int M,
                              const int32_t* thr, int n_thr, int t_rows,
                              int32_t* out, void* stream) {
  if (B <= 0) return 0;
  const cbt_stamp::StampTemplate tp{pre, pre_len, suf, suf_len, ts_tag,
                                    pm, sm, n_sites};
  const int blocks = (B + kThreads - 1) / kThreads;
  stamp_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sig, ts, flags, B, tp, pub_raw, M, thr, n_thr, t_rows, out);
  return (int)cudaGetLastError();
}
