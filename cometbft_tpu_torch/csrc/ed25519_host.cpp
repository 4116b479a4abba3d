// Host build of the kernels' per-thread arithmetic (csrc/*.cuh), compiled
// with a C++ compiler. The CPU tests hold its results against the oracle and
// the plain PyTorch versions, and, built with -DCBT_COUNT_OPS, it counts the
// field multiplications behind the kernels' bounds. The GPU path never loads
// it.
#include <stdint.h>

#ifdef CBT_COUNT_OPS
extern "C" {
long long cbt_fe_mul_count = 0, cbt_fe_sq_count = 0;
long long cbt_sha_block_count = 0;
}
#endif

#include "ed25519_cached.cuh"
#include "ed25519_core.cuh"
#include "stamp_core.cuh"

extern "C" void cbt_host_verify(const int32_t* rows, int B,
                                const int32_t* base, int32_t* out) {
  const cbt::ge_niels* tbl = reinterpret_cast<const cbt::ge_niels*>(base);
  for (int col = 0; col < B; col++)
    out[col] = cbt::verify_column(rows, B, col, tbl);
}

// pub_raw (n, 32) uint8 -> tab (n * 128, 3, 10) int32 and decode bits (n,)
extern "C" void cbt_host_table_build(const uint8_t* pub_raw, int n,
                                     int32_t* tab, uint8_t* ok) {
  for (int v = 0; v < n; v++)
    for (int j = 0; j < cbt::TAB_NJ; j++) {
      cbt::ge_niels* out = reinterpret_cast<cbt::ge_niels*>(tab) +
                           (size_t)v * cbt::TAB_PER_VAL + j * cbt::TAB_NENT;
      const bool dec = cbt::table_entries(pub_raw + (size_t)v * 32, j, out);
      if (j == 0) ok[v] = dec ? 1 : 0;
    }
}

extern "C" void cbt_host_verify_cached(const int32_t* rows, int B,
                                       const int32_t* tab, int M,
                                       const uint8_t* ok, const int32_t* base,
                                       int32_t* out) {
  const cbt::ge_niels* t = reinterpret_cast<const cbt::ge_niels*>(tab);
  const cbt::ge_niels* b = reinterpret_cast<const cbt::ge_niels*>(base);
  for (int col = 0; col < B; col++)
    out[col] = cbt::verify_column_cached(rows, B, col, t, M, ok, b);
}

extern "C" void cbt_host_stamp(const uint8_t* sig, const int32_t* ts,
                               const int32_t* flags, int B,
                               const uint8_t* pre, const int32_t* pre_len,
                               int pm, const uint8_t* suf,
                               const int32_t* suf_len, int sm,
                               const int32_t* ts_tag, int n_sites,
                               const uint8_t* pub_raw, int M,
                               const int32_t* thr, int n_thr, int t_rows,
                               int32_t* out) {
  const cbt_stamp::StampTemplate tp{pre, pre_len, suf, suf_len, ts_tag,
                                    pm, sm, n_sites};
  for (int b = 0; b < B; b++)
    cbt_stamp::stamp_column(b, B, sig, ts, flags, tp, pub_raw, M, thr, n_thr,
                            t_rows, out);
}

extern "C" void cbt_host_sc_reduce(const uint8_t* in, uint8_t* out) {
  cbt_stamp::sc_reduce(in, out);
}

extern "C" void cbt_host_op_counts(long long* mul, long long* sq) {
#ifdef CBT_COUNT_OPS
  *mul = cbt_fe_mul_count;
  *sq = cbt_fe_sq_count;
#else
  *mul = -1;
  *sq = -1;
#endif
}

extern "C" long long cbt_host_sha_blocks(void) {
#ifdef CBT_COUNT_OPS
  return cbt_sha_block_count;
#else
  return -1;
#endif
}
