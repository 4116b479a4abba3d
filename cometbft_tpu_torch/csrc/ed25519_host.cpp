// Host build of the kernels' per-thread arithmetic (csrc/*.cuh), compiled
// with a C++ compiler, and of the tally kernel's block and thread partition.
// The CPU tests hold its results against the oracle and the plain PyTorch
// versions, and, built with -DCBT_COUNT_OPS, it counts the field
// multiplications behind the kernels' bounds. The GPU path never loads it.
#include <stdint.h>

#include <algorithm>
#include <vector>

#ifdef CBT_COUNT_OPS
extern "C" {
long long cbt_fe_mul_count = 0, cbt_fe_sq_count = 0;
long long cbt_sha_block_count = 0;
}
#endif

#include "ed25519_cached.cuh"
#include "ed25519_cached_quad.cuh"
#include "ed25519_core.cuh"
#include "ed25519_quad.cuh"
#include "ristretto_core.cuh"
#include "secp256k1_core.cuh"
#include "secp256k1_quad.cuh"
#include "sr25519_quad.cuh"
#include "stamp_core.cuh"
#include "tally_core.cuh"
#include "valset_table_quad.cuh"

extern "C" void cbt_host_verify(const int32_t* rows, int B,
                                const int32_t* base, int32_t* out) {
  const cbt::ge_niels* tbl = reinterpret_cast<const cbt::ge_niels*>(base);
  for (int col = 0; col < B; col++)
    out[col] = cbt::verify_column(rows, B, col, tbl);
}

// The quad kernel's lane program (csrc/ed25519_quad.cuh) with all four
// lanes on one thread, column by column.
extern "C" void cbt_host_verify_quad(const int32_t* rows, int B,
                                     const int32_t* base, int32_t* out) {
  const cbt::ge_niels* tbl = reinterpret_cast<const cbt::ge_niels*>(base);
  cbt_quad::QTab<4> tab;
  for (int col = 0; col < B; col++)
    out[col] = cbt_quad::verify_column_quad(rows, B, col, tbl, tab);
}

extern "C" void cbt_host_sr25519_verify(const int32_t* rows, int B,
                                        const int32_t* base, int32_t* out) {
  const cbt::ge_niels* tbl = reinterpret_cast<const cbt::ge_niels*>(base);
  for (int col = 0; col < B; col++)
    out[col] = cbt::verify_column_sr(rows, B, col, tbl);
}

// The sr25519 quad kernel's lane program (csrc/sr25519_quad.cuh) with all
// four lanes on one thread, column by column.
extern "C" void cbt_host_sr25519_verify_quad(const int32_t* rows, int B,
                                             const int32_t* base,
                                             int32_t* out) {
  const cbt::ge_niels* tbl = reinterpret_cast<const cbt::ge_niels*>(base);
  cbt_quad::QTab<4> tab;
  for (int col = 0; col < B; col++)
    out[col] = cbt_quad::verify_column_sr_quad(rows, B, col, tbl, tab);
}

extern "C" void cbt_host_ecdsa_verify(const int32_t* rows, int B,
                                      const int32_t* base, int32_t* out) {
  const cbt_secp::gpt* tbl = reinterpret_cast<const cbt_secp::gpt*>(base);
  for (int col = 0; col < B; col++)
    out[col] = cbt_secp::ecdsa_verify_column(rows, B, col, tbl);
}

// The secp256k1 quad kernel's lane program (csrc/secp256k1_quad.cuh) with
// all four lanes on one thread, column by column.
extern "C" void cbt_host_ecdsa_verify_quad(const int32_t* rows, int B,
                                           const int32_t* base,
                                           int32_t* out) {
  const cbt_secp::gpt* tbl = reinterpret_cast<const cbt_secp::gpt*>(base);
  cbt_secp_quad::QTab<4> tab;
  for (int col = 0; col < B; col++)
    out[col] = cbt_secp_quad::verify_column_ecdsa_quad(rows, B, col, tbl, tab);
}

// The quad's point operations on n projective points a (and b), each
// (X, Y, Z) of ten limbs: op 0 a + b (a the accumulator, b the addend),
// op 1 2 a. out gets the four lanes (Y, Y, Z, X) of each result.
extern "C" void cbt_host_secp_quad_pt(int op, const int32_t* a,
                                      const int32_t* b, int n, int32_t* out) {
  using namespace cbt_secp_quad;
  const cbt_secp::gpt* pa = reinterpret_cast<const cbt_secp::gpt*>(a);
  const cbt_secp::gpt* pb = reinterpret_cast<const cbt_secp::gpt*>(b);
  for (int k = 0; k < n; k++) {
    Q<4> s = q_from_xyz<4>(pa[k].X, pa[k].Y, pa[k].Z);
    if (op == 0)
      q_add(s, q_addend(q_from_xyz<4>(pb[k].X, pb[k].Y, pb[k].Z)));
    else
      q_dbl(s);
    for (int l = 0; l < 4; l++)
      for (int i = 0; i < 10; i++) out[(4 * k + l) * 10 + i] = s.v[l].v[i];
  }
}

// Field arithmetic of secp256k1_core.cuh on n pairs of carried limbs, for
// the CPU tests: op 0 mul, 1 sq, 2 add, 3 sub, 4 canon, 5 sqrt power,
// 6 is_zero (in limb 0), 7 parity (in limb 0).
extern "C" void cbt_host_secp_fe(int op, const int32_t* a, const int32_t* b,
                                 int n, int32_t* out) {
  using cbt_secp::fe;
  for (int k = 0; k < n; k++) {
    fe x, y, r;
    for (int i = 0; i < 10; i++) {
      x.v[i] = a[10 * k + i];
      y.v[i] = b[10 * k + i];
    }
    switch (op) {
      case 0: r = cbt_secp::fe_mul(x, y); break;
      case 1: r = cbt_secp::fe_sq(x); break;
      case 2: r = cbt_secp::fe_add(x, y); break;
      case 3: r = cbt_secp::fe_sub(x, y); break;
      case 4: r = cbt_secp::fe_canon(x); break;
      case 5: r = cbt_secp::fe_pow_sqrt(x); break;
      case 6: r = cbt_secp::fe_small(cbt_secp::fe_is_zero(x) ? 1 : 0); break;
      default: r = cbt_secp::fe_small(cbt_secp::fe_parity(x)); break;
    }
    for (int i = 0; i < 10; i++) out[10 * k + i] = r.v[i];
  }
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

// The table kernel's quad and warp programs (csrc/valset_table_quad.cuh)
// with all four lanes of a quad on one thread, validator by validator;
// the same arguments and outputs as cbt_host_table_build.
template <bool (*Program)(const uint8_t*, int32_t*, int32_t*)>
static void host_table_build_lanes(const uint8_t* pub_raw, int n,
                                   int32_t* tab, uint8_t* ok) {
  std::vector<int32_t> zs(cbt_quad::kValZs * cbt_quad::kFeWords);
  for (int v = 0; v < n; v++)
    ok[v] = Program(pub_raw + (size_t)v * 32,
                    tab + (size_t)v * cbt::TAB_PER_VAL * cbt_quad::kNielsWords,
                    zs.data())
                ? 1
                : 0;
}

extern "C" void cbt_host_table_build_quad(const uint8_t* pub_raw, int n,
                                          int32_t* tab, uint8_t* ok) {
  host_table_build_lanes<cbt_quad::table_quad_host>(pub_raw, n, tab, ok);
}

extern "C" void cbt_host_table_build_warp(const uint8_t* pub_raw, int n,
                                          int32_t* tab, uint8_t* ok) {
  host_table_build_lanes<cbt_quad::table_warp_host>(pub_raw, n, tab, ok);
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

// The cached quad kernel's lane program (csrc/ed25519_cached_quad.cuh) with
// all four lanes on one thread, column by column.
extern "C" void cbt_host_verify_cached_quad(const int32_t* rows, int B,
                                            const int32_t* tab, int M,
                                            const uint8_t* ok,
                                            const int32_t* base,
                                            int32_t* out) {
  const cbt::ge_niels* t = reinterpret_cast<const cbt::ge_niels*>(tab);
  const cbt::ge_niels* b = reinterpret_cast<const cbt::ge_niels*>(base);
  for (int col = 0; col < B; col++)
    out[col] = cbt_quad::verify_column_cached_quad(rows, B, col, t, M, ok, b);
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
  uint64_t staged[16];
  for (int b = 0; b < B; b++)
    cbt_stamp::stamp_column(b, B, sig, ts, flags, tp, pub_raw, M, thr, n_thr,
                            t_rows, out, staged, 1);
}

extern "C" void cbt_host_stamp_general(
    const uint8_t* sig, const uint8_t* key, const int32_t* ts,
    const int32_t* flags, const int64_t* power, int B, const uint8_t* pre,
    const int32_t* pre_len, int pm, const uint8_t* suf,
    const int32_t* suf_len, int sm, const int32_t* ts_tag, int n_sites,
    const int32_t* thr, int n_thr, int t_rows, int32_t* out) {
  const cbt_stamp::StampTemplate tp{pre, pre_len, suf, suf_len, ts_tag,
                                    pm, sm, n_sites};
  uint64_t staged[16];
  for (int b = 0; b < B; b++)
    cbt_stamp::stamp_column_general(b, B, sig, key, ts, flags, power, tp, thr,
                                    n_thr, t_rows, out, staged, 1);
}

// The tally kernel (csrc/tally_quorum.cu) run one step at a time with its
// own block and thread partition: per block, each warp's 32 threads load
// and sum their columns, then the warp combines; below the shared-memory
// cap each block's partials are added to the sums after the block, above
// it the warps add to the sums directly. Returns 1 where the kernel keeps
// block partials in shared memory, 0 where it takes the global branch.
template <typename Src>
static int host_tally(const Src& s, int B, int C, int32_t* tally,
                      uint8_t* quorum) {
  using namespace cbt_tally;
  const bool smem = smem_partials(C);
  const bool vec = vector_loads(s.valid, s.rows, B);
  std::vector<int32_t> sums((size_t)C * kPowerLimbs, 0);
  std::vector<int32_t> part(smem ? sums.size() : 0);
  for (int blk = 0; blk < grid_blocks(B); blk++) {
    std::fill(part.begin(), part.end(), 0);
    int32_t* dst = smem ? part.data() : sums.data();
    for (int w = 0; w < kThreads / kWarp; w++) {
      int32_t cid[kWarp], acc[kWarp][kPowerLimbs];
      for (int l = 0; l < kWarp; l++) {
        Col c[kColsPerThread];
        thread_load(s, B, blk, w * kWarp + l, vec, c);
        thread_runs(c, C, dst, cid[l], acc[l]);
      }
      warp_combine_host(cid, acc, dst);
    }
    for (size_t i = 0; i < part.size(); i++)
      if (part[i] != 0) add_to(&sums[i], part[i]);
  }
  const int32_t* th = s.thresh();
  for (int k = 0; k < C; k++)
    finish_commit(&sums[(size_t)k * kPowerLimbs], th + (size_t)k * kTallyLimbs,
                  tally + (size_t)k * kTallyLimbs, quorum + k);
  return smem ? 1 : 0;
}

// cached = 0: the general entry (power5 and M unused); 1: the cached one.
extern "C" int cbt_host_tally(int cached, const int32_t* valid,
                              const int32_t* rows, int B,
                              const int32_t* power5, int M, int n_commits,
                              int32_t* tally, uint8_t* quorum) {
  if (n_commits <= 0) return -1;
  if (cached)
    return host_tally(cbt_tally::CachedSrc{valid, rows, B, power5, M}, B,
                      n_commits, tally, quorum);
  return host_tally(cbt_tally::GeneralSrc{valid, rows, B}, B, n_commits,
                    tally, quorum);
}

// The mesh reduce of cbt_carry_quorum, a commit at a time.
extern "C" void cbt_host_carry_quorum(const int32_t* parts, int n_dev,
                                      int n_commits, const int32_t* thresh,
                                      int32_t* tally, uint8_t* quorum) {
  for (int k = 0; k < n_commits; k++)
    cbt_tally::carry_quorum_commit(parts, n_dev, n_commits, k, thresh, tally,
                                   quorum);
}

// The stamp's mod-L reduction on a 64-byte digest: in read as the digest's
// big-endian state words, out the 32 little-endian bytes of (in mod L).
extern "C" void cbt_host_sc_reduce(const uint8_t* in, uint8_t* out) {
  uint64_t h[8];
  for (int i = 0; i < 8; i++) h[i] = cbt_stamp::load_be64(in + 8 * i);
  uint32_t w[8];
  cbt_stamp::sc_reduce_digest(h, w);
  for (int k = 0; k < 32; k++) out[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
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
