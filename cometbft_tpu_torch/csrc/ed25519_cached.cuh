// Cached-valset ed25519 arithmetic: table_entries, the one-thread table
// build, and verify_column_cached, the one-thread verdict of a cached
// column. The table kernel (valset_table.cu) runs the lane programs of
// valset_table_quad.cuh on the card; table_entries is their host reference
// (cbt_host_table_build). The cached verify kernel
// (ed25519_cached_verify.cu) runs the quad program of
// ed25519_cached_quad.cuh on the card; verify_column_cached is its host
// reference (cbt_host_verify_cached), and runs on the card only in the
// kernel's one-thread entry. The host build (ed25519_host.cpp, compiled
// with the C++ compiler) lets the CPU tests check all of it against the
// oracle and the plain versions.
//
// The port's valset table: entry e = j * 16 + d of validator v, at index
// v * 128 + e, is [d] * (2^(32 j) * (-A_v)) as an affine niels point
// {y + x, y - x, 2 d x y} of canonical radix-2^25.5 limbs (ge_niels, 120 B),
// so a validator's 128 entries are 15,360 B. The values are the JAX
// package's table entries (ops/ed25519_cached.py `_build_core`, which stores
// them as (y - x, y + x, 2 d t) in 13-bit limbs); only the layout differs.
#pragma once
#include <stddef.h>

#include "ed25519_core.cuh"

namespace cbt {

// packed-row layout of the cached path (ops/ed25519_cached.py V_*)
enum { V_RY = 0, V_S8 = 10, V_H4 = 18, V_FLAGS = 26 };
enum { TAB_NJ = 8, TAB_NENT = 16, TAB_PER_VAL = TAB_NJ * TAB_NENT };

// canonical affine niels form of p, given 1 / p.Z
CBT_HD ge_niels ge_niels_affine(const ge_p3& p, const fe& zinv) {
  const fe x = fe_mul(p.X, zinv), y = fe_mul(p.Y, zinv);
  ge_niels n;
  n.ypx = fe_canon(fe_add(y, x));
  n.ymx = fe_canon(fe_sub(y, x));
  n.xy2d = fe_canon(fe_mul(fe_mul(x, y), fe_d2()));
  return n;
}

// The 16 entries [d] * base_j, base_j = 2^(32 j) * (-A), of one validator
// and one j, where A decodes from the 32 raw key bytes `pub` (ZIP-215).
// A key that does not decode gives identity entries. Returns whether A
// decoded. The 16 Z's share one inversion (Montgomery's trick).
CBT_HD bool table_entries(const uint8_t* pub, int j, ge_niels* out) {
  ge_p3 A;
  const bool ok = ge_decompress(fe_from_bytes(pub), pub[31] >> 7, &A);
  ge_p3 base = ge_identity();
  if (ok) {
    base = A;
    base.X = fe_neg(A.X);
    base.T = fe_neg(A.T);
  }
  // T is only read after the last doubling
  for (int i = 0; i < 32 * j; i++) base = ge_dbl(base, i == 32 * j - 1);
  ge_p3 pts[TAB_NENT];
  pts[0] = ge_identity();
  pts[1] = base;
  const ge_cached c = ge_to_cached(base);
  for (int d = 2; d < TAB_NENT; d++) pts[d] = ge_add(pts[d - 1], c);
  fe pre[TAB_NENT];
  pre[0] = pts[0].Z;
  for (int d = 1; d < TAB_NENT; d++) pre[d] = fe_mul(pre[d - 1], pts[d].Z);
  fe inv = fe_invert(pre[TAB_NENT - 1]);
  for (int d = TAB_NENT - 1; d > 0; d--) {
    out[d] = ge_niels_affine(pts[d], fe_mul(inv, pre[d - 1]));
    inv = fe_mul(inv, pts[d].Z);
  }
  out[0] = ge_niels_affine(pts[0], inv);
  return ok;
}

// The verdict of column `col` of the cached packed rows (R, B), one thread
// a column: the host reference of the quad kernel's program
// (cbt_quad::quad_verdict_cached), and the kernel's one-thread entry.
// Column col is validator v = col mod M, whose 128 table entries start at
// tab[v * 128].
// 1 iff the precheck passed, ok[v], R decodes and
// [8]([h](-A) + [s]B - R) is the identity. h(-A) is a Horner loop over 8
// windows of 4 doublings; window w adds base j's digit, nibble 8 j + w of h,
// for j = 0..7. [s]B is the general kernel's width-8 comb over `base`.
CBT_HD int verify_column_cached(const int32_t* rows, int B, int col,
                                const ge_niels* tab, int M,
                                const uint8_t* ok, const ge_niels* base) {
  const uint32_t flags = (uint32_t)rows[V_FLAGS * B + col];
  if (((flags >> 1) & 1) == 0) return 0;  // precheck failed or dead lane
  const int v = col % M;
  if (!ok[v]) return 0;
  ge_p3 R;
  if (!ge_decompress(fe_from_packed13(rows, B, V_RY, col), flags & 1, &R))
    return 0;

  const ge_niels* t = tab + (size_t)v * TAB_PER_VAL;
  ge_p3 acc = ge_identity();
  for (int w = 7; w >= 0; w--) {
    if (w != 7) {
      acc = ge_dbl(acc, false);
      acc = ge_dbl(acc, false);
      acc = ge_dbl(acc, false);
      acc = ge_dbl(acc, true);
    }
    const uint32_t word = (uint32_t)rows[(V_H4 + w) * B + col];
    for (int j = 0; j < TAB_NJ; j++)
      acc = ge_madd(acc, t[j * TAB_NENT + ((word >> (4 * j)) & 15)]);
  }

  for (int w = 0; w < 32; w++) {
    const uint32_t word = (uint32_t)rows[(V_S8 + (w & 7)) * B + col];
    acc = ge_madd(acc, base[w * 256 + ((word >> (8 * (w >> 3))) & 255)]);
  }

  acc = ge_add(acc, ge_cached_neg(ge_to_cached(R)));
  acc = ge_dbl(acc, false);
  acc = ge_dbl(acc, false);
  acc = ge_dbl(acc, false);
  return (fe_is_zero(acc.X) && fe_eq(acc.Y, acc.Z)) ? 1 : 0;
}

}  // namespace cbt
