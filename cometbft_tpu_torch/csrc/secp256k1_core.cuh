// GF(p), p = 2^256 - 2^32 - 977, and secp256k1 point arithmetic for one
// signature per thread, plus the ECDSA verdict of one packed column.
// Shared by the Hopper kernel (ecdsa_verify.cu) and the host build
// (ed25519_host.cpp) that the CPU tests hold against the oracle
// (crypto/secp256k1_ref.py) and the plain PyTorch version.
//
// Field elements: ten signed int32 limbs of 26 bits (libsecp256k1's
// field_10x26 radix), limb i of weight 2^(26 i), 260 bits in all. A limb
// product is one 32 x 32 -> 64 bit multiply; a schoolbook column of ten
// fits int64. Reduction folds weight 2^260 = 2^36 + 0x3D10 (mod p): a
// carry c out of limb 9 adds 0x3D10 c to limb 0 and 2^10 c to limb 1.
// Every op returns "carried" limbs: limbs 0-8 in [0, 2^26), limb 9 within
// a few units of [0, 2^26]; fe_mul and fe_sq accept |limb| < 2^28, so a
// sum or difference of two carried values may enter a product uncarried,
// but the code below carries every sum anyway (cheap next to a product).
#pragma once
#include <stdint.h>

#include "ed25519_core.cuh"  // CBT_HD, CBT_COUNT and the op counters

namespace cbt_secp {

// packed-row layout read by the verify (ops/ecdsa_fused.py E_*, the JAX
// package's ecdsa_pallas ABI)
enum { E_QX = 0, E_XR1 = 10, E_XR2 = 20, E_U1 = 30, E_U2 = 38, E_FLAGS = 46 };

struct fe { int32_t v[10]; };

constexpr int64_t kM26 = ((int64_t)1 << 26) - 1;
constexpr int64_t kFold260 = 0x3D10;  // 2^260 = 2^36 + 0x3D10 (mod p)

// limbs 0-8 to [0, 2^26) with floor carries; limb 9 keeps the rest
CBT_HD void ripple9(int64_t h[10]) {
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int64_t c = h[i] >> 26;
    h[i] -= c * ((int64_t)1 << 26);
    h[i + 1] += c;
  }
}

// Signed limbs (|h_i| < 2^61, value below 2^522 in magnitude) -> carried
// limbs: a ripple, the carry out of limb 9 (weight 2^260, below 2^36 in
// magnitude) folded into limbs 0 and 1, and a second ripple, whose carry
// into limb 9 is a few units.
CBT_HD fe fe_carry(int64_t h[10]) {
  ripple9(h);
  const int64_t c = h[9] >> 26;
  h[9] -= c * ((int64_t)1 << 26);
  h[0] += c * kFold260;
  h[1] += c * 1024;
  ripple9(h);
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)h[i];
  return r;
}

CBT_HD fe fe_small(int32_t a) {
  fe r;
  r.v[0] = a;
#pragma unroll
  for (int i = 1; i < 10; i++) r.v[i] = 0;
  return r;
}

CBT_HD fe fe_add(const fe& f, const fe& g) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (int64_t)f.v[i] + g.v[i];
  return fe_carry(h);
}

CBT_HD fe fe_sub(const fe& f, const fe& g) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (int64_t)f.v[i] - g.v[i];
  return fe_carry(h);
}

CBT_HD fe fe_neg(const fe& f) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = -f.v[i];
  return r;
}

CBT_HD fe fe_mul_small(const fe& f, int32_t k) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (int64_t)f.v[i] * k;
  return fe_carry(h);
}

// 19 product columns (signed, |c| < 2^59.4) -> carried limbs: ripple them
// into 26-bit digits r0..r18 and a top carry r19, fold digits 10..19
// (weight 2^(26 k) = 2^260 2^(26 (k - 10))) down, then fe_carry.
CBT_HD fe fe_reduce19(const int64_t c[19]) {
  int64_t r[20];
  int64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 19; k++) {
    const int64_t t = c[k] + carry;
    carry = t >> 26;
    r[k] = t - carry * ((int64_t)1 << 26);
  }
  r[19] = carry;
  int64_t h[10];
  h[0] = r[0] + r[10] * kFold260 + r[19] * (kFold260 * 1024);
  h[1] = r[1] + r[11] * kFold260 + r[10] * 1024 + r[19] * ((int64_t)1 << 20);
#pragma unroll
  for (int j = 2; j < 9; j++)
    h[j] = r[j] + r[j + 10] * kFold260 + r[j + 9] * 1024;
  h[9] = r[9] + r[19] * kFold260 + r[18] * 1024;
  return fe_carry(h);
}

// 100 limb products
CBT_HD_NOINLINE fe fe_mul(const fe f, const fe g) {
  CBT_COUNT(cbt_fe_mul_count);
  int64_t c[19];
#pragma unroll
  for (int k = 0; k < 19; k++) c[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) c[i + j] += (int64_t)f.v[i] * g.v[j];
  }
  return fe_reduce19(c);
}

// 55 limb products: f_i f_j (i < j) counted twice
CBT_HD_NOINLINE fe fe_sq(const fe f) {
  CBT_COUNT(cbt_fe_sq_count);
  int64_t c[19];
#pragma unroll
  for (int k = 0; k < 19; k++) c[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    c[2 * i] += (int64_t)f.v[i] * f.v[i];
    const int32_t f2 = 2 * f.v[i];
#pragma unroll
    for (int j = i + 1; j < 10; j++) c[i + j] += (int64_t)f2 * f.v[j];
  }
  return fe_reduce19(c);
}

CBT_HD fe fe_sq_n(fe f, int n) {
  for (int i = 0; i < n; i++) f = fe_sq(f);
  return f;
}

// a^((p + 1) / 4), libsecp256k1's chain: (p + 1) / 4 has blocks of 223,
// 22 and 2 ones; 253 squarings and 13 multiplications
CBT_HD fe fe_pow_sqrt(const fe& a) {
  const fe x2 = fe_mul(fe_sq(a), a);
  const fe x3 = fe_mul(fe_sq(x2), a);
  const fe x6 = fe_mul(fe_sq_n(x3, 3), x3);
  const fe x9 = fe_mul(fe_sq_n(x6, 3), x3);
  const fe x11 = fe_mul(fe_sq_n(x9, 2), x2);
  const fe x22 = fe_mul(fe_sq_n(x11, 11), x11);
  const fe x44 = fe_mul(fe_sq_n(x22, 22), x22);
  const fe x88 = fe_mul(fe_sq_n(x44, 44), x44);
  const fe x176 = fe_mul(fe_sq_n(x88, 88), x88);
  const fe x220 = fe_mul(fe_sq_n(x176, 44), x44);
  const fe x223 = fe_mul(fe_sq_n(x220, 3), x3);
  fe t = fe_mul(fe_sq_n(x223, 23), x22);
  t = fe_mul(fe_sq_n(t, 6), x2);
  return fe_sq_n(t, 2);
}

// The canonical digits (limbs in [0, 2^26), limb 9 < 2^22) of a carried
// value. Three rounds of (ripple, fold the bits >= 2^256 through
// 2^256 = 2^32 + 977): the first leaves the value in (-2^38, 2^256 +
// 2^38), the second in [0, 2^256), the third only ripples. Then one
// conditional subtraction of p: v >= p iff v + 2^32 + 977 >= 2^256.
CBT_HD fe fe_canon(const fe& f) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = f.v[i];
  for (int round = 0; round < 3; round++) {
    ripple9(h);
    const int64_t top = h[9] >> 22;
    h[9] -= top * ((int64_t)1 << 22);
    h[0] += top * 977;
    h[1] += top * 64;
  }
  int64_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = h[i];
  t[0] += 977;
  t[1] += 64;
  ripple9(t);
  const bool ge_p = (t[9] >> 22) != 0;
  if (ge_p) t[9] -= (int64_t)1 << 22;
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)(ge_p ? t[i] : h[i]);
  return r;
}

CBT_HD bool fe_is_zero(const fe& f) {
  const fe c = fe_canon(f);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) acc |= c.v[i];
  return acc == 0;
}

CBT_HD bool fe_eq(const fe& f, const fe& g) { return fe_is_zero(fe_sub(f, g)); }

CBT_HD int fe_parity(const fe& f) { return fe_canon(f).v[0] & 1; }

// 20 packed 13-bit limbs of a value < 2^256 -> fe (canonical digits)
CBT_HD fe fe_from_packed13(const int32_t* rows, int B, int row0, int col) {
  uint64_t w[5];
  cbt::packed13_words(rows, B, row0, col, w);
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int s = 26 * i, wi = s >> 6, sh = s & 63;
    uint64_t x = w[wi] >> sh;
    if (sh + 26 > 64) x |= w[wi + 1] << (64 - sh);
    r.v[i] = (int32_t)(x & (uint64_t)kM26);
  }
  return r;
}

// ---------------------------------------------------------------------------
// points: homogeneous projective (X : Y : Z), x = X/Z, y = Y/Z on
// y^2 = x^3 + 7; the identity is (0 : 1 : 0). Renes-Costello-Batina
// complete formulas for a = 0 (eprint 2015/1060, algorithms 7 and 9,
// b3 = 3 b = 21): no exceptional inputs, so no branch.
// ---------------------------------------------------------------------------

struct gpt { fe X, Y, Z; };

CBT_HD gpt pt_identity() {
  gpt r;
  r.X = fe_small(0);
  r.Y = fe_small(1);
  r.Z = fe_small(0);
  return r;
}

// algorithm 7: 12M
CBT_HD gpt pt_add(const gpt& p, const gpt& q) {
  fe t0 = fe_mul(p.X, q.X);
  fe t1 = fe_mul(p.Y, q.Y);
  fe t2 = fe_mul(p.Z, q.Z);
  const fe t3 = fe_sub(fe_mul(fe_add(p.X, p.Y), fe_add(q.X, q.Y)),
                       fe_add(t0, t1));                 // X1 Y2 + X2 Y1
  const fe t4 = fe_sub(fe_mul(fe_add(p.Y, p.Z), fe_add(q.Y, q.Z)),
                       fe_add(t1, t2));                 // Y1 Z2 + Y2 Z1
  fe Y3 = fe_sub(fe_mul(fe_add(p.X, p.Z), fe_add(q.X, q.Z)),
                 fe_add(t0, t2));                       // X1 Z2 + X2 Z1
  t0 = fe_mul_small(t0, 3);
  t2 = fe_mul_small(t2, 21);
  fe Z3 = fe_add(t1, t2);
  t1 = fe_sub(t1, t2);
  Y3 = fe_mul_small(Y3, 21);
  gpt r;
  r.X = fe_sub(fe_mul(t3, t1), fe_mul(t4, Y3));
  r.Y = fe_add(fe_mul(t1, Z3), fe_mul(Y3, t0));
  r.Z = fe_add(fe_mul(Z3, t4), fe_mul(t0, t3));
  return r;
}

// algorithm 9: 6M + 2S
CBT_HD gpt pt_dbl(const gpt& p) {
  fe t0 = fe_sq(p.Y);
  fe Z3 = fe_mul_small(t0, 8);
  const fe t1 = fe_mul(p.Y, p.Z);
  fe t2 = fe_mul_small(fe_sq(p.Z), 21);
  const fe X3 = fe_mul(t2, Z3);
  fe Y3 = fe_add(t0, t2);
  Z3 = fe_mul(t1, Z3);
  t2 = fe_mul_small(t2, 3);
  t0 = fe_sub(t0, t2);
  gpt r;
  r.Y = fe_add(X3, fe_mul(t0, Y3));
  r.X = fe_mul_small(fe_mul(fe_mul(p.X, p.Y), t0), 2);
  r.Z = Z3;
  return r;
}

// The ECDSA verdict of column `col` of the packed rows (R, B): 1 iff the
// host precheck passed (flags bit 2), Q = (x, y) decompresses (y =
// (x^3 + 7)^((p+1)/4) squares back, y's parity flipped to flags bit 0),
// and R = [u1]G + [u2]Q has Z != 0 and X = r Z or X = xr2 Z (xr2 = r + N
// when that is below p, else r), with no inversion. `base` is the
// (32 * 256) comb table: entry w * 256 + d is [d * 256^w]G, projective,
// identity rows (0, 1, 0).
CBT_HD int ecdsa_verify_column(const int32_t* rows, int B, int col,
                               const gpt* base) {
  const uint32_t flags = (uint32_t)rows[E_FLAGS * B + col];
  if (((flags >> 2) & 1) == 0) return 0;  // precheck failed or padding

  gpt Q;
  Q.X = fe_from_packed13(rows, B, E_QX, col);
  const fe yy = fe_add(fe_mul(fe_sq(Q.X), Q.X), fe_small(7));
  Q.Y = fe_pow_sqrt(yy);
  if (!fe_eq(fe_sq(Q.Y), yy)) return 0;  // x is not on the curve
  if ((uint32_t)fe_parity(Q.Y) != (flags & 1)) Q.Y = fe_neg(Q.Y);
  Q.Z = fe_small(1);

  // per-signature table [d]Q, d < 16, in local memory
  gpt tbl[16];
  tbl[0] = pt_identity();
  tbl[1] = Q;
  for (int d = 2; d < 16; d++) tbl[d] = pt_add(tbl[d - 1], Q);

  // [u2]Q: Horner over 64 base-16 digits, top digit first
  uint32_t word = (uint32_t)rows[(E_U2 + 7) * B + col];
  gpt acc = tbl[(word >> 28) & 15];
  for (int w = 62; w >= 0; w--) {
    acc = pt_dbl(pt_dbl(pt_dbl(pt_dbl(acc))));
    word = (uint32_t)rows[(E_U2 + (w & 7)) * B + col];
    acc = pt_add(acc, tbl[(word >> (4 * (w >> 3))) & 15]);
  }

  // + [u1]G: 32 width-8 comb windows, one integer gather each
  for (int w = 0; w < 32; w++) {
    word = (uint32_t)rows[(E_U1 + (w & 7)) * B + col];
    acc = pt_add(acc, base[w * 256 + ((word >> (8 * (w >> 3))) & 255)]);
  }

  if (fe_is_zero(acc.Z)) return 0;  // the point at infinity
  const fe xr1z = fe_mul(fe_from_packed13(rows, B, E_XR1, col), acc.Z);
  const fe xr2z = fe_mul(fe_from_packed13(rows, B, E_XR2, col), acc.Z);
  return (fe_eq(acc.X, xr1z) || fe_eq(acc.X, xr2z)) ? 1 : 0;
}

}  // namespace cbt_secp
