// GF(2^255 - 19) and edwards25519 arithmetic for one signature per thread,
// plus the ZIP-215 verdict of one packed column. Shared by the Hopper
// kernel (ed25519_verify.cu) and a host build of the same code that the CPU
// tests compile with g++ (the CBT_HD macro below), so the kernel's
// arithmetic is checked on the host too.
//
// Field elements: ten signed int32 limbs in radix 2^25.5 (the ref10
// layout: limb i has weight 2^ceil(25.5 i), 26 bits at even i, 25 at odd
// i). A limb product fits the card's 32 x 32 -> 64 bit multiply-add, and
// a schoolbook column of ten such products fits int64. Every op returns
// "carried" limbs: |even| <= 2^25, |odd| <= 2^24 + 2^14. fe_mul accepts
// |limb| < 2^26 on both sides; fe_sq needs carried input (its scaled
// operands, up to 76 f_j, must fit int32).
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define CBT_HD __host__ __device__ __forceinline__
#define CBT_HD_NOINLINE __host__ __device__ __noinline__
#else
#define CBT_HD static inline
#define CBT_HD_NOINLINE static
#endif

#ifdef CBT_COUNT_OPS
// host build only: counts field multiplications for the bound in PERF.md
extern "C" long long cbt_fe_mul_count, cbt_fe_sq_count;
#define CBT_COUNT(x) (++(x))
#else
#define CBT_COUNT(x) ((void)0)
#endif

namespace cbt {

// packed-row layout read by the verify (ops/ed25519_fused.py C_*, the
// JAX package's ABI)
enum { C_AY = 0, C_RY = 10, C_S8 = 20, C_H4 = 28, C_FLAGS = 36 };

struct fe { int32_t v[10]; };

CBT_HD fe fe_from_i64(int64_t h[10]) {
  // the ref10 carry chain: rounded carries keep every limb signed and small
  int64_t c;
  const int64_t B25 = (int64_t)1 << 25, B24 = (int64_t)1 << 24;
  c = (h[0] + B25) >> 26; h[1] += c; h[0] -= c * (B25 << 1);
  c = (h[4] + B25) >> 26; h[5] += c; h[4] -= c * (B25 << 1);
  c = (h[1] + B24) >> 25; h[2] += c; h[1] -= c * B25;
  c = (h[5] + B24) >> 25; h[6] += c; h[5] -= c * B25;
  c = (h[2] + B25) >> 26; h[3] += c; h[2] -= c * (B25 << 1);
  c = (h[6] + B25) >> 26; h[7] += c; h[6] -= c * (B25 << 1);
  c = (h[3] + B24) >> 25; h[4] += c; h[3] -= c * B25;
  c = (h[7] + B24) >> 25; h[8] += c; h[7] -= c * B25;
  c = (h[4] + B25) >> 26; h[5] += c; h[4] -= c * (B25 << 1);
  c = (h[8] + B25) >> 26; h[9] += c; h[8] -= c * (B25 << 1);
  c = (h[9] + B24) >> 25; h[0] += c * 19; h[9] -= c * B25;
  c = (h[0] + B25) >> 26; h[1] += c; h[0] -= c * (B25 << 1);
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)h[i];
  return r;
}

CBT_HD fe fe_const(int32_t a0, int32_t a1, int32_t a2, int32_t a3, int32_t a4,
                   int32_t a5, int32_t a6, int32_t a7, int32_t a8, int32_t a9) {
  int64_t h[10] = {a0, a1, a2, a3, a4, a5, a6, a7, a8, a9};
  return fe_from_i64(h);
}

CBT_HD fe fe_zero() { return fe_const(0, 0, 0, 0, 0, 0, 0, 0, 0, 0); }
CBT_HD fe fe_one() { return fe_const(1, 0, 0, 0, 0, 0, 0, 0, 0, 0); }
CBT_HD fe fe_d() {
  return fe_const(56195235, 13857412, 51736253, 6949390, 114729, 24766616,
                  60832955, 30306712, 48412415, 21499315);
}
CBT_HD fe fe_d2() {
  return fe_const(45281625, 27714825, 36363642, 13898781, 229458, 15978800,
                  54557047, 27058993, 29715967, 9444199);
}
CBT_HD fe fe_sqrtm1() {
  return fe_const(34513072, 25610706, 9377949, 3500415, 12389472, 33281959,
                  41962654, 31548777, 326685, 11406482);
}

CBT_HD fe fe_add(const fe& f, const fe& g) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (int64_t)f.v[i] + g.v[i];
  return fe_from_i64(h);
}

CBT_HD fe fe_sub(const fe& f, const fe& g) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (int64_t)f.v[i] - g.v[i];
  return fe_from_i64(h);
}

CBT_HD fe fe_neg(const fe& f) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = -f.v[i];
  return r;
}

// 100 limb products. Weight of f_i g_j: 2^(e_i + e_j) = 2^e_(i+j) times 2
// when i and j are both odd; columns i + j >= 10 wrap with 2^255 = 19.
CBT_HD_NOINLINE fe fe_mul(const fe f, const fe g) {
  CBT_COUNT(cbt_fe_mul_count);
  int32_t g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    g19[i] = 19 * g.v[i];
    f2[i] = 2 * f.v[i];
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const int32_t a = (i & j & 1) ? f2[i] : f.v[i];
      const int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      h[(i + j) % 10] += (int64_t)a * b;
    }
  }
  return fe_from_i64(h);
}

// 55 limb products: f_i f_j (i < j) counted twice, same weights as fe_mul.
CBT_HD_NOINLINE fe fe_sq(const fe f) {
  CBT_COUNT(cbt_fe_sq_count);
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      const int32_t coef = (i == j ? 1 : 2) * ((i & j & 1) ? 2 : 1) *
                           (i + j >= 10 ? 19 : 1);
      h[(i + j) % 10] += (int64_t)f.v[i] * (int32_t)(coef * f.v[j]);
    }
  }
  return fe_from_i64(h);
}

CBT_HD fe fe_sq_n(fe f, int n) {
  for (int i = 0; i < n; i++) f = fe_sq(f);
  return f;
}

// z^((p - 5) / 8) = z^(2^252 - 3), the ref10 addition chain
CBT_HD fe fe_pow22523(const fe& z) {
  fe z2 = fe_sq(z);
  fe z9 = fe_mul(z, fe_sq_n(z2, 2));
  fe z11 = fe_mul(z2, z9);
  fe z_5_0 = fe_mul(z9, fe_sq(z11));
  fe z_10_0 = fe_mul(fe_sq_n(z_5_0, 5), z_5_0);
  fe z_20_0 = fe_mul(fe_sq_n(z_10_0, 10), z_10_0);
  fe z_40_0 = fe_mul(fe_sq_n(z_20_0, 20), z_20_0);
  fe z_50_0 = fe_mul(fe_sq_n(z_40_0, 10), z_10_0);
  fe z_100_0 = fe_mul(fe_sq_n(z_50_0, 50), z_50_0);
  fe z_200_0 = fe_mul(fe_sq_n(z_100_0, 100), z_100_0);
  fe z_250_0 = fe_mul(fe_sq_n(z_200_0, 50), z_50_0);
  return fe_mul(fe_sq_n(z_250_0, 2), z);
}

// z^(p - 2) = z^(2^255 - 21), the ref10 inversion chain (0 maps to 0)
CBT_HD fe fe_invert(const fe& z) {
  fe z2 = fe_sq(z);
  fe z9 = fe_mul(z, fe_sq_n(z2, 2));
  fe z11 = fe_mul(z2, z9);
  fe z_5_0 = fe_mul(z9, fe_sq(z11));
  fe z_10_0 = fe_mul(fe_sq_n(z_5_0, 5), z_5_0);
  fe z_20_0 = fe_mul(fe_sq_n(z_10_0, 10), z_10_0);
  fe z_40_0 = fe_mul(fe_sq_n(z_20_0, 20), z_20_0);
  fe z_50_0 = fe_mul(fe_sq_n(z_40_0, 10), z_10_0);
  fe z_100_0 = fe_mul(fe_sq_n(z_50_0, 50), z_50_0);
  fe z_200_0 = fe_mul(fe_sq_n(z_100_0, 100), z_100_0);
  fe z_250_0 = fe_mul(fe_sq_n(z_200_0, 50), z_50_0);
  return fe_mul(fe_sq_n(z_250_0, 5), z11);
}

// Canonical limbs of a carried value (ref10 fe_tobytes before packing):
// q = floor(h / p) in {0, 1}, then h - q p with exact carries.
CBT_HD fe fe_canon(const fe& f) {
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = f.v[i];
  int32_t q = (19 * h[9] + ((int32_t)1 << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < 10; i++) q = (h[i] + q) >> ((i & 1) ? 25 : 26);
  h[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int s = (i & 1) ? 25 : 26;
    const int32_t c = h[i] >> s;
    h[i + 1] += c;
    h[i] -= (int32_t)((uint32_t)c << s);
  }
  h[9] -= (int32_t)((uint32_t)(h[9] >> 25) << 25);
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = h[i];
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

// ---------------------------------------------------------------------------
// points: extended (X:Y:Z:T), cached (Y+X, Y-X, Z, 2dT), affine niels
// (y+x, y-x, 2dxy) for the base comb
// ---------------------------------------------------------------------------

struct ge_p3 { fe X, Y, Z, T; };
struct ge_cached { fe YpX, YmX, Z, T2d; };
struct ge_niels { fe ypx, ymx, xy2d; };

CBT_HD ge_p3 ge_identity() {
  ge_p3 r;
  r.X = fe_zero(); r.Y = fe_one(); r.Z = fe_one(); r.T = fe_zero();
  return r;
}

CBT_HD ge_cached ge_to_cached(const ge_p3& p) {
  ge_cached c;
  c.YpX = fe_add(p.Y, p.X);
  c.YmX = fe_sub(p.Y, p.X);
  c.Z = p.Z;
  c.T2d = fe_mul(p.T, fe_d2());
  return c;
}

CBT_HD ge_cached ge_cached_neg(const ge_cached& c) {
  ge_cached r;
  r.YpX = c.YmX; r.YmX = c.YpX; r.Z = c.Z; r.T2d = fe_neg(c.T2d);
  return r;
}

// unified add-2008-hwcd-3 (a = -1), 8M with the cached operand
CBT_HD ge_p3 ge_add(const ge_p3& p, const ge_cached& q) {
  const fe A = fe_mul(fe_sub(p.Y, p.X), q.YmX);
  const fe B = fe_mul(fe_add(p.Y, p.X), q.YpX);
  const fe C = fe_mul(p.T, q.T2d);
  const fe D = fe_mul(p.Z, q.Z);
  const fe D2 = fe_add(D, D);
  const fe E = fe_sub(B, A), F = fe_sub(D2, C), G = fe_add(D2, C),
           H = fe_add(B, A);
  ge_p3 r;
  r.X = fe_mul(E, F); r.Y = fe_mul(G, H); r.Z = fe_mul(F, G); r.T = fe_mul(E, H);
  return r;
}

// mixed add with an affine niels point (Z2 = 1), 7M
CBT_HD ge_p3 ge_madd(const ge_p3& p, const ge_niels& q) {
  const fe A = fe_mul(fe_sub(p.Y, p.X), q.ymx);
  const fe B = fe_mul(fe_add(p.Y, p.X), q.ypx);
  const fe C = fe_mul(p.T, q.xy2d);
  const fe D2 = fe_add(p.Z, p.Z);
  const fe E = fe_sub(B, A), F = fe_sub(D2, C), G = fe_add(D2, C),
           H = fe_add(B, A);
  ge_p3 r;
  r.X = fe_mul(E, F); r.Y = fe_mul(G, H); r.Z = fe_mul(F, G); r.T = fe_mul(E, H);
  return r;
}

// dbl-2008-hwcd: 4S + 3M without T (with_t = false: the next op is another
// doubling, which never reads T), 4S + 4M with it
CBT_HD ge_p3 ge_dbl(const ge_p3& p, bool with_t) {
  const fe A = fe_sq(p.X), B = fe_sq(p.Y);
  const fe Z2 = fe_sq(p.Z);
  const fe C = fe_add(Z2, Z2);
  const fe H = fe_add(A, B);
  const fe E = fe_sub(H, fe_sq(fe_add(p.X, p.Y)));
  const fe G = fe_sub(A, B);
  const fe F = fe_add(C, G);
  ge_p3 r;
  r.X = fe_mul(E, F); r.Y = fe_mul(G, H); r.Z = fe_mul(F, G);
  r.T = with_t ? fe_mul(E, H) : fe_zero();
  return r;
}

// ZIP-215 decompression: y is the low 255 bits of the encoding, unreduced
// (y >= p is accepted); for x = 0 with the sign bit set the flip gives
// -0 = 0. Mirrors ed25519_ref.pt_decompress(zip215=True).
CBT_HD bool ge_decompress(const fe& y, int sign, ge_p3* out) {
  const fe one = fe_one();
  const fe yy = fe_sq(y);
  const fe u = fe_sub(yy, one);
  const fe v = fe_add(fe_mul(yy, fe_d()), one);
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  fe r = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
  const fe check = fe_mul(v, fe_sq(r));
  const bool is_pos = fe_eq(check, u);
  const bool is_neg = fe_is_zero(fe_add(check, u));
  if (is_neg) r = fe_mul(r, fe_sqrtm1());
  if (fe_parity(r) != sign) r = fe_neg(r);
  out->X = r;
  out->Y = y;
  out->Z = one;
  out->T = fe_mul(r, y);
  return is_pos || is_neg;
}

// a value < 2^255 held as little-endian 64-bit words (w[4] = 0) -> fe
CBT_HD fe fe_from_words(const uint64_t w[5]) {
  int64_t h[10];
  const int e[11] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230, 255};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int s = e[i], n = e[i + 1] - e[i], wi = s >> 6, sh = s & 63;
    uint64_t x = w[wi] >> sh;
    if (sh + n > 64) x |= w[wi + 1] << (64 - sh);
    h[i] = (int64_t)(x & ((1ull << n) - 1));
  }
  return fe_from_i64(h);
}

// 20 packed 13-bit limbs (word k = limb k | limb k+10 << 13) of column
// `col` -> the 260-bit value as little-endian 64-bit words
CBT_HD void packed13_words(const int32_t* rows, int B, int row0, int col,
                           uint64_t w[5]) {
#pragma unroll
  for (int k = 0; k < 5; k++) w[k] = 0;
#pragma unroll
  for (int k = 0; k < 10; k++) {
    const uint32_t word = (uint32_t)rows[(row0 + k) * B + col];
#pragma unroll
    for (int half = 0; half < 2; half++) {
      const int limb = k + 10 * half;
      const uint64_t l = (word >> (13 * half)) & 0x1fffu;
      const int bit = 13 * limb, wi = bit >> 6, sh = bit & 63;
      w[wi] |= l << sh;
      if (sh > 51) w[wi + 1] |= l >> (64 - sh);
    }
  }
}

// the low 255 bits of 20 packed 13-bit limbs -> fe
CBT_HD fe fe_from_packed13(const int32_t* rows, int B, int row0, int col) {
  uint64_t w[5];
  packed13_words(rows, B, row0, col, w);
  return fe_from_words(w);
}

// the low 255 bits of a 32-byte little-endian encoding, unreduced -> fe
CBT_HD fe fe_from_bytes(const uint8_t* s) {
  uint64_t w[5] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 32; k++) w[k >> 3] |= (uint64_t)s[k] << (8 * (k & 7));
  w[3] &= 0x7fffffffffffffffull;
  return fe_from_words(w);
}

// [s]B + [h](-A) for column `col` of the packed rows: s from the C_S8
// byte digits, h from the C_H4 nibble digits. `base` is the (32 * 256)
// niels comb table: entry w * 256 + d is [d * 256^w]B. Shared by the
// ed25519 and sr25519 verdicts.
CBT_HD ge_p3 sb_minus_ha(const int32_t* rows, int B, int col, const ge_p3& A,
                         const ge_niels* base) {
  // per-signature table [d](-A), d < 16, in cached form
  ge_p3 negA = A;
  negA.X = fe_neg(A.X);
  negA.T = fe_neg(A.T);
  ge_cached tbl[16];
  tbl[0].YpX = fe_one(); tbl[0].YmX = fe_one(); tbl[0].Z = fe_one();
  tbl[0].T2d = fe_zero();
  tbl[1] = ge_to_cached(negA);
  ge_p3 m = negA;
  for (int d = 2; d < 16; d++) {
    m = ge_add(m, tbl[1]);
    tbl[d] = ge_to_cached(m);
  }

  // [h](-A): Horner over 64 base-16 digits, top digit first
  ge_p3 acc = ge_identity();
  for (int w = 63; w >= 0; w--) {
    if (w != 63) {
      acc = ge_dbl(acc, false);
      acc = ge_dbl(acc, false);
      acc = ge_dbl(acc, false);
      acc = ge_dbl(acc, true);
    }
    const uint32_t word = (uint32_t)rows[(C_H4 + (w & 7)) * B + col];
    acc = ge_add(acc, tbl[(word >> (4 * (w >> 3))) & 15]);
  }

  // + [s]B: 32 width-8 comb windows, one integer gather each
  for (int w = 0; w < 32; w++) {
    const uint32_t word = (uint32_t)rows[(C_S8 + (w & 7)) * B + col];
    acc = ge_madd(acc, base[w * 256 + ((word >> (8 * (w >> 3))) & 255)]);
  }
  return acc;
}

// The verdict of column `col` of the packed rows (R, B): 1 iff
// [8]([s]B + [h](-A) - R) is the identity, A and R decode, and the host
// precheck (lengths, S < L) passed.
CBT_HD int verify_column(const int32_t* rows, int B, int col,
                         const ge_niels* base) {
  const uint32_t flags = (uint32_t)rows[C_FLAGS * B + col];
  if (((flags >> 2) & 1) == 0) return 0;  // precheck failed or padding

  ge_p3 A, R;
  const bool ok_a =
      ge_decompress(fe_from_packed13(rows, B, C_AY, col), flags & 1, &A);
  const bool ok_r = ge_decompress(fe_from_packed13(rows, B, C_RY, col),
                                  (flags >> 1) & 1, &R);
  if (!(ok_a && ok_r)) return 0;

  ge_p3 acc = sb_minus_ha(rows, B, col, A, base);

  // - R, then the cofactor: [8]W == identity <=> X == 0 and Y == Z
  acc = ge_add(acc, ge_cached_neg(ge_to_cached(R)));
  acc = ge_dbl(acc, false);
  acc = ge_dbl(acc, false);
  acc = ge_dbl(acc, false);
  return (fe_is_zero(acc.X) && fe_eq(acc.Y, acc.Z)) ? 1 : 0;
}

}  // namespace cbt
