// Device sign-bytes stamping for one packed column: the per-thread program
// of the stamp_rows kernel (stamp_rows.cu), also compiled for the host by
// ed25519_host.cpp so the CPU tests check it against the plain version.
//
// From one row's deltas (64 signature bytes, the timestamp as three int32
// words, the flags word), the stamp template of its height and the row's
// validator key, it writes the column of the cached packed rows that
// ops/ed25519_cached.py `pack_rows_cached` builds from a host pack of the
// same vote: the canonical vote sign-bytes (LEB128 timestamp varints with
// proto3 zero-skip, outer length prefix), h = SHA-512(R || A || msg) mod L
// as 64 nibbles, R's 13-bit limbs, s's bytes, and the flags word
// rsign | precheck << 1 | counted << 2 | commit_id << 3. The general column
// (stamp_column_general, the stamp_rows_general kernel) hashes the same
// sign-bytes with the row's own key and writes the layout of
// ops/ed25519_fused.py `pack_rows` instead: the key's limbs as well, the
// flags asign | rsign << 1 | precheck << 2 | counted << 3, the power's limbs
// and the commit id. The two layouts conflict, so each has its own column
// writer over the shared helpers.
//
// The program works on words. Each 128-byte SHA block is staged as 16
// big-endian 64-bit words in a per-thread slice (shared memory on the
// card), each message segment funnel-shifted into the words it overlaps:
// R || A, then, at offsets that depend on the row, the outer varint, the
// template's prefix (read as aligned words), the timestamp field (its tag,
// its length and the two tagged varints, packed into three words with
// shifts), the template's suffix and the padding. The words are read back
// at constant indices into registers for the compression, whose ring
// indices are constants too, and ref10's mod-L reduction cuts its 21-bit
// limbs straight from the digest words. No array is indexed by a value
// known only at run time, so nothing lives in local memory.
#pragma once
#include <stddef.h>
#include <stdint.h>
#if !defined(__CUDA_ARCH__)
#include <string.h>
#endif

#if defined(__CUDACC__)
#define CBT_D __device__ __forceinline__
#define CBT_CONST __device__ __constant__
#else
#define CBT_D static inline
#define CBT_CONST static const
#endif

#ifdef CBT_COUNT_OPS
// host build only: counts SHA-512 compressions for the bound in PERF.md
extern "C" long long cbt_sha_block_count;
#define CBT_COUNT_BLOCK() (++cbt_sha_block_count)
#else
#define CBT_COUNT_BLOCK() ((void)0)
#endif

namespace cbt_stamp {

// the cached layout (ops/ed25519_cached.py V_*) and the general one
// (ops/ed25519_fused.py C_*)
enum { V_RY = 0, V_S8 = 10, V_H4 = 18, V_FLAGS = 26, V_THRESH = 27 };
enum {
  C_AY = 0, C_RY = 10, C_S8 = 20, C_H4 = 28, C_FLAGS = 36, C_POW = 37,
  C_CID = 40, C_THRESH = 41
};

CBT_CONST uint64_t kSha512K[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
};

CBT_CONST uint64_t kSha512H0[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull,
    0xa54ff53a5f1d36f1ull, 0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull,
};

// L = 2^252 + 27742317777372353535851937790883648493, little-endian words
CBT_CONST uint32_t kLWords[8] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u,
                                 0x14def9deu, 0u, 0u, 0u, 0x10000000u};

// ---- word primitives (one instruction each on the card) ------------------

CBT_D uint32_t bswap32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

CBT_D uint64_t bswap64(uint64_t x) {
  return ((uint64_t)bswap32((uint32_t)x) << 32) | bswap32((uint32_t)(x >> 32));
}

// byte k of the result is byte (s >> 4k) & 7 of the pair b:a (PRMT)
CBT_D uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(a, b, s);
#else
  const uint64_t ab = ((uint64_t)b << 32) | a;
  uint32_t r = 0;
  for (int k = 0; k < 4; k++)
    r |= (uint32_t)((ab >> (8 * ((s >> (4 * k)) & 7))) & 0xff) << (8 * k);
  return r;
#endif
}

// the low word of (hi:lo) >> n, 0 <= n < 32 (SHF)
CBT_D uint32_t fshr(uint32_t lo, uint32_t hi, int n) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, n);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> n);
#endif
}

CBT_D int clz64(uint64_t x) {
#if defined(__CUDA_ARCH__)
  return __clzll((long long)x);
#else
  return x ? __builtin_clzll(x) : 64;
#endif
}

// rotate right by a constant 0 < n < 64, n != 32: two funnel shifts
CBT_D uint64_t rotr64(uint64_t x, int n) {
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  if (n > 32) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
    n -= 32;
  }
  return ((uint64_t)fshr(hi, lo, n) << 32) | fshr(lo, hi, n);
}

// 16 bytes at p (16-byte aligned on the card) as four little-endian words
CBT_D void load16(const uint8_t* p, uint32_t* v) {
#if defined(__CUDA_ARCH__)
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
#else
  memcpy(v, p, 16);
#endif
}

// 8 bytes at p (8-byte aligned on the card) as one big-endian word
CBT_D uint64_t load_be64(const uint8_t* p) {
#if defined(__CUDA_ARCH__)
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  return ((uint64_t)bswap32(q.x) << 32) | bswap32(q.y);
#else
  uint64_t x;
  memcpy(&x, p, 8);
  return bswap64(x);
#endif
}

// ---- SHA-512 --------------------------------------------------------------

// One compression of the 16 big-endian words w into the state h; w is the
// schedule's ring. Inlined, with 16 rounds unrolled in a loop of five, so
// every ring index is a constant and h, w and the working words stay in
// registers. (All 80 rounds unrolled ran slower on an H100: its code
// outgrew the instruction cache.)
CBT_D void sha512_compress(uint64_t* h, uint64_t* w) {
  CBT_COUNT_BLOCK();
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll 1
  for (int r = 0; r < 80; r += 16) {
#pragma unroll
    for (int i = 0; i < 16; i++) {
      if (r > 0) {
        const uint64_t w15 = w[(i + 1) & 15], w2 = w[(i + 14) & 15];
        const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
        const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
        w[i] += s0 + w[(i + 9) & 15] + s1;
      }
      const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
      const uint64_t ch = (e & f) ^ (~e & g);
      const uint64_t t1 = hh + S1 + ch + kSha512K[r + i] + w[i];
      const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
      const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
      hh = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = b;
      b = a;
      a = t1 + S0 + maj;
    }
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

// ---- the message, a word at a time ---------------------------------------

// LEB128 of x as little-endian packed bytes (bytes 0-7 in lo, 8-9 in hi),
// spread from 7-bit groups with three shift-and-mask steps; returns the
// byte count, 1 to 10 (a negative value sign-extended to 64 bits takes 10)
CBT_D int leb128(uint64_t x, uint64_t& lo, uint64_t& hi) {
  const int bits = 64 - clz64(x);
  const int n = bits ? (bits + 6) / 7 : 1;
  uint64_t t = x & 0x00ffffffffffffffull;
  t = (t & 0x000000000fffffffull) | ((t & 0x00fffffff0000000ull) << 4);
  t = (t & 0x00003fff00003fffull) | ((t & 0x0fffc0000fffc000ull) << 2);
  t = (t & 0x007f007f007f007full) | ((t & 0x3f803f803f803f80ull) << 1);
  const uint64_t u = x >> 56;
  const int c = n - 1;  // bytes that carry the continuation bit
  const uint64_t cont = 0x8080808080808080ull;
  lo = t | (c >= 8 ? cont : cont & ((1ull << (8 * c)) - 1));
  hi = (u & 0x7f) | ((u & 0x80) << 1) | (c == 9 ? 0x80u : 0u);
  return n;
}

// m (192 bits, little-endian words) |= (v1:v0) << sh, for 0 <= sh < 128
// and a result below 2^192
CBT_D void or_shifted(uint64_t* m, uint64_t v0, uint64_t v1, int sh) {
  const int r = sh & 63;
  const uint64_t s0 = v0 << r;
  const uint64_t s1 = r ? (v1 << r) | (v0 >> (64 - r)) : v1;
  const uint64_t s2 = r ? v1 >> (64 - r) : 0;
  if (sh < 64) {
    m[0] |= s0;
    m[1] |= s1;
    m[2] |= s2;
  } else {
    m[1] |= s0;
    m[2] |= s1;
  }
}

// bytes d .. d+7 of a segment, given its big-endian words a (bytes
// 8(d>>3) ..) and b (the next 8)
CBT_D uint64_t funnel_bytes(uint64_t a, uint64_t b, int d) {
  const int r = 8 * (d & 7);
  return r ? (a << r) | (b >> (64 - r)) : a;
}

// big-endian word i of the n bytes at p, 0 outside them
CBT_D uint64_t row_word(const uint8_t* p, int n, int i) {
  const int left = n - 8 * i;
  if (i < 0 || left <= 0) return 0;
  const uint64_t w = load_be64(p + 8 * i);
  return left >= 8 ? w : w & (~0ull << (64 - 8 * left));
}

// word u of a stream that holds the n bytes at p from byte `at` on
CBT_D uint64_t place_row(const uint8_t* p, int n, int at, int u) {
  const int d = 8 * u - at;
  if (d <= -8 || d >= n) return 0;
  const int i = d >> 3;
  return funnel_bytes(row_word(p, n, i), row_word(p, n, i + 1), d);
}

// the same for a segment held in three big-endian words m (zero past it)
CBT_D uint64_t reg_word(const uint64_t* m, int i) {
  return i == 0 ? m[0] : i == 1 ? m[1] : i == 2 ? m[2] : 0;
}

CBT_D uint64_t place_reg(const uint64_t* m, int n, int at, int u) {
  const int d = 8 * u - at;
  if (d <= -8 || d >= n) return 0;
  const int i = d >> 3;
  return funnel_bytes(reg_word(m, i), reg_word(m, i + 1), d);
}

// One row's sign-bytes as placed segments, offsets counted from the end of
// R || A: the outer varint at 0, the prefix, the timestamp field (tag,
// length, 0x08 secs varint, 0x10 nanos varint), the suffix, then 0x80.
struct Msg {
  uint64_t ob;  // the outer varint, big-endian from the word's first byte
  const uint8_t* pre;
  int pl, at_pre;
  uint64_t mid[3];  // the timestamp field, big-endian
  int ml, at_mid;
  const uint8_t* suf;
  int xl, at_suf;
  int at_pad;
};

CBT_D int imax(int a, int b) { return a > b ? a : b; }
CBT_D int imin(int a, int b) { return a < b ? a : b; }

// Stages block j of the row's padded message as 16 big-endian words in the
// thread's slice (word k at blk[k * stride]; on the card, shared memory
// with one column a thread). Message word u (counted after R || A) is
// block word u + 8 - 16 j. Each segment writes only the words it
// overlaps; the words are read back at constant indices.
CBT_D void stage_block(const Msg& m, int j, int nblk, int total,
                       const uint8_t* sg, const uint8_t* key, uint64_t* blk,
                       int stride) {
#pragma unroll
  for (int k = 0; k < 16; k++) blk[k * stride] = 0;
  if (j == 0) {  // R || A
    uint32_t ra[16];
    load16(sg, ra);
    load16(sg + 16, ra + 4);
    load16(key, ra + 8);
    load16(key + 16, ra + 12);
#pragma unroll
    for (int k = 0; k < 8; k++)
      blk[k * stride] =
          ((uint64_t)bswap32(ra[2 * k]) << 32) | bswap32(ra[2 * k + 1]);
  }
  const int u0 = 16 * j - 8, lo = imax(u0, 0), hi = u0 + 16;
  // the outer varint and the prefix, which starts 1 to 5 bytes in
  const int pre_end = imin(hi, (m.at_mid + 7) >> 3);
  uint64_t prev = row_word(m.pre, m.pl, lo - 1);
  for (int u = lo; u < pre_end; u++) {
    const uint64_t cur = row_word(m.pre, m.pl, u);
    blk[(u - u0) * stride] =
        funnel_bytes(prev, cur, 8 - m.at_pre) | (u == 0 ? m.ob : 0);
    prev = cur;
  }
  const int mid_end = imin(hi, (m.at_mid + m.ml + 7) >> 3);
  for (int u = imax(lo, m.at_mid >> 3); u < mid_end; u++)
    blk[(u - u0) * stride] |= place_reg(m.mid, m.ml, m.at_mid, u);
  const int suf_end = imin(hi, (m.at_suf + m.xl + 7) >> 3);
  for (int u = imax(lo, m.at_suf >> 3); u < suf_end; u++)
    blk[(u - u0) * stride] |= place_row(m.suf, m.xl, m.at_suf, u);
  const int up = m.at_pad >> 3;
  if (up >= lo && up < hi)
    blk[(up - u0) * stride] |= 0x80ull << (56 - 8 * (m.at_pad & 7));
  if (j == nblk - 1) blk[15 * stride] = (uint64_t)total * 8;
}

// ---- the mod-L reduction --------------------------------------------------

// ref10 sc_reduce: 2^252 = -c (mod L) with -c = 666643 + 470296 2^21 +
// 654183 2^42 - 997805 2^63 + 136657 2^84 - 683901 2^105; the folds and
// carries run in ref10's order, which keeps every int64 in range.
CBT_D void sc_fold(int64_t* s, int i) {
  const int64_t v = s[i];
  s[i - 12] += v * 666643;
  s[i - 11] += v * 470296;
  s[i - 10] += v * 654183;
  s[i - 9] -= v * 997805;
  s[i - 8] += v * 136657;
  s[i - 7] -= v * 683901;
  s[i] = 0;
}

CBT_D void sc_carry_round(int64_t* s, int i) {
  const int64_t c = (s[i] + ((int64_t)1 << 20)) >> 21;
  s[i + 1] += c;
  s[i] -= c * ((int64_t)1 << 21);
}

CBT_D void sc_carry_floor(int64_t* s, int i) {
  const int64_t c = s[i] >> 21;
  s[i + 1] += c;
  s[i] -= c * ((int64_t)1 << 21);
}

// The SHA-512 state h (the digest's big-endian words; the digest read as a
// little-endian integer) -> (digest mod L) as eight little-endian words,
// from the low 21 bits of each of ref10's twelve limbs, the bits the
// plain version's nibbles read.
CBT_D void sc_reduce_digest(const uint64_t* h, uint32_t* out) {
  uint64_t le[8];
#pragma unroll
  for (int i = 0; i < 8; i++) le[i] = bswap64(h[i]);
  int64_t s[24];
#pragma unroll
  for (int i = 0; i < 23; i++) {
    const int p = 21 * i, q = p >> 6, r = p & 63;
    uint64_t x = le[q] >> r;
    if (r > 43) x |= le[q + 1] << (64 - r);
    s[i] = (int64_t)(x & 0x1fffff);
  }
  s[23] = (int64_t)(le[7] >> 35);
#pragma unroll
  for (int i = 23; i >= 18; i--) sc_fold(s, i);
#pragma unroll
  for (int i = 6; i <= 16; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 7; i <= 15; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 17; i >= 12; i--) sc_fold(s, i);
#pragma unroll
  for (int i = 0; i <= 10; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 1; i <= 11; i += 2) sc_carry_round(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i <= 11; i++) sc_carry_floor(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i <= 10; i++) sc_carry_floor(s, i);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
      const int sh = 21 * i - 32 * k;
      const uint64_t l = (uint64_t)s[i] & 0x1fffff;
      if (sh > -21 && sh < 32)
        v |= sh >= 0 ? (uint32_t)(l << sh) : (uint32_t)(l >> -sh);
    }
    out[k] = v;
  }
}

// ---- the column -----------------------------------------------------------

struct StampTemplate {
  const uint8_t* pre;      // (n_sites, pm) prefix bytes
  const int32_t* pre_len;  // (n_sites,)
  const uint8_t* suf;      // (n_sites, sm) suffix bytes
  const int32_t* suf_len;  // (n_sites,)
  const int32_t* ts_tag;   // (n_sites,)
  int pm, sm, n_sites;
};

// The template row of a flags word (bits 2..9); out-of-range rows clamp to
// the last site, as XLA's gathers do.
CBT_D int template_row(int32_t fl, const StampTemplate& tp) {
  const int t = (fl >> 2) & 0xff;
  return t < tp.n_sites ? t : tp.n_sites - 1;
}

// h = SHA-512(R || A || msg) mod L of one row, as eight little-endian
// words: msg is the sign-bytes of template row t with the row's timestamp
// words tw = [secs_lo, secs_hi, nanos]. sg holds R || S and key A; blk is
// the thread's slice for one staged block (16 words, stride apart). On the
// card sg and key are 16-byte aligned, the template rows 8-byte aligned.
CBT_D void row_digest(const uint8_t* sg, const uint8_t* key,
                      const int32_t* tw, const StampTemplate& tp, int t,
                      uint64_t* blk, int stride, uint32_t* hw) {
  const uint64_t secs =
      (uint64_t)(uint32_t)tw[0] | ((uint64_t)(uint32_t)tw[1] << 32);
  const uint64_t nanos = (uint64_t)(int64_t)tw[2];
  uint64_t slo, shi, nlo, nhi, olo, ohi;
  const int sl = leb128(secs, slo, shi), nl = leb128(nanos, nlo, nhi);
  const int l1 = secs ? sl + 1 : 0, l2 = nanos ? nl + 1 : 0;
  Msg m;
  m.pl = tp.pre_len[t];
  m.xl = tp.suf_len[t];
  m.ml = 2 + l1 + l2;
  const int ol = leb128((uint64_t)(m.pl + m.ml + m.xl), olo, ohi);
  m.ob = bswap64(olo);
  m.pre = tp.pre + (size_t)t * tp.pm;
  m.suf = tp.suf + (size_t)t * tp.sm;
  m.at_pre = ol;
  m.at_mid = ol + m.pl;
  m.at_suf = m.at_mid + m.ml;
  m.at_pad = m.at_suf + m.xl;
  // the timestamp field, little-endian: tag, length, then each tagged
  // varint that is not zero
  uint64_t mid[3] = {((uint64_t)tp.ts_tag[t] & 0xff) |
                         ((uint64_t)(l1 + l2) << 8),
                     0, 0};
  if (secs) or_shifted(mid, 0x08 | (slo << 8), (slo >> 56) | (shi << 8), 16);
  if (nanos)
    or_shifted(mid, 0x10 | (nlo << 8), (nlo >> 56) | (nhi << 8),
               8 * (2 + l1));
#pragma unroll
  for (int i = 0; i < 3; i++) m.mid[i] = bswap64(mid[i]);

  const int total = 64 + m.at_pad;
  const int nblk = (total + 17 + 127) >> 7;
  uint64_t h[8];
#pragma unroll
  for (int k = 0; k < 8; k++) h[k] = kSha512H0[k];
  for (int j = 0; j < nblk; j++) {
    stage_block(m, j, nblk, total, sg, key, blk, stride);
    uint64_t w[16];
#pragma unroll
    for (int k = 0; k < 16; k++) w[k] = blk[k * stride];
    sha512_compress(h, w);
  }
  sc_reduce_digest(h, hw);
}

// A point encoding's y (its eight little-endian words w, the top bit
// dropped) as 20 13-bit limbs, two a word: word i = limb i | limb i+10 << 13.
CBT_D void limb_pairs(const uint32_t* w, uint32_t* out) {
  uint32_t rw[9];
#pragma unroll
  for (int k = 0; k < 8; k++) rw[k] = w[k];
  rw[7] &= 0x7fffffffu;
  rw[8] = 0;
  uint32_t rl[20];
#pragma unroll
  for (int i = 0; i < 20; i++) {
    const int q = (13 * i) >> 5, r = (13 * i) & 31;
    rl[i] = fshr(rw[q], rw[q + 1], r) & 0x1fffu;
  }
#pragma unroll
  for (int i = 0; i < 10; i++) out[i] = rl[i] | (rl[i + 10] << 13);
}

// The digit rows of S (eight little-endian words sw) and of h: s8 row j
// holds bytes j, 8 + j, 16 + j, 24 + j of S; h4 row j nibbles j, 8 + j, ...,
// 56 + j of h.
CBT_D void digit_rows(const uint32_t* sw, const uint32_t* hw, uint32_t* s8,
                      uint32_t* h4) {
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const int q = j >> 2;
    const uint32_t sel = (uint32_t)(j & 3) | ((uint32_t)(4 + (j & 3)) << 4);
    s8[j] = prmt(prmt(sw[q], sw[q + 2], sel), prmt(sw[q + 4], sw[q + 6], sel),
                 0x5410);
    uint32_t d = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) d |= ((hw[k] >> (4 * j)) & 15u) << (4 * k);
    h4[j] = d;
  }
}

// precheck: S < L, the borrow out of S - L
CBT_D uint32_t s_below_l(const uint32_t* sw) {
  int64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; k++)
    borrow = ((int64_t)sw[k] - (int64_t)kLWords[k] + borrow) >> 32;
  return (uint32_t)(borrow & 1);
}

// The threshold rows of column b: threshold word k of the n_thr flat words
// sits at column k mod B of row k / B, from out (the first threshold row) on.
CBT_D void threshold_rows(int b, int B, const int32_t* thr, int n_thr,
                          int t_rows, int32_t* out) {
  for (int r = 0; r < t_rows; r++) {
    const size_t k = (size_t)r * B + b;
    out[k] = k < (size_t)n_thr ? thr[k] : 0;
  }
}

// Column b of the (V_THRESH + t_rows, B) cached packed rows. sig (B, 64)
// uint8, ts (B, 3) int32 [secs_lo, secs_hi, nanos], flags (B,) int32 with
// bit 0 = live, bit 1 = counted, bits 2..9 = template row, bits 10.. =
// commit id; pub_raw (M, 32) uint8 (column b is validator b mod M); thr:
// n_thr int32 threshold words laid flat over the rows from V_THRESH on. A
// dead lane (live = 0) gives an all-zero head and reads no key. blk is the
// thread's slice for one staged block (16 words, stride apart). On the card
// sig and pub_raw are 16-byte aligned, the template rows 8-byte aligned.
CBT_D void stamp_column(int b, int B, const uint8_t* sig, const int32_t* ts,
                        const int32_t* flags, const StampTemplate& tp,
                        const uint8_t* pub_raw, int M, const int32_t* thr,
                        int n_thr, int t_rows, int32_t* out, uint64_t* blk,
                        int stride) {
  uint32_t head[V_THRESH];
#pragma unroll
  for (int r = 0; r < V_THRESH; r++) head[r] = 0;
  const int32_t fl = flags[b];
  if (fl & 1) {
    const uint8_t* sg = sig + (size_t)b * 64;
    uint32_t hw[8];
    row_digest(sg, pub_raw + (size_t)(b % M) * 32, ts + 3 * b, tp,
               template_row(fl, tp), blk, stride, hw);
    uint32_t sw[16];  // R = sw[0..7], S = sw[8..15], little-endian words
#pragma unroll
    for (int k = 0; k < 4; k++) load16(sg + 16 * k, sw + 4 * k);
    limb_pairs(sw, head + V_RY);
    digit_rows(sw + 8, hw, head + V_S8, head + V_H4);
    head[V_FLAGS] = (sw[7] >> 31) | (s_below_l(sw + 8) << 1) |
                    ((uint32_t)((fl >> 1) & 1) << 2) |
                    ((uint32_t)(fl >> 10) << 3);
  }
#pragma unroll
  for (int r = 0; r < V_THRESH; r++) out[(size_t)r * B + b] = (int32_t)head[r];
  threshold_rows(b, B, thr, n_thr, t_rows, out + (size_t)V_THRESH * B);
}

// Column b of the (C_THRESH + t_rows, B) general packed rows, the layout
// ops/ed25519_fused.py `pack_rows` builds from a host pack: each row carries
// its key's limbs, its power and its commit id. sig (B, 64) and key (B, 32)
// uint8 (both 16-byte aligned on the card), ts and flags as stamp_column's,
// power (B,) int64, non-negative. A dead lane (live = 0) gives zero rows but
// its commit id, the padding's sink, and reads nothing else.
CBT_D void stamp_column_general(int b, int B, const uint8_t* sig,
                                const uint8_t* key, const int32_t* ts,
                                const int32_t* flags, const int64_t* power,
                                const StampTemplate& tp, const int32_t* thr,
                                int n_thr, int t_rows, int32_t* out,
                                uint64_t* blk, int stride) {
  uint32_t head[C_THRESH];
#pragma unroll
  for (int r = 0; r < C_THRESH; r++) head[r] = 0;
  const int32_t fl = flags[b];
  if (fl & 1) {
    const uint8_t* sg = sig + (size_t)b * 64;
    const uint8_t* kb = key + (size_t)b * 32;
    uint32_t hw[8];
    row_digest(sg, kb, ts + 3 * b, tp, template_row(fl, tp), blk, stride, hw);
    uint32_t sw[16], aw[8];  // R || S and A, little-endian words
#pragma unroll
    for (int k = 0; k < 4; k++) load16(sg + 16 * k, sw + 4 * k);
    load16(kb, aw);
    load16(kb + 16, aw + 4);
    limb_pairs(aw, head + C_AY);
    limb_pairs(sw, head + C_RY);
    digit_rows(sw + 8, hw, head + C_S8, head + C_H4);
    head[C_FLAGS] = (aw[7] >> 31) | ((sw[7] >> 31) << 1) |
                    (s_below_l(sw + 8) << 2) |
                    ((uint32_t)((fl >> 1) & 1) << 3);
    // the power's five 13-bit limbs, two a word
    const uint64_t p = (uint64_t)power[b];
    head[C_POW] = (uint32_t)(p & 0x1fff) | ((uint32_t)(p >> 13) & 0x1fff) << 13;
    head[C_POW + 1] =
        ((uint32_t)(p >> 26) & 0x1fff) | ((uint32_t)(p >> 39) & 0x1fff) << 13;
    head[C_POW + 2] = (uint32_t)(p >> 52) & 0x1fff;
  }
  head[C_CID] = (uint32_t)(fl >> 10);
#pragma unroll
  for (int r = 0; r < C_THRESH; r++) out[(size_t)r * B + b] = (int32_t)head[r];
  threshold_rows(b, B, thr, n_thr, t_rows, out + (size_t)C_THRESH * B);
}

}  // namespace cbt_stamp
