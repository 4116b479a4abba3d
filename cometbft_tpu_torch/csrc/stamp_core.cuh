// Device sign-bytes stamping for one packed column: the per-thread work of
// the stamp_rows kernel (stamp_rows.cu), also compiled for the host by
// ed25519_host.cpp so the CPU tests check it against the plain version.
//
// From one row's deltas (64 signature bytes, the timestamp as three int32
// words, the flags word), the stamp template of its height and the row's
// validator key, it writes the column of the cached packed rows that
// ops/ed25519_cached.py `pack_rows_cached` builds from a host pack of the
// same vote: the canonical vote sign-bytes (LEB128 timestamp varints with
// proto3 zero-skip, outer length prefix), h = SHA-512(R || A || msg) mod L
// as 64 nibbles, R's 13-bit limbs, s's bytes, and the flags word
// rsign | precheck << 1 | counted << 2 | commit_id << 3.
// 64-bit integers throughout: SHA-512 words are uint64 and the mod-L
// reduction is ref10's sc_reduce (21-bit limbs in int64).
#pragma once
#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define CBT_D __device__ __forceinline__
#define CBT_D_NOINLINE __device__ __noinline__
#define CBT_CONST __device__ __constant__
#else
#define CBT_D static inline
#define CBT_D_NOINLINE static
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

enum { V_RY = 0, V_S8 = 10, V_H4 = 18, V_FLAGS = 26, V_THRESH = 27 };

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

CBT_D uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

// one compression; w holds the block's 16 big-endian words and is used as
// the message schedule's ring buffer
CBT_D_NOINLINE void sha512_block(uint64_t* h, uint64_t* w) {
  CBT_COUNT_BLOCK();
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
  for (int t = 0; t < 80; t++) {
    uint64_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
      const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t t1 = hh + S1 + ch + kSha512K[t] + wt;
    const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

struct Sha512 {
  uint64_t h[8];
  uint64_t w[16];
  int n;  // bytes in the current block
};

CBT_D void sha_init(Sha512& s) {
  for (int k = 0; k < 8; k++) s.h[k] = kSha512H0[k];
  for (int k = 0; k < 16; k++) s.w[k] = 0;
  s.n = 0;
}

CBT_D void sha_put(Sha512& s, uint32_t byte) {
  s.w[s.n >> 3] |= (uint64_t)(byte & 0xffu) << (56 - 8 * (s.n & 7));
  if (++s.n == 128) {
    sha512_block(s.h, s.w);
    for (int k = 0; k < 16; k++) s.w[k] = 0;
    s.n = 0;
  }
}

// padding and the 128-bit big-endian bit length; digest bytes in stream
// order (byte k of the digest is byte k of the little-endian integer the
// mod-L reduction reads)
CBT_D void sha_final(Sha512& s, uint32_t total_bytes, uint8_t* out) {
  const uint64_t bits = (uint64_t)total_bytes * 8;
  sha_put(s, 0x80);
  while (s.n != 112) sha_put(s, 0);
  for (int k = 0; k < 8; k++) sha_put(s, 0);
  for (int k = 7; k >= 0; k--) sha_put(s, (uint32_t)(bits >> (8 * k)));
  for (int k = 0; k < 64; k++)
    out[k] = (uint8_t)(s.h[k >> 3] >> (56 - 8 * (k & 7)));
}

// ref10 sc_reduce: 64 little-endian bytes -> 32 bytes of (value mod L).
// 2^252 = -c (mod L) with -c = 666643 + 470296 2^21 + 654183 2^42
// - 997805 2^63 + 136657 2^84 - 683901 2^105; the folds and carries run in
// ref10's order, which keeps every int64 in range.
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

CBT_D_NOINLINE void sc_reduce(const uint8_t* in, uint8_t* out) {
  int64_t s[24];
  for (int i = 0; i < 24; i++) {
    const int bit = 21 * i, byte = bit >> 3, sh = bit & 7;
    uint64_t x = 0;
    for (int k = 0; k < 4 && byte + k < 64; k++)
      x |= (uint64_t)in[byte + k] << (8 * k);
    x >>= sh;
    s[i] = (int64_t)(i == 23 ? x : (x & 0x1fffffu));
  }
  for (int i = 23; i >= 18; i--) sc_fold(s, i);
  for (int i = 6; i <= 16; i += 2) sc_carry_round(s, i);
  for (int i = 7; i <= 15; i += 2) sc_carry_round(s, i);
  for (int i = 17; i >= 12; i--) sc_fold(s, i);
  for (int i = 0; i <= 10; i += 2) sc_carry_round(s, i);
  for (int i = 1; i <= 11; i += 2) sc_carry_round(s, i);
  sc_fold(s, 12);
  for (int i = 0; i <= 11; i++) sc_carry_floor(s, i);
  sc_fold(s, 12);
  for (int i = 0; i <= 10; i++) sc_carry_floor(s, i);
  // twelve 21-bit limbs -> 32 bytes
  for (int k = 0; k < 32; k++) out[k] = 0;
  for (int i = 0; i < 12; i++) {
    const uint64_t v = (uint64_t)s[i];
    const int bit = 21 * i;
    for (int b = 0; b < 21; b++)
      if ((v >> b) & 1) out[(bit + b) >> 3] |= (uint8_t)(1u << ((bit + b) & 7));
  }
}

// LEB128 of a 64-bit value (two's complement for negatives: 10 bytes)
CBT_D int uvarint(uint64_t x, uint8_t* out) {
  int n = 0;
  do {
    uint8_t b = (uint8_t)(x & 0x7f);
    x >>= 7;
    if (x) b |= 0x80;
    out[n++] = b;
  } while (x);
  return n;
}

struct StampTemplate {
  const uint8_t* pre;      // (n_sites, pm) prefix bytes
  const int32_t* pre_len;  // (n_sites,)
  const uint8_t* suf;      // (n_sites, sm) suffix bytes
  const int32_t* suf_len;  // (n_sites,)
  const int32_t* ts_tag;   // (n_sites,)
  int pm, sm, n_sites;
};

// Column b of the (V_THRESH + t_rows, B) packed rows. sig (B, 64) uint8,
// ts (B, 3) int32 [secs_lo, secs_hi, nanos], flags (B,) int32 with bit 0 =
// live, bit 1 = counted, bits 2..9 = template row, bits 10.. = commit id;
// pub_raw (M, 32) uint8 (column b is validator b mod M); thr: n_thr int32
// threshold words laid flat over the rows from V_THRESH on. A dead lane
// (live = 0) gives an all-zero head.
CBT_D void stamp_column(int b, int B, const uint8_t* sig, const int32_t* ts,
                        const int32_t* flags, const StampTemplate& tp,
                        const uint8_t* pub_raw, int M, const int32_t* thr,
                        int n_thr, int t_rows, int32_t* out) {
  uint32_t head[V_THRESH];
  for (int r = 0; r < V_THRESH; r++) head[r] = 0;
  const int32_t fl = flags[b];
  if (fl & 1) {
    const uint8_t* sg = sig + (size_t)b * 64;
    int t = (fl >> 2) & 0xff;
    if (t >= tp.n_sites) t = tp.n_sites - 1;  // gathers clamp, as in XLA
    const uint32_t counted = (fl >> 1) & 1;
    const uint32_t cid = (uint32_t)(fl >> 10);
    const uint64_t secs = (uint64_t)(uint32_t)ts[3 * b] |
                          ((uint64_t)(uint32_t)ts[3 * b + 1] << 32);
    const uint64_t nanos = (uint64_t)(int64_t)ts[3 * b + 2];
    uint8_t sb[10], nb[10], ob[5];
    const int sl = uvarint(secs, sb), nl = uvarint(nanos, nb);
    const int ts_len = (secs ? sl + 1 : 0) + (nanos ? nl + 1 : 0);
    const int pl = tp.pre_len[t], xl = tp.suf_len[t];
    const int body = pl + 2 + ts_len + xl;
    const int ol = uvarint((uint64_t)body, ob);

    Sha512 s;
    sha_init(s);
    for (int k = 0; k < 32; k++) sha_put(s, sg[k]);
    const uint8_t* a = pub_raw + (size_t)(b % M) * 32;
    for (int k = 0; k < 32; k++) sha_put(s, a[k]);
    for (int k = 0; k < ol; k++) sha_put(s, ob[k]);
    const uint8_t* pre = tp.pre + (size_t)t * tp.pm;
    for (int k = 0; k < pl; k++) sha_put(s, pre[k]);
    sha_put(s, (uint32_t)tp.ts_tag[t]);
    sha_put(s, (uint32_t)ts_len);
    if (secs) {
      sha_put(s, 0x08);
      for (int k = 0; k < sl; k++) sha_put(s, sb[k]);
    }
    if (nanos) {
      sha_put(s, 0x10);
      for (int k = 0; k < nl; k++) sha_put(s, nb[k]);
    }
    const uint8_t* suf = tp.suf + (size_t)t * tp.sm;
    for (int k = 0; k < xl; k++) sha_put(s, suf[k]);
    uint8_t dig[64], h[32];
    sha_final(s, (uint32_t)(64 + ol + body), dig);
    sc_reduce(dig, h);

    // R: 20 13-bit limbs of the low 255 bits, two per word
    uint32_t rl[20];
    for (int i = 0; i < 20; i++) {
      const int j = (13 * i) >> 3, r = (13 * i) & 7;
      uint32_t win = 0;
      for (int k = 0; k < 3 && j + k < 32; k++) {
        const uint32_t byte = (j + k == 31) ? (sg[31] & 0x7fu) : sg[j + k];
        win |= byte << (8 * k);
      }
      rl[i] = (win >> r) & 0x1fffu;
    }
    for (int i = 0; i < 10; i++) head[V_RY + i] = rl[i] | (rl[i + 10] << 13);
    for (int j = 0; j < 8; j++) {
      uint32_t s8 = 0, h4 = 0;
      for (int k = 0; k < 4; k++) s8 |= (uint32_t)sg[32 + 8 * k + j] << (8 * k);
      for (int k = 0; k < 8; k++) {
        const int nib = 8 * k + j;
        h4 |= (uint32_t)((h[nib >> 1] >> (4 * (nib & 1))) & 15) << (4 * k);
      }
      head[V_S8 + j] = s8;
      head[V_H4 + j] = h4;
    }
    // precheck: S < L, compared word by word from the top
    bool lt = false, dec = false;
    for (int k = 7; k >= 0; k--) {
      const uint32_t wk = (uint32_t)sg[32 + 4 * k] |
                          ((uint32_t)sg[33 + 4 * k] << 8) |
                          ((uint32_t)sg[34 + 4 * k] << 16) |
                          ((uint32_t)sg[35 + 4 * k] << 24);
      lt = lt || (!dec && wk < kLWords[k]);
      dec = dec || (wk != kLWords[k]);
    }
    head[V_FLAGS] = (uint32_t)(sg[31] >> 7) | ((lt ? 1u : 0u) << 1) |
                    (counted << 2) | (cid << 3);
  }
  for (int r = 0; r < V_THRESH; r++) out[(size_t)r * B + b] = (int32_t)head[r];
  for (int r = 0; r < t_rows; r++) {
    const size_t k = (size_t)r * B + b;
    out[(size_t)(V_THRESH + r) * B + b] = k < (size_t)n_thr ? thr[k] : 0;
  }
}

}  // namespace cbt_stamp
