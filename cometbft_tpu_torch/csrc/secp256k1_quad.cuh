// The secp256k1 ECDSA verdict of one packed column computed by a quad: four
// lanes that each hold one coordinate of every point, so each Renes-
// Costello-Batina addition (eprint 2015/1060, algorithm 7, a = 0, b3 = 21)
// is three rounds of one field multiplication a lane and each doubling
// (algorithm 9) two, the operands moving inside the quad between rounds.
//
// One source for the card and the host, templated on W like
// ed25519_quad.cuh (whose pick and lane_of it uses): W = 1 on the card,
// where the caller is lane threadIdx.x & 3 of its quad and an exchange is
// a __shfl_sync over the whole warp; W = 4 on the host (ed25519_host.cpp),
// where one caller holds the four lanes in an array and an exchange is an
// array read. The field is secp256k1_core.cuh's (ten signed 26-bit limbs),
// with its multiply inlined here (qmul) so that the decode's out-of-line
// fe_mul, fe_sq and their op counters stay as they are.
//
// Lanes. The accumulator (and every point the program carries) is held as
// (Y, Y, Z, X): lane k holds coordinate k of that tuple. An addend (a
// table entry or a comb entry) is held as (Y, X + Y, Z, X). Then
//   addition, round 1: lane k multiplies its own accumulator and addend
//     values (lane 1 first adds X to its Y): Y1 Y2, (X1 + Y1)(X2 + Y2),
//     Z1 Z2, X1 X2 = t1, u3, t2, t0;
//   round 2: (Y1 + Z1)(Y2 + Z2), t3 t1', t1' Z3, (X1 + Z1)(X2 + Z2), with
//     t3 = u3 - t0 - t1, t1' = t1 - 21 t2, Z3 = t1 + 21 t2;
//   round 3: Y3' t0', t0' t3, Z3 t4, t4 Y3', with t0' = 3 t0, t4 = P0 -
//     t1 - t2 and Y3' = 21 (P3 - t0 - t2) from round 2's products P0, P3;
//   the new (Y, Y, Z, X) = (t1' Z3 + Y3' t0', the same, Z3 t4 + t0' t3,
//     t3 t1' - t4 Y3'): twelve products in three rounds of four.
//   doubling, round 1: Y Y, Y Z, Z (21 Z), X Y; round 2: W Y^2, Y Z Y^2,
//     (Y^2 - 3 W)(Y^2 + W), (Y^2 - 3 W) X Y with W = 21 Z^2; the new
//     (Y, Y, Z, X) = (8 P0 + P2, the same, 8 P1, 2 P3).
// Every lane runs the same instruction stream: coefficients are picked by
// lane without a branch, and each exchange is one shuffle for all four
// lanes. Linear combinations are int32; a value scaled by 21 is carried
// (qcarry) before it enters a product, which accepts |limb| < 2^28.
#pragma once
#include "ed25519_quad.cuh"
#include "secp256k1_core.cuh"

namespace cbt_secp_quad {

using cbt_quad::lane_of;
using cbt_quad::pick;
using cbt_secp::fe;

// the body of cbt_secp::fe_mul, inline: 100 limb products
CBT_QD fe qmul(const fe& f, const fe& g) {
  int64_t c[19];
#pragma unroll
  for (int k = 0; k < 19; k++) c[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) c[i + j] += (int64_t)f.v[i] * g.v[j];
  }
  return cbt_secp::fe_reduce19(c);
}

// cbt_secp::fe_carry in int32, for limbs below 2^30.5 in absolute value:
// a ripple, the carry out of limb 9 folded into limbs 0 and 1 (2^260 =
// 2^36 + 0x3D10), a second ripple. The result is carried: limbs 0-8 in
// [0, 2^26), limb 9 in [-1, 2^26].
CBT_QD fe qcarry(fe f) {
  int32_t* h = f.v;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int32_t c = h[i] >> 26;
    h[i] -= c * (1 << 26);
    h[i + 1] += c;
  }
  const int32_t c9 = h[9] >> 26;
  h[9] -= c9 * (1 << 26);
  h[0] += c9 * 0x3D10;
  h[1] += c9 * 1024;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int32_t c = h[i] >> 26;
    h[i] -= c * (1 << 26);
    h[i + 1] += c;
  }
  return f;
}

// ---------------------------------------------------------------------------
// lanes
// ---------------------------------------------------------------------------

// What one caller holds: W lanes' field elements. On the card W = 1.
template <int W>
struct Q {
  fe v[W];
};

// Four per-lane small integers (coefficients or choices).
struct C4 {
  int c0, c1, c2, c3;
};

CBT_QD int at(const C4& c, int lane) {
  return pick(c.c0, c.c1, c.c2, c.c3, lane);
}

// The exchange: lane k gets lane s_k's value of x.
template <int W>
CBT_QD Q<W> q_shfl(const Q<W>& x, int s0, int s1, int s2, int s3) {
  Q<W> r;
#if defined(__CUDA_ARCH__)
  if (W == 1) {
    const int src = pick(s0, s1, s2, s3, lane_of<W>(0));
#pragma unroll
    for (int i = 0; i < 10; i++)
      r.v[0].v[i] = __shfl_sync(0xffffffffu, x.v[0].v[i], src, 4);
    return r;
  }
#endif
#pragma unroll
  for (int k = 0; k < W; k++)
    r.v[k] = x.v[pick(s0, s1, s2, s3, lane_of<W>(k)) % W];
  return r;
}

// Slot k's x, or y where the lane's choice is 1.
template <int W>
CBT_QD Q<W> q_pick(const Q<W>& x, const Q<W>& y, C4 use_y) {
  Q<W> r;
#pragma unroll
  for (int k = 0; k < W; k++) r.v[k] = at(use_y, lane_of<W>(k)) ? y.v[k] : x.v[k];
  return r;
}

// Slot k's a x + b y + c z + d u for the lane's coefficients, in int32,
// not carried (callers keep every limb below 2^30.5).
template <int W>
CBT_QD Q<W> q_lin(const Q<W>& x, C4 a, const Q<W>& y, C4 b, const Q<W>& z,
                  C4 c, const Q<W>& u, C4 d) {
  Q<W> r;
#pragma unroll
  for (int k = 0; k < W; k++) {
    const int lane = lane_of<W>(k);
    const int32_t ca = at(a, lane), cb = at(b, lane), cc = at(c, lane),
                  cd = at(d, lane);
#pragma unroll
    for (int i = 0; i < 10; i++)
      r.v[k].v[i] = ca * x.v[k].v[i] + cb * y.v[k].v[i] +
                    cc * z.v[k].v[i] + cd * u.v[k].v[i];
  }
  return r;
}

template <int W>
CBT_QD Q<W> q_lin(const Q<W>& x, C4 a, const Q<W>& y, C4 b, const Q<W>& z,
                  C4 c) {
  return q_lin(x, a, y, b, z, c, x, C4{0, 0, 0, 0});
}

template <int W>
CBT_QD Q<W> q_lin(const Q<W>& x, C4 a, const Q<W>& y, C4 b) {
  return q_lin(x, a, y, b, x, C4{0, 0, 0, 0}, x, C4{0, 0, 0, 0});
}

template <int W>
CBT_QD Q<W> q_carry(Q<W> x) {
#pragma unroll
  for (int k = 0; k < W; k++) x.v[k] = qcarry(x.v[k]);
  return x;
}

// one field multiplication a lane
template <int W>
CBT_QD Q<W> q_mul(const Q<W>& x, const Q<W>& y) {
  Q<W> r;
#pragma unroll
  for (int k = 0; k < W; k++) r.v[k] = qmul(x.v[k], y.v[k]);
  return r;
}

// ---------------------------------------------------------------------------
// points
// ---------------------------------------------------------------------------

// An accumulator (Y, Y, Z, X) as an addend (Y, X + Y, Z, X): lane 1 adds
// lane 3's X. Limbs stay below 2^27.
template <int W>
CBT_QD Q<W> q_addend(const Q<W>& s) {
  return q_lin(s, C4{1, 1, 1, 1}, q_shfl(s, 0, 3, 2, 3), C4{0, 1, 0, 0});
}

// An addend (Y, X + Y, Z, X) as an accumulator (Y, Y, Z, X), carried.
template <int W>
CBT_QD Q<W> q_acc(const Q<W>& q) {
  return q_carry(
      q_lin(q, C4{1, 1, 1, 1}, q_shfl(q, 0, 3, 2, 3), C4{0, -1, 0, 0}));
}

// The projective point (X, Y, Z) spread over the lanes as an accumulator.
template <int W>
CBT_QD Q<W> q_from_xyz(const fe& X, const fe& Y, const fe& Z) {
  Q<W> s;
#pragma unroll
  for (int k = 0; k < W; k++) {
    const int lane = lane_of<W>(k);
    s.v[k] = lane == 3 ? X : lane == 2 ? Z : Y;
  }
  return s;
}

// s += q for an accumulator s (carried) and an addend q (algorithm 7).
template <int W>
CBT_QD void q_add(Q<W>& s, const Q<W>& q) {
  // round 1: lanes (t1, u3, t2, t0)
  const Q<W> m = q_mul(q_addend(s), q);
  // round 2: lanes (Y1 + Z1, t3, t1', X1 + Z1) x (Y2 + Z2, t1', Z3, X2 + Z2)
  const Q<W> al = q_shfl(q_pick(m, s, C4{0, 0, 1, 0}), 2, 3, 0, 2);
  const Q<W> be = q_shfl(q_pick(m, q, C4{0, 0, 1, 0}), 2, 0, 2, 2);
  const Q<W> ga = q_shfl(m, 0, 2, 2, 3);
  // al: (Z1, t0, t1, Z1); be: (Z2, t1, -, Z2); ga: (-, t2, t2, -)
  const Q<W> f = q_carry(q_lin(q_pick(s, m, C4{0, 1, 0, 0}), C4{1, 1, 0, 1},
                               al, C4{1, -1, 1, 1}, be, C4{0, -1, 0, 0}, ga,
                               C4{0, 0, -21, 0}));
  const Q<W> g = q_carry(q_lin(q, C4{1, 0, 0, 1}, al, C4{0, 0, 1, 0}, be,
                               C4{1, 1, 0, 1}, ga, C4{0, -21, 21, 0}));
  const Q<W> keep = q_pick(g, f, C4{0, 1, 0, 0});  // lane 1 t3, lane 2 Z3
  const Q<W> p = q_mul(f, g);  // (P0, t3 t1', t1' Z3, P3)
  // round 3: lanes (Y3', t0', Z3, t4) x (t0', t3, t4, Y3')
  const Q<W> t2 = q_shfl(m, 2, 1, 2, 2);
  // lane 0: t4 = P0 - t1 - t2; lane 3: Y3 = P3 - t0 - t2
  const Q<W> w = q_carry(q_lin(p, C4{1, 1, 1, 1}, m, C4{-1, -1, -1, -1}, t2,
                               C4{-1, -1, -1, -1}));
  const Q<W> b = q_shfl(w, 3, 1, 0, 0);  // (Y3, -, t4, t4)
  const Q<W> c = q_shfl(m, 3, 3, 2, 3);  // (t0, t0, -, -)
  const Q<W> f3 = q_carry(q_lin(b, C4{21, 0, 0, 1}, c, C4{0, 3, 0, 0}, keep,
                                C4{0, 0, 1, 0}));
  const Q<W> g3 = q_carry(q_lin(c, C4{3, 0, 0, 0}, keep, C4{0, 1, 0, 0}, b,
                                C4{0, 0, 1, 0}, w, C4{0, 0, 0, 21}));
  const Q<W> r = q_mul(f3, g3);  // (Y3' t0', t0' t3, Z3 t4, t4 Y3')
  // the new (Y, Y, Z, X)
  const Q<W> pp = q_shfl(p, 2, 2, 2, 1);  // (t1' Z3, t1' Z3, -, t3 t1')
  const Q<W> rr = q_shfl(r, 0, 0, 1, 3);  // (-, Y3' t0', t0' t3, -)
  s = q_carry(q_lin(r, C4{1, 0, 1, -1}, rr, C4{0, 1, 1, 0}, pp,
                    C4{1, 1, 0, 1}));
}

// s = 2 s for an accumulator s (algorithm 9).
template <int W>
CBT_QD void q_dbl(Q<W>& s) {
  // round 1: lanes (Y, Y, Z, X) x (Y, Z, 21 Z, Y) = (Y^2, Y Z, W, X Y)
  const Q<W> m = q_mul(
      s, q_carry(q_lin(q_shfl(s, 0, 2, 2, 1), C4{1, 1, 21, 1}, s,
                       C4{0, 0, 0, 0})));
  // round 2: lanes (W, Y Z, Y^2 - 3 W, Y^2 - 3 W) x (Y^2, Y^2, Y^2 + W, X Y)
  const Q<W> yy = q_shfl(m, 0, 0, 0, 0), ww = q_shfl(m, 2, 2, 2, 2);
  const Q<W> p = q_mul(
      q_lin(ww, C4{1, 0, -3, -3}, m, C4{0, 1, 0, 0}, yy, C4{0, 0, 1, 1}),
      q_lin(yy, C4{1, 1, 1, 0}, ww, C4{0, 0, 1, 0}, m, C4{0, 0, 0, 1}));
  // the new (Y, Y, Z, X) = (8 P0 + P2, 8 P0 + P2, 8 P1, 2 P3)
  s = q_carry(q_lin(q_shfl(p, 0, 0, 1, 3), C4{8, 8, 8, 2},
                    q_shfl(p, 2, 2, 2, 2), C4{1, 1, 0, 0}));
}

// ---------------------------------------------------------------------------
// the per-signature table [d]Q, d < 16, of addends: on the card in shared
// memory as [entry][limb][thread], so the 32 lanes of a warp touch 32
// banks whatever entry each quad reads; on the host an array
// ---------------------------------------------------------------------------

constexpr int kEntries = 16;

template <int W>
struct QTab;

template <>
struct QTab<1> {
  int32_t* p;  // this thread's first word
  int stride;  // threads in the block
  CBT_QM void put(int d, const Q<1>& x) {
#pragma unroll
    for (int i = 0; i < 10; i++) p[(d * 10 + i) * stride] = x.v[0].v[i];
  }
  CBT_QM Q<1> get(int d) const {
    Q<1> x;
#pragma unroll
    for (int i = 0; i < 10; i++) x.v[0].v[i] = p[(d * 10 + i) * stride];
    return x;
  }
};

template <>
struct QTab<4> {
  Q<4> e[kEntries];
  CBT_QM void put(int d, const Q<4>& x) { e[d] = x; }
  CBT_QM Q<4> get(int d) const { return e[d]; }
};

// The comb entry `idx` of G as an addend (Y, X + Y, Z, X). Every lane
// loads two coordinates (its own and Y) and lane 1 adds them, so the quad
// issues one load stream.
template <int W>
CBT_QD Q<W> q_comb(const cbt_secp::gpt* base, int idx) {
  const int32_t* e = reinterpret_cast<const int32_t*>(base + idx);
  Q<W> q;
#pragma unroll
  for (int k = 0; k < W; k++) {
    const int lane = lane_of<W>(k);
    const int comp = pick(1, 0, 2, 0, lane), add = lane == 1 ? 1 : 0;
#pragma unroll
    for (int i = 0; i < 10; i++)
      q.v[k].v[i] = e[comp * 10 + i] + add * e[10 + i];
  }
  return q;
}

// ---------------------------------------------------------------------------
// the verdict
// ---------------------------------------------------------------------------

// The quad's program for column `col` whose public key decoded to (x, y):
// 1 iff R = [u1]G + [u2]Q has Z != 0 and X = r Z or X = xr2 Z, as
// cbt_secp::ecdsa_verify_column. Every lane returns it. It has no branch
// on the lane or the data before its last exchange, so a warp whose
// columns are padding or failed still runs it in step (the kernel masks
// those verdicts). `tab` is the lanes' table storage.
template <int W>
CBT_QD int quad_verdict_ecdsa(const int32_t* rows, int B, int col,
                              const cbt_secp::gpt* base, QTab<W>& tab,
                              const fe& x, const fe& y) {
  using namespace cbt_secp;
  // the table: entry 0 the identity (0 : 1 : 0), entry d = entry d-1 + Q
  tab.put(0, q_from_xyz<W>(fe_small(0), fe_small(1), fe_small(0)));
  Q<W> m = q_from_xyz<W>(qcarry(x), qcarry(y), fe_small(1));
  const Q<W> q = q_addend(m);
  tab.put(1, q);
  for (int d = 2; d < kEntries; d++) {
    q_add(m, q);
    tab.put(d, q_addend(m));
  }

  // [u2]Q: Horner over 64 base-16 digits, top digit first
  uint32_t word = (uint32_t)rows[(E_U2 + 7) * B + col];
  Q<W> acc = q_acc(tab.get((word >> 28) & 15));
  for (int w = 62; w >= 0; w--) {
    for (int i = 0; i < 4; i++) q_dbl(acc);
    word = (uint32_t)rows[(E_U2 + (w & 7)) * B + col];
    q_add(acc, tab.get((word >> (4 * (w >> 3))) & 15));
  }

  // + [u1]G: 32 width-8 comb windows, one integer gather each
  for (int w = 0; w < 32; w++) {
    word = (uint32_t)rows[(E_U1 + (w & 7)) * B + col];
    q_add(acc, q_comb<W>(base, w * 256 + ((word >> (8 * (w >> 3))) & 255)));
  }

  // every lane fetches X and Z and decides alike
  const fe X = q_shfl(acc, 3, 3, 3, 3).v[0], Z = q_shfl(acc, 2, 2, 2, 2).v[0];
  const fe xr1z = qmul(fe_from_packed13(rows, B, E_XR1, col), Z);
  const fe xr2z = qmul(fe_from_packed13(rows, B, E_XR2, col), Z);
  return (!fe_is_zero(Z) && (fe_eq(X, xr1z) || fe_eq(X, xr2z))) ? 1 : 0;
}

// The verdict of column `col`, the same as cbt_secp::ecdsa_verify_column,
// with the quad's four lanes on one thread (the host's run of the kernel's
// program).
CBT_QD int verify_column_ecdsa_quad(const int32_t* rows, int B, int col,
                                    const cbt_secp::gpt* base, QTab<4>& tab) {
  fe x, y;
  if (!cbt_secp::decode_q(rows, B, col, &x, &y)) return 0;
  return quad_verdict_ecdsa<4>(rows, B, col, base, tab, x, y);
}

}  // namespace cbt_secp_quad
