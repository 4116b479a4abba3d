// The ZIP-215 verdict of one packed column computed by a quad: four lanes
// that each hold one coordinate of every point, after Hisil, Wong, Carter
// and Dawson, "Twisted Edwards Curves Revisited" (2008), whose extended
// coordinate formulas split into four independent products at every step.
//
// One source for the card and the host. Every function is a template on W,
// the number of lanes one caller holds:
//   W = 1  the card: the caller is lane threadIdx.x & 3 of its quad, and
//          the lanes exchange values with __shfl_sync inside the quad (all
//          32 threads of the warp take part in every exchange);
//   W = 4  the host (csrc/ed25519_host.cpp): one caller holds all four
//          lanes in an array, runs each step for k = 0..3 in turn, and an
//          exchange is an array read.
// So the host build runs the kernel's own lane program, exchange for
// exchange. Field arithmetic is ed25519_core.cuh's, with its own inline
// multiply and square (qfe_mul, qfe_sq) so that the other kernels' out-of-
// line fe_mul and fe_sq stay as they are; the host's counting build
// (CBT_COUNT_OPS) counts both kinds alike, one a lane.
//
// Lane k holds coordinate k of a point in the order (X, Y, T, Z), and
// component k of a cached point in the order (Y - X, Y + X, 2dT, Z): the
// operand that lane k multiplies in the first half of an addition. Both
// the addition and the doubling run as
//   1. each lane combines its value with one other lane's and multiplies
//      the sum by its own table component (addition) or squares it
//      (doubling): the four products A, B, C, D (or X^2, Y^2, (X+Y)^2,
//      Z^2), one a lane;
//   2. each lane combines products into one of E, F, G, H, fetches the two
//      its new coordinate needs, and multiplies them.
// A combination has small integer coefficients that depend only on the
// lane, and every exchange is one shuffle for all four lanes, so the quad
// runs one instruction stream with no branch on the lane. Combinations are
// left uncarried where the multiply that reads them allows (q_lin).
#pragma once
#include "ed25519_core.cuh"

#if defined(__CUDACC__)
#define CBT_QD __host__ __device__ __forceinline__
#define CBT_QM __host__ __device__ __forceinline__
#else
#define CBT_QD static inline
#define CBT_QM inline
#endif

namespace cbt_quad {

using cbt::fe;
using cbt::fe_from_i64;

// ---------------------------------------------------------------------------
// inline field multiply and square (the bodies of cbt::fe_mul and fe_sq)
// ---------------------------------------------------------------------------

CBT_QD fe qfe_mul(const fe& f, const fe& g) {
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

CBT_QD fe qfe_sq(const fe& f) {
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

// ---------------------------------------------------------------------------
// lanes
// ---------------------------------------------------------------------------

// What one caller holds: W lanes' field elements. On the card W = 1.
template <int W>
struct Q {
  fe v[W];
};

// The quad lane of the caller's slot k.
template <int W>
CBT_QD int lane_of(int k) {
#if defined(__CUDA_ARCH__)
  if (W == 1) return (int)(threadIdx.x & 3);
#endif
  return k;
}

// c0, c1, c2 or c3 for lane 0, 1, 2 or 3, chosen without a branch
CBT_QD int pick(int c0, int c1, int c2, int c3, int lane) {
  const int lo = (lane & 1) ? c1 : c0, hi = (lane & 1) ? c3 : c2;
  return (lane & 2) ? hi : lo;
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

// Lane j's field element, seen by every lane.
template <int W>
CBT_QD fe lane_fe(const Q<W>& x, int j) {
  return q_shfl(x, j, j, j, j).v[0];
}

// Slot k's a x + b y for the lane's small coefficients (a0..a3, b0..b3),
// not carried: on carried limbs (|limb| <= 2^25) with |a| + |b| <= 4 every
// limb stays below 2^27. qfe_mul takes such limbs as its first factor
// (its 2 f products fit int32 below 2^30), and as its second below 2^26.7
// (19 g fits int32), so |a| + |b| <= 3 there; qfe_sq needs carried limbs.
template <int W>
CBT_QD Q<W> q_lin(const Q<W>& x, int a0, int a1, int a2, int a3,
                  const Q<W>& y, int b0, int b1, int b2, int b3) {
  Q<W> r;
#pragma unroll
  for (int k = 0; k < W; k++) {
    const int lane = lane_of<W>(k);
    const int32_t a = pick(a0, a1, a2, a3, lane);
    const int32_t b = pick(b0, b1, b2, b3, lane);
#pragma unroll
    for (int i = 0; i < 10; i++)
      r.v[k].v[i] = a * x.v[k].v[i] + b * y.v[k].v[i];
  }
  return r;
}

// cbt::fe_from_i64's carry chain in int32, for limbs below 2^30 in
// absolute value (q_lin's): the same result.
CBT_QD fe fe_carry32(fe f) {
  int32_t* h = f.v;
  int32_t c;
  const int32_t B25 = 1 << 25, B24 = 1 << 24;
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
  return f;
}

// Lanes (X, Y, T, Z) -> (Y - X, Y + X, T, Z): a cached point's components
// before 2d, and the first factors of an addition (|limb| <= 2^26).
template <int W>
CBT_QD Q<W> q_add_in(const Q<W>& s) {
  return q_lin(s, -1, 1, 1, 1, q_shfl(s, 1, 0, 3, 2), 1, 1, 0, 0);
}

// s += q, q cached with carried limbs (unified add-2008-hwcd-3, a = -1).
// Lanes multiply (Y - X, Y + X, T, Z) by q's (Y - X, Y + X, 2dT, Z) into
// (A, B, C, D); then form (E, H, F, G) = (B - A, B + A, 2D - C, 2D + C)
// and multiply (E F, G H, E H, F G), the new (X, Y, T, Z).
template <int W>
CBT_QD void q_add(Q<W>& s, const Q<W>& q) {
  const Q<W> u = q_add_in(s);
  Q<W> m;
#pragma unroll
  for (int k = 0; k < W; k++) m.v[k] = qfe_mul(u.v[k], q.v[k]);
  const Q<W> v = q_lin(m, -1, 1, -1, 2, q_shfl(m, 1, 0, 3, 2), 1, 1, 2, 1);
  const Q<W> l = q_shfl(v, 0, 3, 0, 2), r = q_shfl(v, 2, 1, 1, 3);
#pragma unroll
  for (int k = 0; k < W; k++) s.v[k] = qfe_mul(l.v[k], r.v[k]);
}

// s = 2 s (dbl-2008-hwcd), s carried. Lanes square (X, Y, X + Y, Z) into
// (A, B, S, Z2); lanes 0 and 1 form G = A - B and H = A + B, lanes 2 and 3
// then E = H - S and F = 2 Z2 + G; lanes multiply (F E, G H, E H, F G).
template <int W>
CBT_QD void q_dbl(Q<W>& s) {
  const Q<W> w = q_lin(q_shfl(s, 0, 1, 0, 3), 1, 1, 1, 1,
                       q_shfl(s, 0, 1, 1, 3), 0, 0, 1, 0);
  Q<W> m;
#pragma unroll
  for (int k = 0; k < W; k++) m.v[k] = qfe_sq(fe_carry32(w.v[k]));
  const Q<W> gh = q_lin(m, 1, 1, 0, 0, q_shfl(m, 1, 0, 3, 2), -1, 1, 0, 0);
  const Q<W> f = q_lin(m, 0, 0, -1, 2, q_shfl(gh, 0, 1, 1, 0), 1, 1, 1, 1);
  const Q<W> l = q_shfl(f, 3, 0, 2, 3), r = q_shfl(f, 2, 1, 1, 0);
#pragma unroll
  for (int k = 0; k < W; k++) s.v[k] = qfe_mul(l.v[k], r.v[k]);
}

// The cached components of point s, carried: lane 2 multiplies T by 2d,
// the other lanes their component by one (one instruction stream).
template <int W>
CBT_QD Q<W> q_cached(const Q<W>& s) {
  const Q<W> u = q_add_in(s);
  const fe d2 = cbt::fe_d2(), one = cbt::fe_one();
  Q<W> c;
#pragma unroll
  for (int k = 0; k < W; k++)
    c.v[k] = qfe_mul(u.v[k], lane_of<W>(k) == 2 ? d2 : one);
  return c;
}

// The per-signature table: [d](-A) at d < kMulEntries, then (ed25519
// only) -R at kNegR, all cached, lane k keeping component k of each entry.
// On the card it lives in shared memory as [entry][limb][thread], so the
// 32 lanes of a warp touch 32 banks whatever entry each quad reads; the
// kernel sizes its shared array by the entries it uses (kTabEntries for
// ed25519, kMulEntries for sr25519). On the host it is an array.
constexpr int kMulEntries = 16, kNegR = kMulEntries,
              kTabEntries = kMulEntries + 1;

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
  Q<4> e[kTabEntries];
  CBT_QM void put(int d, const Q<4>& x) { e[d] = x; }
  CBT_QM Q<4> get(int d) const { return e[d]; }
};

// The lane's component of the base comb's niels entry (y+x, y-x, 2dxy)
// as a cached point with Z = 1: lanes (y-x, y+x, 2dxy, 1). Lane 3 loads
// 2dxy as well and drops it, so the quad issues one load stream.
template <int W>
CBT_QD Q<W> q_niels(const cbt::ge_niels* base, int idx) {
  const int32_t* e = reinterpret_cast<const int32_t*>(base + idx);
  const fe one = cbt::fe_one();
  Q<W> q;
#pragma unroll
  for (int k = 0; k < W; k++) {
    const int lane = lane_of<W>(k);
    const int comp = lane == 0 ? 1 : (lane == 1 ? 0 : 2);
    fe x;
#pragma unroll
    for (int i = 0; i < 10; i++) x.v[i] = e[comp * 10 + i];
    q.v[k] = lane == 3 ? one : x;
  }
  return q;
}

// ---------------------------------------------------------------------------
// the verdict
// ---------------------------------------------------------------------------

// Decodes point `which` (0: A, 1: R) of column `col` under ZIP-215 into
// its x; 0 where the precheck failed (or the column is padding) or y does
// not decode. Runs on one thread with the out-of-line field ops of
// ed25519_core.cuh: the kernel gives it one warp of each block, and its
// call keeps the square-root chain's registers out of the quad program's.
CBT_QD int decode_point(const int32_t* rows, int B, int col, int which,
                        fe* x) {
  using namespace cbt;
  const uint32_t flags = (uint32_t)rows[C_FLAGS * B + col];
  if (((flags >> 2) & 1) == 0) return 0;
  ge_p3 P;
  const int ok = ge_decompress(
      fe_from_packed13(rows, B, which ? C_RY : C_AY, col),
      which ? (flags >> 1) & 1 : flags & 1, &P);
  *x = P.X;
  return ok;
}

// -P = (-x, y, -x y, 1) for the affine point (x, y), spread over the
// lanes as (X, Y, T, Z).
template <int W>
CBT_QD Q<W> q_neg_affine(const fe& x, const fe& y) {
  const fe nx = cbt::fe_neg(x), nxy = cbt::fe_neg(qfe_mul(x, y)),
           one = cbt::fe_one();
  Q<W> p;
#pragma unroll
  for (int k = 0; k < W; k++) {
    const int lane = lane_of<W>(k);
    p.v[k] = lane == 0 ? nx : lane == 1 ? y : lane == 2 ? nxy : one;
  }
  return p;
}

// [s]B + [h](-A) for column `col`, the quad counterpart of
// cbt::sb_minus_ha, shared by the ed25519 and sr25519 verdicts: fills
// table entries 0..15 with [d](-A) and returns the accumulator (X, Y, T,
// Z). negA is -A as q_neg_affine spreads it.
template <int W>
CBT_QD Q<W> q_sb_minus_ha(const int32_t* rows, int B, int col,
                          const cbt::ge_niels* base, QTab<W>& tab,
                          const Q<W>& negA) {
  using namespace cbt;
  // the table [d](-A): entry 0 the identity (1, 1, 0, 1), entry 1 -A,
  // entry d = entry d-1 + (-A)
  {
    Q<W> id;
#pragma unroll
    for (int k = 0; k < W; k++)
      id.v[k] = lane_of<W>(k) == 2 ? fe_zero() : fe_one();
    tab.put(0, id);
  }
  const Q<W> cA = q_cached(negA);
  tab.put(1, cA);
  Q<W> m = negA;
  for (int d = 2; d < kMulEntries; d++) {
    q_add(m, cA);
    tab.put(d, q_cached(m));
  }

  // [h](-A): Horner over 64 base-16 digits, top digit first; the
  // accumulator starts at the identity (0, 1, 0, 1)
  Q<W> acc;
#pragma unroll
  for (int k = 0; k < W; k++)
    acc.v[k] = (lane_of<W>(k) & 1) ? fe_one() : fe_zero();
  for (int w = 63; w >= 0; w--) {
    if (w != 63)
      for (int i = 0; i < 4; i++) q_dbl(acc);
    const uint32_t word = (uint32_t)rows[(C_H4 + (w & 7)) * B + col];
    q_add(acc, tab.get((word >> (4 * (w >> 3))) & 15));
  }

  // + [s]B: 32 width-8 comb windows, one integer gather each
  for (int w = 0; w < 32; w++) {
    const uint32_t word = (uint32_t)rows[(C_S8 + (w & 7)) * B + col];
    q_add(acc, q_niels<W>(base, w * 256 + ((word >> (8 * (w >> 3))) & 255)));
  }
  return acc;
}

// The quad's program for column `col` whose A and R decoded to x = xA and
// xR: 1 iff [8]([s]B + [h](-A) - R) is the identity. Every lane returns
// it. It has no branch on the lane or the data around an exchange, so a
// warp whose columns are padding or failed still runs it in step (the
// kernel masks those verdicts). `tab` is the lanes' table storage.
template <int W>
CBT_QD int quad_verdict(const int32_t* rows, int B, int col,
                        const cbt::ge_niels* base, QTab<W>& tab,
                        const fe& xA, const fe& xR) {
  using namespace cbt;
  const fe yA = fe_from_packed13(rows, B, C_AY, col),
           yR = fe_from_packed13(rows, B, C_RY, col);
  const Q<W> negA = q_neg_affine<W>(xA, yA);
  tab.put(kNegR, q_cached(q_neg_affine<W>(xR, yR)));
  Q<W> acc = q_sb_minus_ha(rows, B, col, base, tab, negA);

  // - R, then the cofactor: [8]W == identity <=> X == 0 and Y == Z
  q_add(acc, tab.get(kNegR));
  for (int i = 0; i < 3; i++) q_dbl(acc);
  const fe x = lane_fe(acc, 0), y = lane_fe(acc, 1), z = lane_fe(acc, 3);
  return (fe_is_zero(x) && fe_eq(y, z)) ? 1 : 0;
}

// The verdict of column `col`, the same as cbt::verify_column, with the
// quad's four lanes on one thread (the host's run of the kernel's program).
CBT_QD int verify_column_quad(const int32_t* rows, int B, int col,
                              const cbt::ge_niels* base, QTab<4>& tab) {
  fe xA, xR;
  const int okA = decode_point(rows, B, col, 0, &xA);
  const int okR = decode_point(rows, B, col, 1, &xR);
  if (!(okA && okR)) return 0;
  return quad_verdict<4>(rows, B, col, base, tab, xA, xR);
}

}  // namespace cbt_quad
