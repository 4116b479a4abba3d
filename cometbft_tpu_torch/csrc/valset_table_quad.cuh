// The valset table of one validator computed by quads: ed25519_quad.cuh's
// four lanes (lane k holds coordinate k of (X, Y, T, Z)), its doubling,
// addition and cached form, and Montgomery's trick over the entries' Z's.
// Every function is a template on W, the lanes one caller holds: W = 1 on
// the card (valset_table.cu), W = 4 on the host (ed25519_host.cpp), which
// so runs the kernel's lane program, exchange for exchange.
//
// The entries are those of cbt::table_entries, the one-thread host
// reference: entry j * 16 + d of the validator is [d] base_j, base_j =
// 2^(32 j) (-A), as a canonical affine niels point {y + x, y - x, 2dxy}.
// Two programs make them:
//   quad  one quad a validator: 224 chained doublings, base_j taken after
//         every 32, each base's 14 additions as it comes, one inversion
//         over the validator's 120 Z's (d >= 1);
//   warp  eight quads a validator, quad j for base j: all eight run the
//         224 doublings in step (a warp issues once for its 32 threads),
//         quad j keeps the point after 32 j of them, then makes base j's
//         entries with one inversion over their 15 Z's.
// A's decoding (decode_key) and the inversions run apart, one a thread,
// on the block's first warp with the out-of-line field ops.
//
// Montgomery's trick without the prefix products in memory. An entry's
// cached form (Y - X, Y + X, 2dT, Z) holds its three niels numerators on
// lanes 0-2 and Z on lane 3. Going forward, every lane multiplies its
// component by the running product pre_{i-1} = Z_0 ... Z_{i-1} (lane 3's
// value): lanes 0-2 store N_i pre_{i-1} in the entry's own 120-byte slot,
// lane 3 gets pre_i and stores Z_i in the scratch. After the one inversion
// inv_n = 1 / pre_n, going back every lane multiplies its stored value by
// inv_i: lanes 0-2 get N_i / Z_i, the entry, and lane 3 Z_i inv_i =
// inv_{i-1}. So an entry costs two products a lane, one each way, and its
// three numerators wait in its slot.
#pragma once
#include "ed25519_cached.cuh"
#include "ed25519_quad.cuh"

// The lane programs' loops stay rolled: unrolled, they hold more values
// at once than 128 registers a thread keep without spilling.
#if defined(__CUDA_ARCH__)
#define CBT_NO_UNROLL _Pragma("unroll 1")
#else
#define CBT_NO_UNROLL
#endif

namespace cbt_quad {

using cbt::TAB_NENT;
using cbt::TAB_NJ;

// entries with d >= 1 a base and a validator: the ones with a Z
constexpr int kBaseZs = TAB_NENT - 1, kValZs = TAB_NJ * kBaseZs;
constexpr int kFeWords = 10, kNielsWords = 3 * kFeWords;

// A's affine (x, y) from the 32 raw key bytes under ZIP-215, or the
// identity (0, 1) where it does not decode; returns whether it decoded.
// One thread, the out-of-line field ops of ed25519_core.cuh.
CBT_QD bool decode_key(const uint8_t* pub, fe* x, fe* y) {
  using namespace cbt;
  ge_p3 A;
  const bool ok = ge_decompress(fe_from_bytes(pub), pub[31] >> 7, &A);
  *x = ok ? A.X : fe_zero();
  *y = ok ? A.Y : fe_one();
  return ok;
}

// A field element's ten words at p, 8-byte aligned: on the card five
// 8-byte accesses (an entry slot is 120 B, a Z 40 B).
CBT_QD void st_fe(int32_t* p, const fe& x) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < kFeWords; i += 2)
    *reinterpret_cast<int2*>(p + i) = make_int2(x.v[i], x.v[i + 1]);
#else
  for (int i = 0; i < kFeWords; i++) p[i] = x.v[i];
#endif
}

CBT_QD fe ld_fe(const int32_t* p) {
  fe x;
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < kFeWords; i += 2) {
    const int2 w = *reinterpret_cast<const int2*>(p + i);
    x.v[i] = w.x;
    x.v[i + 1] = w.y;
  }
#else
  for (int i = 0; i < kFeWords; i++) x.v[i] = p[i];
#endif
  return x;
}

// Where a validator's quad keeps its work: `tab`, the validator's 128
// entries (3 x 10 words each); `zs`, its 120 Z's in the scratch. Entries
// with a Z are numbered i = j * 15 + d - 1 (d >= 1), the Z of entry i at
// zs + i * 10. A quad that serves no validator (live false) stores and
// loads nothing but runs in step.
struct TabIO {
  int32_t* tab;
  int32_t* zs;
  bool live;
};

// The word lane `lane` keeps entry i's value at: Y - X is y - x (niels
// component 1), Y + X is y + x (0), 2dT is 2dxy (2); lane 3's Z goes to
// the scratch.
CBT_QD int32_t* lane_slot(const TabIO& io, int i, int lane) {
  const int e = (i / kBaseZs) * TAB_NENT + i % kBaseZs + 1;
  return lane == 3 ? io.zs + i * kFeWords
                   : io.tab + (e * 3 + pick(1, 0, 2, 0, lane)) * kFeWords;
}

// Entry d = 0 of base j, the identity {1, 1, 0}.
template <int W>
CBT_QD void q_put_identity(const TabIO& io, int j) {
#pragma unroll
  for (int k = 0; k < W; k++) {
    const int lane = lane_of<W>(k);
    if (io.live && lane < 3)
      st_fe(io.tab + (j * TAB_NENT * 3 + pick(1, 0, 2, 0, lane)) * kFeWords,
            lane == 2 ? cbt::fe_zero() : cbt::fe_one());
  }
}

// The forward step of entry i, cached form c: r = c pre_{i-1} on every
// lane; lanes 0-2 store r, lane 3 stores its Z; pre becomes r (lane 3's
// is pre_i).
template <int W>
CBT_QD void q_fwd(const TabIO& io, int i, const Q<W>& c, Q<W>& pre) {
  const fe p = lane_fe(pre, 3);
#pragma unroll
  for (int k = 0; k < W; k++) {
    const int lane = lane_of<W>(k);
    pre.v[k] = qfe_mul(c.v[k], p);
    if (io.live) st_fe(lane_slot(io, i, lane), lane == 3 ? c.v[k] : pre.v[k]);
  }
}

// What the lanes stored for entry i going forward.
template <int W>
CBT_QD Q<W> q_stored(const TabIO& io, int i) {
  Q<W> s;
#pragma unroll
  for (int k = 0; k < W; k++)
    s.v[k] = io.live ? ld_fe(lane_slot(io, i, lane_of<W>(k))) : cbt::fe_one();
  return s;
}

// The backward steps of entries hi - 1 down to lo, from inv = inv_{hi-1}
// on lane 3: every lane multiplies what it stored by lane 3's inv_i;
// lanes 0-2 store the canonical entry component, lane 3 keeps inv_{i-1}.
// Entry i - 1's stored values load before entry i's results store, so the
// loads do not wait on the stores.
template <int W>
CBT_QD void q_entries_bwd(const TabIO& io, int lo, int hi, Q<W> inv) {
  Q<W> s = q_stored<W>(io, hi - 1);
  CBT_NO_UNROLL
  for (int i = hi - 1; i >= lo; i--) {
    const Q<W> next = q_stored<W>(io, i > lo ? i - 1 : i);
    const fe p = lane_fe(inv, 3);
#pragma unroll
    for (int k = 0; k < W; k++) {
      const int lane = lane_of<W>(k);
      inv.v[k] = qfe_mul(s.v[k], p);
      if (io.live && lane < 3)
        st_fe(lane_slot(io, i, lane), cbt::fe_canon(inv.v[k]));
    }
    s = next;
  }
}

// Base j's 16 entries, forward: the identity, then [d] base for d = 1..15
// (base, then 14 additions of its cached form), each through q_fwd.
template <int W>
CBT_QD void q_base_fwd(const TabIO& io, int j, const Q<W>& base, Q<W>& pre) {
  q_put_identity<W>(io, j);
  const Q<W> cb = q_cached(base);
  q_fwd(io, j * kBaseZs, cb, pre);
  Q<W> m = base;
  CBT_NO_UNROLL
  for (int d = 2; d < TAB_NENT; d++) {
    q_add(m, cb);
    q_fwd(io, j * kBaseZs + d - 1, q_cached(m), pre);
  }
}

// s = 2^32 s, the step from one base to the next.
template <int W>
CBT_QD void q_dbl_32(Q<W>& s) {
  CBT_NO_UNROLL
  for (int i = 0; i < 32; i++) q_dbl(s);
}

// The quad program, forward, from A's affine (x, y): every base of the
// validator in turn, -A first, 32 doublings between two bases. Returns
// pre, lane 3's the product of the validator's 120 Z's.
template <int W>
CBT_QD Q<W> q_table_fwd(const TabIO& io, const fe& x, const fe& y) {
  Q<W> s = q_neg_affine<W>(x, y), pre;
#pragma unroll
  for (int k = 0; k < W; k++) pre.v[k] = cbt::fe_one();
  CBT_NO_UNROLL
  for (int j = 0; j < TAB_NJ; j++) {
    if (j != 0) q_dbl_32(s);
    q_base_fwd(io, j, s, pre);
  }
  return pre;
}

// The warp program's quad j, forward: base j after all 224 doublings
// (the point after 32 j of them kept by a select, no branch around an
// exchange), then its entries. Returns pre, lane 3's the product of base
// j's 15 Z's.
template <int W>
CBT_QD Q<W> q_warp_fwd(const TabIO& io, int j, const fe& x, const fe& y) {
  Q<W> s = q_neg_affine<W>(x, y), base = s, pre;
  CBT_NO_UNROLL
  for (int b = 1; b < TAB_NJ; b++) {
    q_dbl_32(s);
    if (b == j) base = s;
  }
#pragma unroll
  for (int k = 0; k < W; k++) pre.v[k] = cbt::fe_one();
  q_base_fwd(io, j, base, pre);
  return pre;
}

// Every lane's copy of the inverse `z` (lane 3 reads it as inv_n).
template <int W>
CBT_QD Q<W> q_all(const fe& z) {
  Q<W> r;
#pragma unroll
  for (int k = 0; k < W; k++) r.v[k] = z;
  return r;
}

// The host's runs of the two programs on one validator's 32 key bytes, the
// four lanes on one thread; zs is 120 Z's of scratch. Returns whether A
// decoded.
CBT_QD bool table_quad_host(const uint8_t* pub, int32_t* tab, int32_t* zs) {
  fe x, y;
  const bool ok = decode_key(pub, &x, &y);
  const TabIO io{tab, zs, true};
  const Q<4> pre = q_table_fwd<4>(io, x, y);
  q_entries_bwd<4>(io, 0, kValZs, q_all<4>(cbt::fe_invert(pre.v[3])));
  return ok;
}

CBT_QD bool table_warp_host(const uint8_t* pub, int32_t* tab, int32_t* zs) {
  fe x, y;
  const bool ok = decode_key(pub, &x, &y);
  const TabIO io{tab, zs, true};
  for (int j = 0; j < TAB_NJ; j++) {
    const Q<4> pre = q_warp_fwd<4>(io, j, x, y);
    q_entries_bwd<4>(io, j * kBaseZs, (j + 1) * kBaseZs,
                     q_all<4>(cbt::fe_invert(pre.v[3])));
  }
  return ok;
}

}  // namespace cbt_quad
