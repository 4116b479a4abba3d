// The cached-valset ZIP-215 verdict of one packed column computed by a
// quad: ed25519_quad.cuh's four lanes (lane k holds coordinate k of
// (X, Y, T, Z) and component k of every addend), its addition, doubling
// and niels gather, over the valset table of ed25519_cached.cuh. Every
// function is a template on W, the lanes one caller holds: W = 1 on the
// card (ed25519_cached_verify.cu), W = 4 on the host (ed25519_host.cpp),
// which so runs the kernel's lane program, exchange for exchange.
//
// The column is the same double-scalar multiplication as
// cbt::verify_column_cached, the one-thread host reference: no per-
// signature table (the valset table holds [d](2^(32 j)(-A)) as affine niels
// entries, which q_niels gathers by lane as it gathers the base comb's), no
// decoding of A, and 28 doublings instead of 252. R's square-root chain
// runs apart, in decode_r_cached, one column a thread.
#pragma once
#include "ed25519_cached.cuh"
#include "ed25519_quad.cuh"

namespace cbt_quad {

// R's x for column `col` of the cached rows under ZIP-215; 0 where the
// precheck failed (V_FLAGS bit 1; a padding column has it clear), where
// validator col mod M has no decoded key (ok), or where R does not decode.
// V_FLAGS bit 0 is R's sign. One thread, the out-of-line field ops of
// ed25519_core.cuh, as decode_point.
CBT_QD int decode_r_cached(const int32_t* rows, int B, int col, int M,
                           const uint8_t* ok, fe* x) {
  using namespace cbt;
  const uint32_t flags = (uint32_t)rows[V_FLAGS * B + col];
  if (((flags >> 1) & 1) == 0 || !ok[col % M]) return 0;
  ge_p3 R;
  const int dec = ge_decompress(fe_from_packed13(rows, B, V_RY, col),
                                flags & 1, &R);
  *x = R.X;
  return dec;
}

// The quad's program for column `col`, validator col mod M, whose R
// decoded to x = xR: 1 iff [8]([h](-A) + [s]B - R) is the identity. [h](-A)
// is a Horner loop over 8 windows of 4 doublings; window w adds, for
// j = 0..7, the table entry of base j at nibble 8 j + w of h (nibble j of
// h row w). [s]B is the general kernel's 32-window comb over `base`. Every
// lane returns the verdict; no branch on the lane or the data around an
// exchange, so a warp whose columns are padding or failed runs it in step
// (the kernel masks those verdicts).
template <int W>
CBT_QD int quad_verdict_cached(const int32_t* rows, int B, int col,
                               const cbt::ge_niels* tab, int M,
                               const cbt::ge_niels* base, const fe& xR) {
  using namespace cbt;
  const ge_niels* t = tab + (size_t)(col % M) * TAB_PER_VAL;
  // the identity (0, 1, 0, 1)
  Q<W> acc;
#pragma unroll
  for (int k = 0; k < W; k++)
    acc.v[k] = (lane_of<W>(k) & 1) ? fe_one() : fe_zero();
  for (int w = TAB_NJ - 1; w >= 0; w--) {
    if (w != TAB_NJ - 1)
      for (int i = 0; i < 4; i++) q_dbl(acc);
    const uint32_t word = (uint32_t)rows[(V_H4 + w) * B + col];
    for (int j = 0; j < TAB_NJ; j++)
      q_add(acc, q_niels<W>(t, j * TAB_NENT + ((word >> (4 * j)) & 15)));
  }

  // + [s]B: 32 width-8 comb windows, one integer gather each
  for (int w = 0; w < 32; w++) {
    const uint32_t word = (uint32_t)rows[(V_S8 + (w & 7)) * B + col];
    q_add(acc, q_niels<W>(base, w * 256 + ((word >> (8 * (w >> 3))) & 255)));
  }

  // - R, then the cofactor: [8]W == identity <=> X == 0 and Y == Z
  const fe yR = fe_from_packed13(rows, B, V_RY, col);
  q_add(acc, q_cached(q_neg_affine<W>(xR, yR)));
  for (int i = 0; i < 3; i++) q_dbl(acc);
  const fe x = lane_fe(acc, 0), y = lane_fe(acc, 1), z = lane_fe(acc, 3);
  return (fe_is_zero(x) && fe_eq(y, z)) ? 1 : 0;
}

// The verdict of column `col`, the same as cbt::verify_column_cached, with
// the quad's four lanes on one thread (the host's run of the kernel's
// program).
CBT_QD int verify_column_cached_quad(const int32_t* rows, int B, int col,
                                     const cbt::ge_niels* tab, int M,
                                     const uint8_t* ok,
                                     const cbt::ge_niels* base) {
  fe xR;
  if (!decode_r_cached(rows, B, col, M, ok, &xR)) return 0;
  return quad_verdict_cached<4>(rows, B, col, tab, M, base, xR);
}

}  // namespace cbt_quad
