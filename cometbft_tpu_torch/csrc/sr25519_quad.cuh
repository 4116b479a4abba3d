// The sr25519 (schnorrkel) verdict of one packed column computed by a quad:
// the ristretto decoding of ristretto_core.cuh, then the quad's double-
// scalar multiplication of ed25519_quad.cuh (q_sb_minus_ha) and the
// ristretto equality with R, with the same lanes, exchanges and W
// template: W = 1 on the card (sr25519_verify.cu), W = 4 on the host
// (ed25519_host.cpp), which so runs the kernel's lane program.
#pragma once
#include "ed25519_quad.cuh"
#include "ristretto_core.cuh"

namespace cbt_quad {

// Decodes point `which` (0: A, 1: R) of column `col` from its ristretto
// encoding into its affine x and y; 0 where the precheck failed (or the
// column is padding) or the encoding does not decode. One thread, the
// out-of-line field ops, as decode_point.
CBT_QD int decode_point_sr(const int32_t* rows, int B, int col, int which,
                           fe* x, fe* y) {
  using namespace cbt;
  const uint32_t flags = (uint32_t)rows[C_FLAGS * B + col];
  if (((flags >> 2) & 1) == 0) return 0;
  ge_p3 P;
  const int ok =
      rist_decode(fe_from_packed13(rows, B, which ? C_RY : C_AY, col), &P);
  *x = P.X;
  *y = P.Y;
  return ok;
}

// Slot k's flag ORed with that of lane k ^ 2: after it every lane of the
// quad holds the OR of one flag of each lane pair.
template <int W>
CBT_QD void q_or_pairs(int (&f)[W]) {
#if defined(__CUDA_ARCH__)
  if (W == 1) {
    f[0] |= __shfl_xor_sync(0xffffffffu, f[0], 2, 4);
    return;
  }
#endif
  int r[W];
#pragma unroll
  for (int k = 0; k < W; k++) r[k] = f[k] | f[(lane_of<W>(k) ^ 2) % W];
#pragma unroll
  for (int k = 0; k < W; k++) f[k] = r[k];
}

// The quad's program for column `col` whose A and R decoded to (xA, yA)
// and (xR, yR): 1 iff P1 = [s]B + [k](-A) equals R in the ristretto group,
// X1 yR == Y1 xR or Y1 yR == X1 xR (verify_column_sr). Lanes 0..3 form
// the four products X1 yR, Y1 xR, Y1 yR, X1 xR, one a lane; lane pairs
// compare theirs (one exchange), and the two pairs' results are ORed (a
// second). Every lane returns the verdict; no branch on the lane or the
// data around an exchange, as quad_verdict. The table needs kMulEntries
// entries (no -R).
template <int W>
CBT_QD int quad_verdict_sr(const int32_t* rows, int B, int col,
                           const cbt::ge_niels* base, QTab<W>& tab,
                           const fe& xA, const fe& yA, const fe& xR,
                           const fe& yR) {
  const Q<W> acc =
      q_sb_minus_ha(rows, B, col, base, tab, q_neg_affine<W>(xA, yA));
  const Q<W> c = q_shfl(acc, 0, 1, 1, 0);  // X1, Y1, Y1, X1
  Q<W> p;
#pragma unroll
  for (int k = 0; k < W; k++)
    p.v[k] = qfe_mul(c.v[k], (lane_of<W>(k) & 1) ? xR : yR);
  const Q<W> o = q_shfl(p, 1, 0, 3, 2);
  int eq[W];
#pragma unroll
  for (int k = 0; k < W; k++) eq[k] = cbt::fe_eq(p.v[k], o.v[k]) ? 1 : 0;
  q_or_pairs(eq);
  return eq[0];
}

// The verdict of column `col`, the same as cbt::verify_column_sr, with the
// quad's four lanes on one thread (the host's run of the kernel's
// program).
CBT_QD int verify_column_sr_quad(const int32_t* rows, int B, int col,
                                 const cbt::ge_niels* base, QTab<4>& tab) {
  fe xA, yA, xR, yR;
  const int okA = decode_point_sr(rows, B, col, 0, &xA, &yA);
  const int okR = decode_point_sr(rows, B, col, 1, &xR, &yR);
  if (!(okA && okR)) return 0;
  return quad_verdict_sr<4>(rows, B, col, base, tab, xA, yA, xR, yR);
}

}  // namespace cbt_quad
