// ristretto255 decoding and the sr25519 (schnorrkel) verdict of one packed
// column on one thread, over the edwards25519 arithmetic of
// ed25519_core.cuh. The Hopper kernel (sr25519_verify.cu) decodes with
// rist_decode and runs the quad form of the verdict (sr25519_quad.cuh);
// the host build (ed25519_host.cpp) runs both verdicts, and the CPU tests
// hold them against each other and the oracle (crypto/sr25519_ref.py).
#pragma once
#include "ed25519_core.cuh"

namespace cbt {

// RFC 9496 section 4.3.1 DECODE of an encoding s that the host already
// checked to be canonical (s < p) and non-negative (even). Mirrors
// ristretto_ref.decode and the JAX package's sr25519_kernel.rist_decode:
// the square-root ratio is r = w^3 (w^7)^((p-5)/8) with w = v u2^2, the
// checks compare with fe_eq (never limb by limb), and every CT_ABS and
// is_negative test reads the parity of the canonical value (fe_parity).
CBT_HD bool rist_decode(const fe& s, ge_p3* out) {
  const fe one = fe_one();
  const fe ss = fe_sq(s);
  const fe u1 = fe_sub(one, ss);
  const fe u2 = fe_add(one, ss);
  const fe u2s = fe_sq(u2);
  const fe v = fe_neg(fe_add(fe_mul(fe_d(), fe_sq(u1)), u2s));
  const fe w = fe_mul(v, u2s);
  const fe w3 = fe_mul(fe_sq(w), w);
  const fe w7 = fe_mul(fe_sq(w3), w);
  fe r = fe_mul(w3, fe_pow22523(w7));
  const fe check = fe_mul(w, fe_sq(r));
  const bool correct = fe_eq(check, one);
  const bool flipped = fe_is_zero(fe_add(check, one));              // -1
  const bool flipped_i = fe_is_zero(fe_add(check, fe_sqrtm1()));    // -i
  if (flipped || flipped_i) r = fe_mul(r, fe_sqrtm1());
  if (fe_parity(r)) r = fe_neg(r);  // CT_ABS
  const fe den_x = fe_mul(r, u2);
  const fe den_y = fe_mul(fe_mul(r, den_x), v);
  fe x = fe_mul(s, den_x);
  x = fe_add(x, x);
  if (fe_parity(x)) x = fe_neg(x);  // CT_ABS
  const fe y = fe_mul(u1, den_y);
  const fe t = fe_mul(x, y);
  out->X = x;
  out->Y = y;
  out->Z = one;
  out->T = t;
  return (correct || flipped) && fe_parity(t) == 0 && !fe_is_zero(y);
}

// The sr25519 verdict of column `col` of the packed rows (the ed25519
// layout: C_AY holds A's ristretto encoding, C_RY R's, C_S8 the byte
// digits of s, C_H4 the nibble digits of the challenge k = H(transcript)
// mod L, C_FLAGS bit 2 the host precheck). 1 iff both encodings decode,
// the precheck passed, and P1 = [s]B + [k](-A) equals R in the ristretto
// group: X1 Y2 == Y1 X2 or Y1 Y2 == X1 X2 (no cofactor step).
CBT_HD int verify_column_sr(const int32_t* rows, int B, int col,
                            const ge_niels* base) {
  const uint32_t flags = (uint32_t)rows[C_FLAGS * B + col];
  if (((flags >> 2) & 1) == 0) return 0;  // precheck failed or padding

  ge_p3 A, R;
  const bool ok_a = rist_decode(fe_from_packed13(rows, B, C_AY, col), &A);
  const bool ok_r = rist_decode(fe_from_packed13(rows, B, C_RY, col), &R);
  if (!(ok_a && ok_r)) return 0;

  const ge_p3 P1 = sb_minus_ha(rows, B, col, A, base);
  const bool eq1 = fe_eq(fe_mul(P1.X, R.Y), fe_mul(P1.Y, R.X));
  const bool eq2 = fe_eq(fe_mul(P1.Y, R.Y), fe_mul(P1.X, R.X));
  return (eq1 || eq2) ? 1 : 0;
}

}  // namespace cbt
