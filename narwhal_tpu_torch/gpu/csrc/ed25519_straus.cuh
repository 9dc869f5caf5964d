#pragma once

// A1's per-signature Straus walk and verdict epilogue, shared by
// ed25519_verify.cu (A1, which decompresses A and R in place) and
// ed25519_staged.cu (A4 and A5, which read the points that A3 wrote).
// The operands keep the bound rule of ed25519_field.cuh: A and R are tight
// (decompress outputs, or fe_from13_loose outputs), the table entries are
// pt_cache outputs and the accumulator is four products.

#include "ed25519_field.cuh"

namespace ed25519_straus {

using namespace ed25519_field;

// acc = [S]B + [k](-A) over 64 4-bit windows, MSB first: the 16 cached
// multiples of -A in tab (a per-thread array, local memory), the fixed-base
// table bt, one cached add of each per window after four doublings.
template <typename D>
HD void straus_walk(ge& acc, const ge& A, const D* k_digits, const D* s_digits,
                    const ga* bt, const Consts& k, gc* tab) {
  ge negA;
  pt_neg(negA, A);
  fe_one(tab[0].YpX);
  fe_one(tab[0].YmX);
  fe_one(tab[0].Z);
  fe_zero(tab[0].T2d);
  pt_cache(tab[1], negA, k);
  ge cur = negA;
  for (int i = 2; i < 16; i++) {
    pt_add_cached(cur, cur, tab[1]);
    pt_cache(tab[i], cur, k);
  }
  pt_identity(acc);
  for (int w = 0; w < 64; w++) {
    for (int i = 0; i < 4; i++) pt_double(acc, acc);
    pt_add_cached(acc, acc, tab[((i32)k_digits[w]) & 15]);
    pt_add_cached_z1(acc, acc, bt[((i32)s_digits[w]) & 15]);
  }
}

// Both verdicts from the walk's accumulator and R:
//   strict     encode(acc) == (ry, rs), masked by A's validity;
//   cofactored [8](acc - R) == identity, masked by both validities.
HD void straus_verdict(const ge& acc, const ge& R, const fe& ry, i32 rs, bool a_valid,
                       bool r_valid, const Consts& k, bool& strict, bool& cof) {
  fe zinv, x, y, xc;
  fe_invert(zinv, acc.Z);
  fe_mul(x, acc.X, zinv);
  fe_mul(y, acc.Y, zinv);
  fe_canonical(xc, x);
  strict = fe_eq(y, ry) && ((xc.v[0] & 1) == rs) && a_valid;

  ge negR, diff;
  pt_neg(negR, R);
  pt_add(diff, acc, negR, k);
  for (int i = 0; i < 3; i++) pt_double(diff, diff);
  fe zero;
  fe_zero(zero);
  cof = fe_eq(diff.X, zero) && fe_eq(diff.Y, diff.Z) && a_valid && r_valid;
}

// Entry t of 19 of the shared tables: the fixed-base table's 16 rows
// (radix-2^13 [16][3][20] -> ga), then the curve constants.
HD void load_tables(int t, const i32* bt13, const i32* consts13, ga* bt, Consts& k) {
  if (t < 16) {
    fe_from13(bt[t].YpX, bt13 + (t * 3 + 0) * 20);
    fe_from13(bt[t].YmX, bt13 + (t * 3 + 1) * 20);
    fe_from13(bt[t].T2d, bt13 + (t * 3 + 2) * 20);
  } else if (t < 19) {
    load_consts(t - 16, consts13, k);
  }
}

}  // namespace ed25519_straus
