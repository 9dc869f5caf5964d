#pragma once

// A1's Straus walk and verdict epilogue: the walk shared by
// ed25519_verify.cu (A1, which decompresses A and R in place) and
// ed25519_staged.cu (A4, which reads the points that A3 wrote).
//
// The walk runs on a quad of threads per signature (ed25519_quad.cuh):
// thread l holds coordinate l of the accumulator and builds field l of every
// entry of the signature's 16-entry table of cached multiples of -A, in
// shared memory (16 x 4 fields x 40 B = 2,560 B a signature; thread l reads
// and writes field l only, so no barrier guards it). A window is four
// doublings, a cached add of the -A entry of the k digit and an affine
// cached add of the fixed-base entry of the S digit: 12 product rounds
// against the one-thread form's 47 dependent products. The additions keep
// the JAX order (a digit 0 adds the cached identity; off the curve the
// addition law is not associative), and every quad operation gives the
// one-thread operation's field values mod p, so the walk's accumulator is
// the one-thread walk's.
//
// A1 runs the epilogue on the quad (`quad_verdict`); A5 runs the same
// operations and tests on ten lanes (ed25519_lanes.cuh `verdict_lanes_row`).

#include "ed25519_quad.cuh"

namespace ed25519_straus {

using namespace ed25519_field;
using namespace ed25519_quad;

// Threads a CTA of A1 and A4: two warps of 8 signatures (32, 64 and 128
// threads timed within 0.5 % of one another on the H100, PERF.md section 6).
constexpr int kQuadCta = 64;
constexpr int kWindows = 64;        // 4-bit windows of a 256-bit scalar, MSB first
constexpr int kTabFields = 16 * 4;  // a signature's -A table: 16 entries x 4 fields

// Dynamic shared bytes of a CTA: the -A tables of its kQuadCta / 4 signatures.
// With the static fixed-base table and constants they stay within the 48 KB a
// launch gets without opting in.
constexpr int kQuadSmemBytes = kQuadCta / 4 * kTabFields * (int)sizeof(fe);
static_assert(kQuadSmemBytes + (int)sizeof(ga) * 16 + (int)sizeof(Consts) <= 48 * 1024,
              "A1 and A4 need no shared-memory opt-in");

// Coordinate l of acc = [S]B + [k](-A) over `windows` windows, MSB first:
// a is coordinate l of A, tab the signature's table (thread l uses
// tab[e * 4 + l]), bt the fixed-base table. Entry 0 is the cached identity,
// entry 1 the cached -A, entry e entry e - 1's point plus the cached -A; a
// step's cache and the next add's round-1 product both read only its point,
// so they overlap.
template <typename D, class X>
HD void quad_straus_walk(fe& m, const fe& a, const D* k_digits, const D* s_digits, int windows,
                         const ga* bt, const Consts& k, fe* tab, int l, const X& x) {
  fe cur, o, q1, qe, s, p;
  quad_neg(cur, a, l);
  quad_cached_identity(qe, l);
  tab[l] = qe;
  fe_shfl_xor(o, cur, 1, x);
  quad_cache(q1, cur, o, l, k);
  tab[4 + l] = q1;
  quad_round1(s, cur, o, l);
  fe_mul(p, s, q1);
  for (int e = 2; e < 16; e++) {
    quad_finish(cur, p, l, x);
    fe_shfl_xor(o, cur, 1, x);
    quad_cache(qe, cur, o, l, k);
    tab[e * 4 + l] = qe;
    if (e < 15) {
      quad_round1(s, cur, o, l);
      fe_mul(p, s, q1);
    }
  }
  quad_identity(m, l);
  for (int w = 0; w < windows; w++) {
    // the window's entries, loaded before its doublings
    const fe qa = tab[(((i32)k_digits[w]) & 15) * 4 + l];
    const fe qb = quad_affine_field(bt[((i32)s_digits[w]) & 15], l);
    quad_double<false>(m, l, x);
    quad_double<false>(m, l, x);
    quad_double<false>(m, l, x);
    quad_double<true>(m, l, x);
    quad_add_cached(m, qa, l, x);
    quad_add_cached_z1(m, qb, l, x);
  }
}

// Both verdicts on the quad, from coordinate l of acc (m) and of R (r):
//   strict     encode(acc) == (ry, rs), masked by A's validity;
//   cofactored [8](acc - R) == identity, masked by both validities.
// the strict half gathers X, Y, Z to every thread, which all run the
// inversion in step (one thread's time); the cofactored half is a
// quad_add of -R and three doublings, then X, Y, Z gathered. The same tests
// on the same field values: the same bits.
template <class X>
HD void quad_verdict(const fe& m, const fe& r, const fe& ry, i32 rs, bool a_valid,
                     bool r_valid, const Consts& k, int l, const X& x, bool& strict,
                     bool& cof) {
  fe ax, ay, az, zinv, xc;
  fe_shfl_xor(ax, m, l, x);
  fe_shfl_xor(ay, m, l ^ 1, x);
  fe_shfl_xor(az, m, l ^ 2, x);
  fe_invert(zinv, az);
  fe_mul(ax, ax, zinv);
  fe_mul(ay, ay, zinv);
  fe_canonical(xc, ax);
  strict = fe_eq(ay, ry) && ((xc.v[0] & 1) == rs) && a_valid;

  fe qm, qo, d = m;
  quad_neg(qm, r, l);
  fe_shfl_xor(qo, qm, 1, x);
  quad_add(d, qm, qo, l, k, x);
  for (int i = 0; i < 3; i++) quad_double<false>(d, l, x);
  fe dx, dy, dz, zero;
  fe_shfl_xor(dx, d, l, x);
  fe_shfl_xor(dy, d, l ^ 1, x);
  fe_shfl_xor(dz, d, l ^ 2, x);
  fe_zero(zero);
  cof = fe_eq(dx, zero) && fe_eq(dy, dz) && a_valid && r_valid;
}

// A4 for row b on quad thread l: coordinate l of A from the stage layout
// int32 [4, 20, B], the walk, coordinate l of acc into the same layout. A
// quad with `store` false (past the batch, on a copy of a live row) stores
// nothing.
template <typename D, class X>
HD void straus_quad_row(const i32* a_pt, const D* k_digits, const D* s_digits, int windows,
                        const ga* bt, const Consts& k, fe* tab, i32* acc_pt, int B, int b,
                        int l, const X& x, bool store) {
  fe a, m;
  fe_from13_loose(a, a_pt + (size_t)l * 20 * B + b, B);
  quad_straus_walk(m, a, k_digits + (size_t)b * windows, s_digits + (size_t)b * windows,
                   windows, bt, k, tab, l, x);
  if (store) fe_to13(m, acc_pt + (size_t)l * 20 * B + b, B);
}

// A1 for row b on quad thread l. Threads 0 and 2 decompress A, 1 and 3 R,
// all four at once in one code path (2 and 3 on copies); A's and R's
// coordinates then go to the quad from threads 0 and 1. Thread 0 stores the
// verdicts.
template <typename L, typename S, typename D, class X>
HD void verify_quad_row(const L* a_y, const S* a_sign, const L* r_y, const S* r_sign,
                        const D* k_digits, const D* s_digits, const ga* bt, const Consts& k,
                        fe* tab, bool* out_strict, bool* out_cof, int b, int l, const X& x,
                        bool store) {
  fe y, a, r;
  fe_from13(y, ((l & 1) ? r_y : a_y) + (size_t)b * 20);
  ge P;
  const bool ok = decompress(P, y, (i32)((l & 1) ? r_sign : a_sign)[b], k);
  const bool a_valid = x.shfl_xor((i32)ok, l) != 0;
  const bool r_valid = x.shfl_xor((i32)ok, l ^ 1) != 0;
  quad_take(a, P, 0, l, x);
  quad_take(r, P, 1, l, x);
  fe m;
  quad_straus_walk(m, a, k_digits + (size_t)b * kWindows, s_digits + (size_t)b * kWindows,
                   kWindows, bt, k, tab, l, x);
  fe ry;
  fe_from13(ry, r_y + (size_t)b * 20);
  bool strict, cof;
  quad_verdict(m, r, ry, (i32)r_sign[b], a_valid, r_valid, k, l, x, strict, cof);
  if (store && l == 0) {
    out_strict[b] = strict;
    out_cof[b] = cof;
  }
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
