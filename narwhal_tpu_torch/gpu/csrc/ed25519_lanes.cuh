#pragma once

// A3's decompression and A5's verdicts on a group of ten lanes a row, one
// radix-2^25.5 limb a lane: the kernels of ed25519_staged.cu's
// verify_decompress and verify_verdict (lanes 0..29 of a warp are three
// groups; lanes 30 and 31 run along and store nothing). The one-thread
// `decompress` of ed25519_field.cuh stays as it is for A1 and A2.
//
// Lane q holds limb q of every field element of the chain. A product h = f*g
// is column q on lane q: h_q = sum_j f[(q - j) mod 10] g[j], the f index
// wrapping past 0 with a factor 19 (2^255 = 19 mod p) and the term doubled
// when both limbs are odd, which for an odd j happens exactly when q is even.
// So each lane gathers g[j] from lane j and f[(q - j) mod 10] from lane
// (q - j) mod 10 (twenty shuffles, a per-lane source: the rotation costs no
// select), scales f by its lane's 19-or-1 per j and doubles g's odd limbs on
// even lanes, and forms ten multiply-adds. Bounds as fe_mul's: operand limbs
// at most 19 * 1.65 * 2^26 < 2^31 and 2 * 1.65 * 2^25, a column < 2^61.1.
// A squaring (255 of A3's 275 operations, 266 of A5's 300) takes each of
// its column's equal pairs once, doubled, as fe_sq does: twelve shuffles
// and six products (`lsq`).
//
// The carry is two parallel passes (each column's rounded high part moves to
// the next column, 19 times from column 9 into column 0), split by column:
// lane q takes columns q - 2 and q - 1 from their lanes (one exchange), runs
// pass 1 on the three and pass 2 on the two it needs, and keeps limb q. After
// the passes every limb is within 2^(radix - 1) + 2^17 (tight, as
// fe_reduce64's output) and the value is the same mod p. Where the chain
// needs the whole value (the equality tests, the sign, the stores) the ten
// limbs are gathered to every lane and the one-thread code of
// ed25519_field.cuh runs on them; outputs are canonical, so they equal
// `decompress`'s bit for bit.
//
// Every function is HD and takes the lane's constants; the exchange is one
// call, `x.shfl(v, src)` (src a lane of the group): on the card
// `Lanes10Shfl`, on the host a harness over ten threads, which runs the same
// code on the CPU.

#include <stddef.h>  // size_t for ed25519_field.cuh under a host compiler

#include "ed25519_field.cuh"

namespace ed25519_lanes {

using namespace ed25519_field;

constexpr int kLanes = 10;

// Lane q's constants, fixed for the kernel's life.
struct Lane {
  int q;
  int src[kLanes];    // the lane holding f[(q - j) mod 10]
  i32 wrap[kLanes];   // 19 where q - j wraps past 0, else 1
  int dbl;            // 1 on even lanes: g's odd limbs doubled
  int sa[6], sb[6];   // a squaring's factor pairs of column q (a + b = q mod 10)
  i32 ma[6], mb[6];   // their multipliers: ma 0, 1 or 2, mb 19 on a wrap, 2 if both odd
  int sh0, sh1;       // the radix bits of columns q (and q - 2), q - 1
  i64 in0, in1;       // 19 where column q (q - 1) takes column 9's carry
  int prev, prev2;    // the lanes of columns q - 1 and q - 2
};

HD Lane lane_of(int q) {
  Lane l;
  l.q = q;
#pragma unroll
  for (int j = 0; j < kLanes; j++) {
    l.src[j] = (q - j + kLanes) % kLanes;
    l.wrap[j] = j > q ? 19 : 1;
  }
  // Column q of f^2 pairs f[a] f[b] with f[b] f[a]: a = ceil(q/2) + k and
  // b = floor(q/2) - k (mod 10), k = 0..5, take each pair once and double
  // it. On an odd lane k = 0..4 are the five pairs and k = 5 a spare (ma
  // 0); on an even lane k = 0 and 5 are the squares f[q/2]^2 and
  // f[q/2 + 5]^2 (once) and k = 1..4 the pairs. mb carries the wrap (a + b
  // >= 10) and the odd-odd doubling, at most 38 on an odd limb: every
  // operand fits int32 as in fe_sq, a product < 2^58.7, a column < 2^61.3.
#pragma unroll
  for (int k = 0; k < 6; k++) {
    const int a = ((q + 1) / 2 + k) % kLanes, b = (q / 2 - k + kLanes) % kLanes;
    l.sa[k] = a;
    l.sb[k] = b;
    l.ma[k] = (q & 1) ? (k < 5 ? 2 : 0) : (k == 0 || k == 5 ? 1 : 2);
    l.mb[k] = (a + b >= kLanes ? 19 : 1) * ((a & 1) && (b & 1) ? 2 : 1);
  }
  l.dbl = (q & 1) ? 0 : 1;
  l.sh0 = (q & 1) ? 25 : 26;
  l.sh1 = 51 - l.sh0;
  l.in0 = q == 0 ? 19 : 1;
  l.in1 = q == 1 ? 19 : 1;
  l.prev = (q + kLanes - 1) % kLanes;
  l.prev2 = (q + kLanes - 2) % kLanes;
  return l;
}

// Rounded split of h at s bits: h = lo + c * 2^s, |lo| <= 2^(s - 1).
HD i64 carry_of(i64 h, int s) { return (h + ((i64)1 << (s - 1))) >> s; }

// Limb q of the carried value whose column q is h0 (the passes above).
template <class X>
HD i32 carry_lane(i64 h0, const Lane& l, const X& x) {
  const i64 h1 = x.shfl(h0, l.prev), h2 = x.shfl(h0, l.prev2);
  // pass 1 on columns q - 2, q - 1, q; pass 2 on q - 1 and q
  const i64 c2 = carry_of(h2, l.sh0), c1 = carry_of(h1, l.sh1), c0 = carry_of(h0, l.sh0);
  const i64 g1 = h1 - c1 * ((i64)1 << l.sh1) + c2 * l.in1;
  const i64 g0 = h0 - c0 * ((i64)1 << l.sh0) + c1 * l.in0;
  const i64 d1 = carry_of(g1, l.sh1), d0 = carry_of(g0, l.sh0);
  return (i32)(g0 - d0 * ((i64)1 << l.sh0) + d1 * l.in0);
}

// r = f * g, limb q: twenty shuffles, ten products.
template <class X>
HD i32 lmul(i32 f, i32 g, const Lane& l, const X& x) {
  i64 even = 0, odd = 0;  // two chains of five, for a shorter dependent path
#pragma unroll
  for (int j = 0; j < kLanes; j += 2) {
    fe_mac(even, x.shfl(f, l.src[j]) * l.wrap[j], x.shfl(g, j));
    fe_mac(odd, x.shfl(f, l.src[j + 1]) * l.wrap[j + 1],
           (i32)((uint32_t)x.shfl(g, j + 1) << l.dbl));
  }
  return carry_lane(even + odd, l, x);
}

// r = 2^sh f^2 (sh 0 or 1), limb q: twelve shuffles, six products (the
// pairs of lane_of); the column shifted before the carry, as fe_sq_shl (a
// doubled column < 2^62.3).
template <class X>
HD i32 lsq(i32 f, const Lane& l, const X& x, int sh = 0) {
  i64 even = 0, odd = 0;
#pragma unroll
  for (int k = 0; k < 6; k += 2) {
    fe_mac(even, x.shfl(f, l.sa[k]) * l.ma[k], x.shfl(f, l.sb[k]) * l.mb[k]);
    fe_mac(odd, x.shfl(f, l.sa[k + 1]) * l.ma[k + 1], x.shfl(f, l.sb[k + 1]) * l.mb[k + 1]);
  }
  return carry_lane((i64)((uint64_t)(even + odd) << sh), l, x);
}

template <class X>
HD i32 lsq_times(i32 a, int n, const Lane& l, const X& x) {
  for (int i = 0; i < n; i++) a = lsq(a, l, x);
  return a;
}

// fe_ladder's chain, limb q: t1 = z^(2^250 - 1), z11 = z^11.
template <class X>
HD void lladder(i32& t1, i32& z11, i32 z, const Lane& l, const X& x) {
  i32 t0 = lsq(z, l, x);
  t1 = lsq_times(t0, 2, l, x);
  t1 = lmul(z, t1, l, x);           // z^9
  t0 = lmul(t0, t1, l, x);          // z^11
  z11 = t0;
  i32 t2 = lsq(t0, l, x);
  t1 = lmul(t1, t2, l, x);          // z^31
  t2 = lsq_times(t1, 5, l, x);
  t1 = lmul(t2, t1, l, x);          // 2^10-1
  t2 = lsq_times(t1, 10, l, x);
  t2 = lmul(t2, t1, l, x);          // 2^20-1
  i32 t3 = lsq_times(t2, 20, l, x);
  t2 = lmul(t3, t2, l, x);          // 2^40-1
  t2 = lsq_times(t2, 10, l, x);
  t1 = lmul(t2, t1, l, x);          // 2^50-1
  t2 = lsq_times(t1, 50, l, x);
  t2 = lmul(t2, t1, l, x);          // 2^100-1
  t3 = lsq_times(t2, 100, l, x);
  t2 = lmul(t3, t2, l, x);          // 2^200-1
  t2 = lsq_times(t2, 50, l, x);
  t1 = lmul(t2, t1, l, x);          // 2^250-1
}

// fe_pow22523, limb q: z^(2^252 - 3).
template <class X>
HD i32 lpow22523(i32 z, const Lane& l, const X& x) {
  i32 t1, z11;
  lladder(t1, z11, z, l, x);
  return lmul(lsq_times(t1, 2, l, x), z, l, x);
}

// fe_invert, limb q: z^(p - 2).
template <class X>
HD i32 linvert(i32 z, const Lane& l, const X& x) {
  i32 t1, z11;
  lladder(t1, z11, z, l, x);
  return lmul(lsq_times(t1, 5, l, x), z11, l, x);
}

// The whole element from its ten lanes, on every lane.
template <class X>
HD void gather(fe& r, i32 v, const X& x) {
#pragma unroll
  for (int j = 0; j < kLanes; j++) r.v[j] = x.shfl(v, j);
}

// Limb q of a whole element (a select chain: no indexed register).
HD i32 limb(const fe& a, int q) {
  i32 v = a.v[0];
#pragma unroll
  for (int j = 1; j < kLanes; j++) v = q == j ? a.v[j] : v;
  return v;
}

// `decompress` (ed25519_field.cuh) with every product on the ten lanes and
// the data-dependent steps as selects; X, Y, Z, T whole on every lane.
template <class X>
HD bool decompress_lanes(ge& p, const fe& y, i32 sign, const Consts& k, const Lane& l,
                         const X& x) {
  const i32 yq = limb(y, l.q);
  const i32 y2 = lsq(yq, l, x);
  const i32 u = y2 - (l.q == 0);                     // y^2 - 1
  const i32 v = lmul(y2, limb(k.d, l.q), l, x) + (l.q == 0);  // d y^2 + 1
  i32 v3 = lsq(v, l, x);
  v3 = lmul(v3, v, l, x);
  i32 v7 = lsq(v3, l, x);
  v7 = lmul(v7, v, l, x);
  i32 t = lmul(u, v7, l, x);
  t = lpow22523(t, l, x);
  i32 xr = lmul(u, v3, l, x);
  xr = lmul(xr, t, l, x);
  i32 vx2 = lsq(xr, l, x);
  vx2 = lmul(vx2, v, l, x);
  const i32 m = lmul(xr, limb(k.sqrtm1, l.q), l, x);
  fe fv, fu, fn, xw, xc;
  gather(fv, vx2, x);
  gather(fu, u, x);
  const bool correct = fe_eq(fv, fu);
  fe_neg(fn, fu);
  const bool flipped = fe_eq(fv, fn);
  bool valid = correct || flipped;
  xr = flipped ? m : xr;
  gather(xw, xr, x);
  fe_canonical(xc, xw);
  const bool x_zero = fe_is_zero_canonical(xc);
  valid = valid && !(x_zero && sign == 1);
  const bool neg = (xc.v[0] & 1) != sign;
  xr = neg ? -xr : xr;
#pragma unroll
  for (int j = 0; j < kLanes; j++) xw.v[j] = neg ? -xw.v[j] : xw.v[j];
  p.X = xw;
  p.Y = y;
  fe_one(p.Z);
  gather(p.T, lmul(xr, yq, l, x), x);
  return valid;
}

// fe_to13's radix-2^13 limbs of a's canonical value, one lane's share:
// limbs first, first + step, ... (n of them) at out[i * stride]. `first` may
// differ between lanes, so the word holding a limb is picked by selects (no
// indexed register).
HD void fe_to13_limbs(const fe& a, i32* out, int stride, int first, int step, int n) {
  fe c;
  fe_canonical(c, a);
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
  uint32_t w[9];
#pragma unroll
  for (int i = 0; i < 9; i++) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const uint64_t v = (uint64_t)(uint32_t)c.v[i] << (off[i] & 31);
    w[off[i] >> 5] |= (uint32_t)v;
    w[(off[i] >> 5) + 1] |= (uint32_t)(v >> 32);
  }
  for (int s = 0; s < n; s++) {
    const int i = first + s * step;
    const int bit = 13 * i;
    uint32_t lo = w[0], hi = w[1];
#pragma unroll
    for (int j = 1; j < 8; j++) {
      lo = (bit >> 5) == j ? w[j] : lo;
      hi = (bit >> 5) == j ? w[j + 1] : hi;
    }
    const uint64_t v = (uint64_t)lo | ((uint64_t)hi << 32);
    out[(size_t)i * stride] = (i32)((v >> (bit & 31)) & 0x1FFFu);
  }
}

// A3 for row b: lane q stores limbs 2q and 2q + 1 of each coordinate, lane 0
// the valid bit; a lane with `store` false (a spare lane, or a group past
// the batch on a copy of the last row) runs the chain and stores nothing.
template <typename L, typename S, class X>
HD void decompress_lanes_row(const L* y, const S* sign, const Consts& k, i32* pts, bool* valid,
                             int B, int b, const Lane& l, const X& x, bool store = true) {
  fe yf;
  fe_from13(yf, y + (size_t)b * 20);
  ge P;
  const bool v = decompress_lanes(P, yf, (i32)sign[b], k, l, x);
  if (!store) return;
  fe_to13_limbs(P.X, pts + (size_t)0 * 20 * B + b, B, 2 * l.q, 1, 2);
  fe_to13_limbs(P.Y, pts + (size_t)1 * 20 * B + b, B, 2 * l.q, 1, 2);
  fe_to13_limbs(P.Z, pts + (size_t)2 * 20 * B + b, B, 2 * l.q, 1, 2);
  fe_to13_limbs(P.T, pts + (size_t)3 * 20 * B + b, B, 2 * l.q, 1, 2);
  if (l.q == 0) valid[b] = v;
}

// -- A5: the verdicts on the lanes ---------------------------------------------

// Limb q of a point's four coordinates.
struct LPt {
  i32 X, Y, Z, T;
};

// Limb q of the coordinate at base[i * B + b], i < 20, in the stage layout
// (radix 2^13, limbs canonical or the plain versions' loose ones). Limbs 2q
// and 2q + 1 begin inside column q (13 * 2q = ceil(25.5 q) + floor(q / 2)),
// so the lane loads those two, forms column q's loose value and carries it
// (carry_lane): the same value mod p as fe_from13_loose, two loads a
// coordinate.
template <class X>
HD i32 load_limb(const i32* base, int B, int b, const Lane& l, const X& x) {
  const int s = l.q >> 1;
  const i64 lo = base[(size_t)(2 * l.q) * B + b], hi = base[(size_t)(2 * l.q + 1) * B + b];
  return carry_lane(lo * ((i64)1 << s) + hi * ((i64)1 << (s + 13)), l, x);
}

template <class X>
HD LPt load_point(const i32* pt, int B, int b, const Lane& l, const X& x) {
  return {load_limb(pt, B, b, l, x), load_limb(pt + (size_t)20 * B, B, b, l, x),
          load_limb(pt + (size_t)40 * B, B, b, l, x), load_limb(pt + (size_t)60 * B, B, b, l, x)};
}

// pt_add (the complete addition), limb q; d2 is limb q of 2d. Operands as
// pt_add's: sums of at most two tight values.
template <class X>
HD LPt ladd(const LPt& p, const LPt& q, i32 d2, const Lane& l, const X& x) {
  const i32 a = lmul(p.Y - p.X, q.Y - q.X, l, x);
  const i32 b = lmul(p.Y + p.X, q.Y + q.X, l, x);
  const i32 c = lmul(lmul(p.T, d2, l, x), q.T, l, x);
  const i32 d = lmul(p.Z + p.Z, q.Z, l, x);
  const i32 e = b - a, f = d - c, g = d + c, h = b + a;
  return {lmul(e, f, l, x), lmul(g, h, l, x), lmul(f, g, l, x), lmul(e, h, l, x)};
}

// pt_double, limb q: 2 Z^2 comes carried out of its squaring (lsq's shift),
// so e and f are sums of three tight values, as in pt_double.
template <class X>
HD LPt ldouble(const LPt& p, const Lane& l, const X& x) {
  const i32 a = lsq(p.X, l, x), b = lsq(p.Y, l, x), c = lsq(p.Z, l, x, 1);
  const i32 t = lsq(p.X + p.Y, l, x);
  const i32 h = a + b, e = h - t, g = a - b, f = c + g;
  return {lmul(e, f, l, x), lmul(g, h, l, x), lmul(f, g, l, x), lmul(e, h, l, x)};
}

// The strict test: encode(acc) == (ry, rs). x = X / Z and y = Y / Z on the
// lanes, then gathered: the one-thread tests on canonical values.
template <class X>
HD bool strict_lanes(const LPt& acc, const fe& ry, i32 rs, const Lane& l, const X& x) {
  const i32 zinv = linvert(acc.Z, l, x);
  fe xw, yw, xc;
  gather(xw, lmul(acc.X, zinv, l, x), x);
  gather(yw, lmul(acc.Y, zinv, l, x), x);
  fe_canonical(xc, xw);
  return fe_eq(yw, ry) && ((xc.v[0] & 1) == rs);
}

// The cofactored test: [8](acc - R) == identity (X == 0 and Y == Z).
template <class X>
HD bool cof_lanes(const LPt& acc, const LPt& r, i32 d2, const Lane& l, const X& x) {
  LPt d = ladd(acc, {-r.X, r.Y, r.Z, -r.T}, d2, l, x);
#pragma unroll
  for (int i = 0; i < 3; i++) d = ldouble(d, l, x);
  fe dx, dy, dz, zero;
  gather(dx, d.X, x);
  gather(dy, d.Y, x);
  gather(dz, d.Z, x);
  fe_zero(zero);
  return fe_eq(dx, zero) && fe_eq(dy, dz);
}

// A5 for row b: the JAX stage's two verdicts, strict masked by A's
// validity, cofactored by both. The halves are independent; the cofactored
// one (33 operations, rounds of four) comes first, in one basic block with
// the head of the inversion's ladder (straight-line code up to its first
// loop of squarings), so the compiler can interleave the two chains. Lane 0
// of a group with `store` stores the bits.
template <typename L, typename S, class X>
HD void verdict_lanes_row(const i32* acc_pt, const i32* r_pt, const L* r_y, const S* r_sign,
                          const bool* a_valid, const bool* r_valid, i32 d2, bool* strict,
                          bool* cof, int B, int b, const Lane& l, const X& x, bool store = true) {
  const LPt acc = load_point(acc_pt, B, b, l, x), r = load_point(r_pt, B, b, l, x);
  fe ry;
  fe_from13(ry, r_y + (size_t)b * 20);
  const i32 rs = (i32)r_sign[b];
  const bool c = cof_lanes(acc, r, d2, l, x);
  const bool s = strict_lanes(acc, ry, rs, l, x);
  if (store && l.q == 0) {
    strict[b] = s && a_valid[b];
    cof[b] = c && a_valid[b] && r_valid[b];
  }
}

#ifdef __CUDACC__
// The card's exchange: the group of ten lanes starting at `base`. Every lane
// of the warp shuffles (a constant full mask, so the compiler adds no
// convergence check); a spare lane's sources wrap and it stores nothing.
struct Lanes10Shfl {
  int base;
  __device__ __forceinline__ i32 shfl(i32 v, int src) const {
    return __shfl_sync(0xffffffffu, v, base + src);
  }
  __device__ __forceinline__ i64 shfl(i64 v, int src) const {
    return __shfl_sync(0xffffffffu, v, base + src);
  }
};
#endif

}  // namespace ed25519_lanes
