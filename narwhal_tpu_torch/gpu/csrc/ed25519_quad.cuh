#pragma once

// Point operations on a quad: four threads of a warp run one extended-
// Edwards operation of ed25519_field.cuh, thread l holding coordinate l of
// the point (X, Y, Z, T) and field l of a cached point (Y - X, Y + X, Z,
// 2dT). Each operation is two rounds of four independent field products, one
// product a thread a round, the operands exchanged between rounds:
//   - the cached add (pt_add_cached): round 1 the products a, b, d, c of
//     (Y - X, Y + X, 2Z, T) by the cached fields; round 2 X3 = e f, Y3 = g h,
//     Z3 = f g, T3 = e h from e = b - a, f = d - c, g = d + c, h = b + a.
//     2 products deep instead of 8;
//   - the affine cached add (pt_add_cached_z1): the same, with d = 2Z an
//     addition on thread 2;
//   - the complete add (pt_add): round 1 after one product for (Y - X,
//     Y + X, 2Z, 2dT); 3 deep instead of 9;
//   - the doubling (pt_double): round 1 the squarings X^2, Y^2, 2Z^2,
//     (X + Y)^2; round 2 the same four products of E, F, G, H. 2 deep
//     instead of 8. A doubling whose T no later operation reads (every
//     doubling but one before an add) skips thread 3's round-2 product;
//   - the cache of a point: one product a thread (by one, or by 2d on
//     thread 3), so every cached field is tight.
// Users: ed25519_msm.cu (A2, A6: tables, chains and the tree),
// ed25519_straus.cuh (A1, A4: the Straus walk and A1's verdict).
//
// The exchange is one call, `x.shfl_xor(v, m)` for a field element or an
// int32 (v of thread l ^ m of the quad; m may differ between threads): on
// the card `QuadShfl` (__shfl_xor_sync over the full warp: every thread of
// the warp must call it), on the host a harness over four threads, so every
// function here is HD and runs on the CPU too (tests/test_torch_quad_walk.py).
//
// Bounds: every operand keeps the rule of ed25519_field.cuh (a signed sum of
// at most 3 tight values). What a quad thread holds between operations is a
// product output (tight): a coordinate, a round-1 product, a cached field.
//   - Cached adds: round 1 takes Y -/+ X, 2Z or T of tight coordinates (2
//     tight at most) times a tight cached field; round 2 b -/+ a, d -/+ c of
//     tight products (2 tight). In the affine add d = 2Z (2 tight), so f =
//     d - c and g = d + c are 3 tight, as in pt_add_cached_z1.
//   - The complete add: the addend's Y2 -/+ X2, Z2, T2 (2 tight) times the
//     sum's round-1 product (tight).
//   - The doubling: round 1 squares X, Y, Z (tight) or X + Y (2 tight), and
//     thread 2 doubles Z^2 inside the squaring's carry chain (fe_sq_shl,
//     tight: pt_double's carried 2Z^2); round 2 takes E = X^2 + Y^2 -
//     (X + Y)^2 (3 tight), F = 2Z^2 + X^2 - Y^2 (3 tight), G = X^2 - Y^2
//     and H = X^2 + Y^2 (2 tight): pt_double's operands.
//   - The identity, the staged points and their negations are tight
//     (decompress and fe_from13_loose outputs).
// So a quad operation gives the same field values mod p as its one-thread
// form, and the products' order is the one-thread form's.

#include <stddef.h>  // size_t for ed25519_field.cuh under a host compiler

#include "ed25519_field.cuh"

namespace ed25519_quad {

using namespace ed25519_field;

// Round 1 of a cached add in quad thread l, whose coordinate is m and whose
// xor-1 partner's is o (X <-> Y, Z <-> T): the left factor Y - X, Y + X, 2Z
// or T; times field l of the cached point it is a, b, d or c.
HD void quad_round1(fe& s, const fe& m, const fe& o, int l) {
  const i32 km = l == 0 ? -1 : l == 2 ? 2 : 1;
  const i32 ko = l < 2 ? 1 : 0;
#pragma unroll
  for (int i = 0; i < 10; i++) s.v[i] = km * m.v[i] + ko * o.v[i];
}

// Round 2 in thread l from its round-1 product p and those of threads l ^ 1,
// l ^ 2, l ^ 3 (v1, v2, v3): with e = b - a, f = d - c, g = d + c, h = b + a,
// thread 0 forms X3 = e f, thread 1 Y3 = g h, thread 2 Z3 = f g, thread 3
// T3 = e h. Thread 0 holds a (v1 = b, v2 = d, v3 = c), 1 b (a, c, d), 2 d
// (c, a, b), 3 c (d, b, a), so the factors are
//   0: (v1 - p) (v2 - v3)   1: (p + v1) (v2 + v3)
//   2: (p - v1) (p + v1)    3: (v2 - v3) (v2 + v3).
HD void quad_round2(fe& m1, fe& m2, const fe& p, const fe& v1, const fe& v2, const fe& v3,
                    int l) {
  const i32 s1x = l == 0 ? -1 : 1;
  const i32 s1y = l >= 2 ? -1 : 1;
  const i32 s2y = l == 0 ? -1 : 1;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const i32 x1 = l == 3 ? v2.v[i] : p.v[i];
    const i32 y1 = l == 3 ? v3.v[i] : v1.v[i];
    const i32 x2 = l == 2 ? p.v[i] : v2.v[i];
    const i32 y2 = l == 2 ? v1.v[i] : v3.v[i];
    m1.v[i] = s1x * x1 + s1y * y1;
    m2.v[i] = x2 + s2y * y2;
  }
}

// Round 2 of a doubling in thread l from its square p and those of threads
// l ^ 1, l ^ 2, l ^ 3 (v1, v2, v3). The squares are a = X^2 (thread 0), b =
// Y^2 (1), c = 2Z^2 (2), t = (X + Y)^2 (3); E = a + b - t, F = c + a - b, G
// = a - b, H = a + b, and thread 0 forms X3 = E F, 1 Y3 = G H, 2 Z3 = F G,
// 3 T3 = E H. Thread 0 holds a (v1 = b, v2 = c, v3 = t), 1 b (a, t, c), 2
// c (t, a, b), 3 t (c, b, a), so the factors are
//   0: (p + v1 - v3) (p - v1 + v2)   1: (v1 - p) (v1 + p)
//   2: (p + v2 - v3) (v2 - v3)       3: (v2 + v3 - p) (v2 + v3).
HD void quad_double_round2(fe& m1, fe& m2, const fe& p, const fe& v1, const fe& v2,
                           const fe& v3, int l) {
  const i32 p1 = (l & 1) ? -1 : 1, a1 = l < 2 ? 1 : 0, b1 = l < 2 ? 0 : 1;
  const i32 c1 = l == 1 ? 0 : l == 3 ? 1 : -1;
  const i32 p2 = l < 2 ? 1 : 0, a2 = l == 0 ? -1 : l == 1 ? 1 : 0, b2 = l == 1 ? 0 : 1;
  const i32 c2 = l < 2 ? 0 : l == 2 ? -1 : 1;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    m1.v[i] = p1 * p.v[i] + a1 * v1.v[i] + b1 * v2.v[i] + c1 * v3.v[i];
    m2.v[i] = p2 * p.v[i] + a2 * v1.v[i] + b2 * v2.v[i] + c2 * v3.v[i];
  }
}

// Field l of the cached form (Y - X, Y + X, Z, 2dT) of a point whose
// coordinate l is m (o: the xor-1 partner's): the left factor; the right one
// is 2d in thread 3 and one elsewhere, so every thread multiplies (a warp
// pays for thread 3's product anyway) and every cached field is tight.
HD void quad_cache_factor(fe& s, const fe& m, const fe& o, int l) {
  const i32 km = l == 0 ? -1 : 1;
  const i32 ko = l < 2 ? 1 : 0;
#pragma unroll
  for (int i = 0; i < 10; i++) s.v[i] = km * m.v[i] + ko * o.v[i];
}

// Coordinate l of the identity (0, 1, 1, 0) and field l of the cached
// identity (1, 1, 1, 0).
HD void quad_identity(fe& r, int l) {
  fe_zero(r);
  r.v[0] = (l == 1 || l == 2) ? 1 : 0;
}

HD void quad_cached_identity(fe& r, int l) {
  fe_zero(r);
  r.v[0] = l < 3 ? 1 : 0;
}

// Coordinate l of -P from coordinate l of P: X and T change sign.
HD void quad_neg(fe& r, const fe& m, int l) {
  if (l == 0 || l == 3) fe_neg(r, m);
  else r = m;
}

// Field l of a cached affine entry (Y - X, Y + X, -, 2dT): thread 2 has no
// field (Z == 1).
HD const fe& quad_affine_field(const ga& q, int l) {
  return l == 0 ? q.YmX : l == 1 ? q.YpX : q.T2d;
}

template <class X>
HD void fe_shfl_xor(fe& r, const fe& a, int m, const X& x) {
  r = x.shfl_xor(a, m);
}

// Round 2 of an addition in a quad, from this thread's round-1 product p:
// m <- its coordinate of the sum.
template <class X>
HD void quad_finish(fe& m, const fe& p, int l, const X& x) {
  fe v1, v2, v3, m1, m2;
  fe_shfl_xor(v1, p, 1, x);
  fe_shfl_xor(v2, p, 2, x);
  fe_shfl_xor(v3, p, 3, x);
  quad_round2(m1, m2, p, v1, v2, v3, l);
  fe_mul(m, m1, m2);
}

// m <- m + q in a quad: m is this thread's coordinate of the sum, q its field
// of the cached addend. Every thread of the warp must call it.
template <class X>
HD void quad_add_cached(fe& m, const fe& q, int l, const X& x) {
  fe o, s, p;
  fe_shfl_xor(o, m, 1, x);
  quad_round1(s, m, o, l);
  fe_mul(p, s, q);
  quad_finish(m, p, l, x);
}

// m <- m + q, q cached affine (Z == 1; q is field l of it, unread on thread
// 2): thread 2's round-1 value d = 2Z is an addition, as in
// pt_add_cached_z1.
template <class X>
HD void quad_add_cached_z1(fe& m, const fe& q, int l, const X& x) {
  fe o, s, p;
  fe_shfl_xor(o, m, 1, x);
  quad_round1(s, m, o, l);
  if (l != 2) fe_mul(p, s, q);
  else p = s;
  quad_finish(m, p, l, x);
}

// c <- field l of the cached form of the point whose coordinate l is m (o:
// the xor-1 partner's coordinate).
HD void quad_cache(fe& c, const fe& m, const fe& o, int l, const Consts& k) {
  fe s, one;
  quad_cache_factor(s, m, o, l);
  fe_one(one);
  fe_mul(c, s, l == 3 ? k.d2 : one);
}

// m <- m + q, the complete addition (pt_add) in a quad, q given by this
// thread's coordinate qm of it and its xor-1 partner's qo. The addend's
// factors Y2 - X2, Y2 + X2, Z2, T2 need no product; the sum's Y1 - X1,
// Y1 + X1, 2 Z1, 2d T1 take one, which runs while q's loads are in flight.
template <class X>
HD void quad_add(fe& m, const fe& qm, const fe& qo, int l, const Consts& k, const X& x) {
  fe o, s, one, q, p;
  fe_shfl_xor(o, m, 1, x);
  quad_round1(s, m, o, l);
  fe_one(one);
  fe_mul(s, s, l == 3 ? k.d2 : one);
  quad_cache_factor(q, qm, qo, l);
  fe_mul(p, s, q);  // a, b, d = 2 Z1 Z2, c = 2d T1 T2: pt_add's products
  quad_finish(m, p, l, x);
}

// m <- 2m (pt_double) in a quad. Round 1: threads 0, 1, 2 square their
// coordinate (thread 2 doubles Z^2 in the carry chain), thread 3 squares
// X + Y from threads 0 and 1; pt_double reads no T. Round 2 as
// quad_double_round2. With kT false thread 3 forms no T3 and keeps a stale
// value: only for a doubling whose T nothing reads (the next operation a
// doubling, or the end).
template <bool kT, class X>
HD void quad_double(fe& m, int l, const X& x) {
  fe ox, oy, s, p, v1, v2, v3, m1, m2;
  fe_shfl_xor(ox, m, 3, x);  // thread 3: X
  fe_shfl_xor(oy, m, 2, x);  // thread 3: Y
#pragma unroll
  for (int i = 0; i < 10; i++) s.v[i] = l == 3 ? ox.v[i] + oy.v[i] : m.v[i];
  fe_sq_shl(p, s, l == 2 ? 1 : 0);
  fe_shfl_xor(v1, p, 1, x);
  fe_shfl_xor(v2, p, 2, x);
  fe_shfl_xor(v3, p, 3, x);
  quad_double_round2(m1, m2, p, v1, v2, v3, l);
  if (kT || l != 3) fe_mul(m, m1, m2);
}

// Coordinate l of the point P held whole by quad thread src (four
// broadcasts, each from thread src: xor mask l ^ src).
template <class X>
HD void quad_take(fe& r, const ge& P, int src, int l, const X& x) {
#pragma unroll
  for (int j = 0; j < 4; j++) {
    fe v;
    fe_shfl_xor(v, j == 0 ? P.X : j == 1 ? P.Y : j == 2 ? P.Z : P.T, l ^ src, x);
    if (j == l) r = v;
  }
}

#ifdef __CUDACC__
// The card's exchange: the quad's four threads are lanes 4q .. 4q + 3 of a
// warp, and every lane of the warp shuffles (a constant full mask).
struct QuadShfl {
  __device__ __forceinline__ fe shfl_xor(const fe& v, int m) const {
    fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = __shfl_xor_sync(0xffffffffu, v.v[i], m);
    return r;
  }
  __device__ __forceinline__ i32 shfl_xor(i32 v, int m) const {
    return __shfl_xor_sync(0xffffffffu, v, m);
  }
};
#endif

}  // namespace ed25519_quad
