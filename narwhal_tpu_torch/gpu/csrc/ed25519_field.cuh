#pragma once

// The radix-2^25.5 field and extended-Edwards point layer of the port's
// ed25519 kernels, shared by ed25519_verify.cu (A1, per-signature verify),
// ed25519_staged.cu (A3-A5, the staged verify stages) and ed25519_msm.cu
// (A2 and A6, window-lane accumulates).
//
// Field elements mod p = 2^255 - 19 are ref10's layout: 10 signed int32 limbs
// alternating 26 and 25 bits (limb i at bit ceil(25.5 i)); one product is 100
// native 32x32->64 multiply-adds into int64 columns. Points use the JAX
// module's formulas (narwhal_tpu/tpu/ed25519.py): extended (X, Y, Z, T),
// cached (Y+X, Y-X, Z, 2d*T) and cached affine (Z == 1).
//
// Every function is HD: __host__ __device__ under nvcc, plain inline C++
// otherwise, so the layer also compiles with a host compiler and can be
// held against the plain PyTorch version without a card.
//
// Bound argument for the radix (all |.| per limb; "even"/"odd" = limb index):
//   T (tight):  |h_i| <= 1.1*2^25 (even), 1.1*2^24 (odd).  fe_mul, fe_sq,
//               fe_carry and fe_from13 outputs are tight (ref10's carry chain:
//               after it every limb is within half its radix plus the small
//               wrap-around carries, well inside 1.01*2^25 / 1.01*2^24).
//   fe_mul inputs: |f_i|, |g_i| <= 1.65*2^26 (even), 1.65*2^25 (odd).  Then
//               19*g_j <= 31.35*2^26 < 2^31 and 2*f_i (odd i) <= 1.65*2^26 fit
//               int32; one product <= 1.65*2^26 * 31.35*2^26 < 2^57.7, a
//               column of 10 products < 2^61.1 < 2^63: no int64 overflow.
//   Rule kept by every caller below: an operand of fe_mul / fe_sq is a signed
//               sum of at most 3 tight values (3 * 1.1*2^25 = 1.65*2^26).
//               fe_add / fe_sub / fe_neg do not carry; the one place that
//               would sum 4 tight values (2*Z^2 + (X^2 - Y^2) in the
//               doubling) carries 2*Z^2 first.  Table entries (Y+X, Y-X: 2
//               tight) and the accumulator (mul outputs: tight) satisfy it.
//   fe_canonical carries first, then runs ref10's fe_tobytes reduction, whose
//               precondition is a tight input; its output limbs are the
//               canonical value in [0, p), so equality and parity are exact.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace ed25519_field {

typedef int32_t i32;
typedef int64_t i64;

struct fe { i32 v[10]; };
struct ge { fe X, Y, Z, T; };          // extended: x = X/Z, y = Y/Z, T = XY/Z
struct gc { fe YpX, YmX, Z, T2d; };    // cached: (Y+X, Y-X, Z, 2d*T)
struct ga { fe YpX, YmX, T2d; };       // cached affine (Z == 1)

struct Consts { fe d, d2, sqrtm1; };

// ref10's rounding carry chain over 64-bit columns; output is tight.
HD void fe_reduce64(i64 h[10], fe& r) {
  i64 c;
  c = (h[0] + ((i64)1 << 25)) >> 26; h[1] += c; h[0] -= c * ((i64)1 << 26);
  c = (h[4] + ((i64)1 << 25)) >> 26; h[5] += c; h[4] -= c * ((i64)1 << 26);
  c = (h[1] + ((i64)1 << 24)) >> 25; h[2] += c; h[1] -= c * ((i64)1 << 25);
  c = (h[5] + ((i64)1 << 24)) >> 25; h[6] += c; h[5] -= c * ((i64)1 << 25);
  c = (h[2] + ((i64)1 << 25)) >> 26; h[3] += c; h[2] -= c * ((i64)1 << 26);
  c = (h[6] + ((i64)1 << 25)) >> 26; h[7] += c; h[6] -= c * ((i64)1 << 26);
  c = (h[3] + ((i64)1 << 24)) >> 25; h[4] += c; h[3] -= c * ((i64)1 << 25);
  c = (h[7] + ((i64)1 << 24)) >> 25; h[8] += c; h[7] -= c * ((i64)1 << 25);
  c = (h[4] + ((i64)1 << 25)) >> 26; h[5] += c; h[4] -= c * ((i64)1 << 26);
  c = (h[8] + ((i64)1 << 25)) >> 26; h[9] += c; h[8] -= c * ((i64)1 << 26);
  c = (h[9] + ((i64)1 << 24)) >> 25; h[0] += c * 19; h[9] -= c * ((i64)1 << 25);
  c = (h[0] + ((i64)1 << 25)) >> 26; h[1] += c; h[0] -= c * ((i64)1 << 26);
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (i32)h[i];
}

HD void fe_carry(fe& r, const fe& a) {
  i64 h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = a.v[i];
  fe_reduce64(h, r);
}

HD void fe_zero(fe& r) {
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = 0;
}

HD void fe_one(fe& r) {
  fe_zero(r);
  r.v[0] = 1;
}

HD void fe_add(fe& r, const fe& a, const fe& b) {
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = a.v[i] + b.v[i];
}

HD void fe_sub(fe& r, const fe& a, const fe& b) {
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = a.v[i] - b.v[i];
}

HD void fe_neg(fe& r, const fe& a) {
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = -a.v[i];
}

// h = f * g: limb i of f times limb j of g lands in column i+j, doubled when
// both are odd (ceil(25.5 i) + ceil(25.5 j) = ceil(25.5 (i+j)) + 1) and times
// 19 when i+j >= 10 (2^255 = 19 mod p).  r may alias f or g: every read
// happens before the carry chain writes r.
HD void fe_mul(fe& r, const fe& f, const fe& g) {
  i32 g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    g19[i] = 19 * g.v[i];
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  }
  i64 h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const i32 fi = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      if (i + j < 10) h[i + j] += (i64)fi * (i64)g.v[j];
      else h[i + j - 10] += (i64)fi * (i64)g19[j];
    }
  }
  fe_reduce64(h, r);
}

HD void fe_sq(fe& r, const fe& f) { fe_mul(r, f, f); }

// Canonical limbs of a (value in [0, p), limb i in [0, 2^26) or [0, 2^25)).
HD void fe_canonical(fe& r, const fe& a) {
  fe t;
  fe_carry(t, a);
  i32* h = t.v;
  i32 q = (19 * h[9] + ((i32)1 << 24)) >> 25;
  q = (h[0] + q) >> 26;
  q = (h[1] + q) >> 25;
  q = (h[2] + q) >> 26;
  q = (h[3] + q) >> 25;
  q = (h[4] + q) >> 26;
  q = (h[5] + q) >> 25;
  q = (h[6] + q) >> 26;
  q = (h[7] + q) >> 25;
  q = (h[8] + q) >> 26;
  q = (h[9] + q) >> 25;
  h[0] += 19 * q;
  i32 c;
  c = h[0] >> 26; h[1] += c; h[0] -= c * (1 << 26);
  c = h[1] >> 25; h[2] += c; h[1] -= c * (1 << 25);
  c = h[2] >> 26; h[3] += c; h[2] -= c * (1 << 26);
  c = h[3] >> 25; h[4] += c; h[3] -= c * (1 << 25);
  c = h[4] >> 26; h[5] += c; h[4] -= c * (1 << 26);
  c = h[5] >> 25; h[6] += c; h[5] -= c * (1 << 25);
  c = h[6] >> 26; h[7] += c; h[6] -= c * (1 << 26);
  c = h[7] >> 25; h[8] += c; h[7] -= c * (1 << 25);
  c = h[8] >> 26; h[9] += c; h[8] -= c * (1 << 26);
  c = h[9] >> 25; h[9] -= c * (1 << 25);
  r = t;
}

HD bool fe_eq(const fe& a, const fe& b) {
  fe ca, cb;
  fe_canonical(ca, a);
  fe_canonical(cb, b);
  bool eq = true;
#pragma unroll
  for (int i = 0; i < 10; i++) eq = eq && (ca.v[i] == cb.v[i]);
  return eq;
}

HD bool fe_is_zero_canonical(const fe& c) {
  bool z = true;
#pragma unroll
  for (int i = 0; i < 10; i++) z = z && (c.v[i] == 0);
  return z;
}

// Radix-2^13 limbs (the JAX host layout, 20 limbs, each taken mod 2^13) ->
// tight radix-2^25.5 limbs of the same value mod p.
template <typename T>
HD void fe_from13(fe& r, const T* l) {
  uint32_t w[9];
#pragma unroll
  for (int i = 0; i < 9; i++) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 20; i++) {
    const uint32_t val = (uint32_t)((int32_t)l[i]) & 0x1FFFu;
    const int bit = 13 * i, word = bit >> 5, sh = bit & 31;
    w[word] |= val << sh;
    if (sh + 13 > 32) w[word + 1] |= val >> (32 - sh);
  }
  // bits 255..259 fold back as 19 * top (2^255 = 19 mod p)
  const uint32_t top = (w[7] >> 31) | ((w[8] & 0xFu) << 1);
  w[7] &= 0x7FFFFFFFu;
  w[8] = 0;
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
  i64 h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int width = (i & 1) ? 25 : 26;
    const int word = off[i] >> 5, sh = off[i] & 31;
    const uint64_t x = (uint64_t)w[word] | ((uint64_t)w[word + 1] << 32);
    h[i] = (i64)((x >> sh) & ((1ull << width) - 1));
  }
  h[0] += 19 * (i64)top;
  fe_reduce64(h, r);
}

// Radix-2^13 limbs of any size (the plain versions' loose limbs, at most
// 9500, or canonical ones) at l[i * stride] -> tight limbs of the same value
// mod p. A sequential carry first brings every limb under 2^13 (arithmetic
// shifts, so a negative limb is carried too); what leaves limb 19 sits at
// bit 260, and 2^260 = 608 mod p.
HD void fe_from13_loose(fe& r, const i32* l, int stride) {
  i32 c[20];
  i32 carry = 0;
#pragma unroll
  for (int i = 0; i < 20; i++) {
    const i32 v = l[(size_t)i * stride] + carry;
    c[i] = v & 0x1FFF;
    carry = v >> 13;
  }
  fe_from13(r, c);
  r.v[0] += 608 * carry;
  fe_carry(r, r);
}

// Canonical value of a, as the JAX layout's 20 radix-2^13 limbs at
// out[i * stride].
HD void fe_to13(const fe& a, i32* out, int stride) {
  fe c;
  fe_canonical(c, a);
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
  uint32_t w[9];
#pragma unroll
  for (int i = 0; i < 9; i++) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const uint64_t x = (uint64_t)(uint32_t)c.v[i] << (off[i] & 31);
    w[off[i] >> 5] |= (uint32_t)x;
    w[(off[i] >> 5) + 1] |= (uint32_t)(x >> 32);
  }
#pragma unroll
  for (int i = 0; i < 20; i++) {
    const int bit = 13 * i, word = bit >> 5, sh = bit & 31;
    uint32_t val = w[word] >> sh;
    if (sh + 13 > 32) val |= w[word + 1] << (32 - sh);
    out[(size_t)i * stride] = (i32)(val & 0x1FFFu);
  }
}

HD void fe_sq_times(fe& r, const fe& a, int n) {
  r = a;
  for (int i = 0; i < n; i++) fe_sq(r, r);
}

// Shared exponentiation ladder: t1 = z^(2^250-1), z11 = z^11.
HD void fe_ladder(fe& t1, fe& z11, const fe& z) {
  fe t0, t2, t3;
  fe_sq(t0, z);
  fe_sq(t1, t0);
  fe_sq(t1, t1);
  fe_mul(t1, z, t1);      // z^9
  fe_mul(t0, t0, t1);     // z^11
  fe_sq(t2, t0);
  fe_mul(t1, t1, t2);     // z^31
  z11 = t0;
  fe_sq_times(t2, t1, 5);
  fe_mul(t1, t2, t1);     // 2^10-1
  fe_sq_times(t2, t1, 10);
  fe_mul(t2, t2, t1);     // 2^20-1
  fe_sq_times(t3, t2, 20);
  fe_mul(t2, t3, t2);     // 2^40-1
  fe_sq_times(t2, t2, 10);
  fe_mul(t1, t2, t1);     // 2^50-1
  fe_sq_times(t2, t1, 50);
  fe_mul(t2, t2, t1);     // 2^100-1
  fe_sq_times(t3, t2, 100);
  fe_mul(t2, t3, t2);     // 2^200-1
  fe_sq_times(t2, t2, 50);
  fe_mul(t1, t2, t1);     // 2^250-1
}

HD void fe_invert(fe& r, const fe& z) {
  fe t1, z11;
  fe_ladder(t1, z11, z);
  fe_sq_times(t1, t1, 5);
  fe_mul(r, t1, z11);     // z^(p-2)
}

HD void fe_pow22523(fe& r, const fe& z) {
  fe t1, z11;
  fe_ladder(t1, z11, z);
  fe_sq(t1, t1);
  fe_sq(t1, t1);
  fe_mul(r, t1, z);       // z^(2^252-3)
}

// ---------------------------------------------------------------------------
// Points (the JAX module's formulas; operands kept within the bound rule).
// ---------------------------------------------------------------------------

HD void pt_identity(ge& p) {
  fe_zero(p.X);
  fe_one(p.Y);
  fe_one(p.Z);
  fe_zero(p.T);
}

HD void pt_neg(ge& r, const ge& p) {
  fe_neg(r.X, p.X);
  r.Y = p.Y;
  r.Z = p.Z;
  fe_neg(r.T, p.T);
}

HD void pt_double(ge& r, const ge& p) {
  fe a, b, c, h, e, g, f, t;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(c, p.Z);
  fe_add(c, c, c);
  fe_carry(c, c);          // 2 Z^2, tight
  fe_add(h, a, b);         // 2 tight
  fe_add(t, p.X, p.Y);
  fe_sq(t, t);
  fe_sub(e, h, t);         // 3 tight
  fe_sub(g, a, b);         // 2 tight
  fe_add(f, c, g);         // 3 tight
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// Complete addition (9 multiplications), used once in the epilogue.
HD void pt_add(ge& r, const ge& p, const ge& q, const Consts& k) {
  fe a, b, c, d, e, f, g, h, t0, t1;
  fe_sub(t0, p.Y, p.X);
  fe_sub(t1, q.Y, q.X);
  fe_mul(a, t0, t1);
  fe_add(t0, p.Y, p.X);
  fe_add(t1, q.Y, q.X);
  fe_mul(b, t0, t1);
  fe_mul(c, p.T, k.d2);
  fe_mul(c, c, q.T);
  fe_add(t0, p.Z, p.Z);
  fe_mul(d, t0, q.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

HD void pt_cache(gc& r, const ge& p, const Consts& k) {
  fe_add(r.YpX, p.Y, p.X);
  fe_sub(r.YmX, p.Y, p.X);
  r.Z = p.Z;
  fe_mul(r.T2d, p.T, k.d2);
}

// p + q, q cached: 8 multiplications.
HD void pt_add_cached(ge& r, const ge& p, const gc& q) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, q.YmX);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, q.YpX);
  fe_mul(c, p.T, q.T2d);
  fe_add(t, p.Z, p.Z);
  fe_mul(d, t, q.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// p + q, q cached with Z == 1: 7 multiplications.
HD void pt_add_cached_z1(ge& r, const ge& p, const ga& q) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, q.YmX);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, q.YpX);
  fe_mul(c, p.T, q.T2d);
  fe_add(d, p.Z, p.Z);     // 2 tight
  fe_sub(e, b, a);
  fe_sub(f, d, c);         // 3 tight
  fe_add(g, d, c);         // 3 tight
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// Point p of a stage boundary: the JAX layout int32 [4, 20, n], coordinate
// c's limb i of point j at base[(c * 20 + i) * n + j]; a thread per point
// reads and writes with stride n, so a warp's accesses are coalesced.
HD void pt_load13(ge& p, const i32* base, int n, int j) {
  fe_from13_loose(p.X, base + (size_t)0 * 20 * n + j, n);
  fe_from13_loose(p.Y, base + (size_t)1 * 20 * n + j, n);
  fe_from13_loose(p.Z, base + (size_t)2 * 20 * n + j, n);
  fe_from13_loose(p.T, base + (size_t)3 * 20 * n + j, n);
}

// Canonical limbs of p into the same layout.
HD void pt_store13(const ge& p, i32* base, int n, int j) {
  fe_to13(p.X, base + (size_t)0 * 20 * n + j, n);
  fe_to13(p.Y, base + (size_t)1 * 20 * n + j, n);
  fe_to13(p.Z, base + (size_t)2 * 20 * n + j, n);
  fe_to13(p.T, base + (size_t)3 * 20 * n + j, n);
}

// The curve constants, radix-2^13 rows [d, 2d, sqrt(-1)] of 20 limbs; entry t
// of 3, so three threads of a block load them into shared memory together.
HD void load_consts(int t, const i32* consts13, Consts& k) {
  if (t == 0) fe_from13(k.d, consts13 + 0 * 20);
  if (t == 1) fe_from13(k.d2, consts13 + 1 * 20);
  if (t == 2) fe_from13(k.sqrtm1, consts13 + 2 * 20);
}

// x from y (tight) and the sign bit, as the JAX decompress: returns validity.
HD bool decompress(ge& p, const fe& y, i32 sign, const Consts& k) {
  fe y2, u, v, v3, v7, t, x, vx2, nu, xc;
  fe_sq(y2, y);
  u = y2;
  u.v[0] -= 1;             // y^2 - 1
  fe_mul(v, y2, k.d);
  v.v[0] += 1;             // d y^2 + 1
  fe_sq(v3, v);
  fe_mul(v3, v3, v);
  fe_sq(v7, v3);
  fe_mul(v7, v7, v);
  fe_mul(t, u, v7);
  fe_pow22523(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sq(vx2, x);
  fe_mul(vx2, vx2, v);
  const bool correct = fe_eq(vx2, u);
  fe_neg(nu, u);
  const bool flipped = fe_eq(vx2, nu);
  bool valid = correct || flipped;
  if (flipped) fe_mul(x, x, k.sqrtm1);
  fe_canonical(xc, x);
  const bool x_zero = fe_is_zero_canonical(xc);
  valid = valid && !(x_zero && sign == 1);
  if ((xc.v[0] & 1) != sign) fe_neg(x, x);
  p.X = x;
  p.Y = y;
  fe_one(p.Z);
  fe_mul(p.T, x, y);
  return valid;
}

}  // namespace ed25519_field
