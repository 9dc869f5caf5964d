// Batched host-side ed25519 scalar pipeline for the card's verifier.
//
// Port copy of the JAX package's `native/scalar_ops.cpp`, built by
// narwhal_tpu_torch/native.py into native_src/_build/.
//
// The pipelined verify path (narwhal_tpu_torch/gpu/verifier.py) is bounded by
// per-item Python work: the SHA-512 challenge k = H(R || A || M) mod L, the
// canonicality prechecks, and — in msm mode — the random-linear-combination
// scalars z*k mod L and sum(z*s) mod L on Python bigints (~250 ms per 32k
// batch on the JAX package's host). This
// file does the same work in C at ~1 us/item with the GIL released (ctypes
// calls drop it), so host packing of batch N+1 genuinely overlaps the device
// compute of batch N.
//
// Parity targets (behavior, not code): the precheck + challenge rules of
// narwhal/types/src/primary.rs:487-537's certificate verification
// via ed25519-dalek (canonical s < L, canonical field encodings y < p), and
// the batch-verification scalar math of RFC 8032 / dalek's batch_verify.
// Arithmetic is original: 64-bit-limb schoolbook multiplies with unsigned
// __int128 carries, and a fold-based reduction mod L using
// 2^252 === -DELTA (mod L) with explicit sign tracking.
//
// Assumes little-endian host (x86/arm64): 32-byte scalars are memcpy'd
// straight into 4x64-bit limb vectors.

#include <cstdint>
#include <cstdlib>
#include <cstring>

typedef uint64_t u64;
typedef unsigned __int128 u128;

// ---- SHA-512 (FIPS 180-4), self-contained ---------------------------------
// No OpenSSL dev headers ship in this environment, so the digest is
// implemented here. The round/initial constants are the standard published
// tables (fractional parts of cube/square roots of the first primes),
// generated programmatically; the whole function is fuzz-checked against
// hashlib.sha512 in tests/test_tpu_ed25519.py, and this copy is held bit for
// bit to the JAX package's by tests/test_torch_native.py.

static const u64 SHA512_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};
static const u64 SHA512_H0[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, 0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static inline u64 rotr64(u64 x, int n) { return (x >> n) | (x << (64 - n)); }
static inline u64 load_be64(const uint8_t *p) {
  u64 v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
  return v;
}
static inline void store_be64(uint8_t *p, u64 v) {
  for (int i = 7; i >= 0; --i) { p[i] = (uint8_t)v; v >>= 8; }
}

static void sha512_block(u64 h[8], const uint8_t *blk) {
  u64 w[80];
  for (int t = 0; t < 16; ++t) w[t] = load_be64(blk + 8 * t);
  for (int t = 16; t < 80; ++t) {
    u64 s0 = rotr64(w[t - 15], 1) ^ rotr64(w[t - 15], 8) ^ (w[t - 15] >> 7);
    u64 s1 = rotr64(w[t - 2], 19) ^ rotr64(w[t - 2], 61) ^ (w[t - 2] >> 6);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  u64 a = h[0], b = h[1], c = h[2], d = h[3];
  u64 e = h[4], f = h[5], g = h[6], hh = h[7];
  for (int t = 0; t < 80; ++t) {
    u64 S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    u64 ch = (e & f) ^ (~e & g);
    u64 t1 = hh + S1 + ch + SHA512_K[t] + w[t];
    u64 S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    u64 maj = (a & b) ^ (a & c) ^ (b & c);
    u64 t2 = S0 + maj;
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// digest = SHA512(seg1 || seg2 || seg3); the three-segment shape matches the
// challenge input R || A || M without concatenating on the Python side.
static void sha512_3seg(const uint8_t *s1, size_t n1, const uint8_t *s2,
                        size_t n2, const uint8_t *s3, size_t n3,
                        uint8_t out[64]) {
  u64 h[8];
  memcpy(h, SHA512_H0, sizeof(h));
  uint8_t buf[128];
  size_t fill = 0, total = n1 + n2 + n3;
  const uint8_t *segs[3] = {s1, s2, s3};
  size_t lens[3] = {n1, n2, n3};
  for (int s = 0; s < 3; ++s) {
    const uint8_t *p = segs[s];
    size_t rem = lens[s];
    while (rem) {
      size_t take = 128 - fill < rem ? 128 - fill : rem;
      memcpy(buf + fill, p, take);
      fill += take; p += take; rem -= take;
      if (fill == 128) { sha512_block(h, buf); fill = 0; }
    }
  }
  buf[fill++] = 0x80;
  if (fill > 112) {
    memset(buf + fill, 0, 128 - fill);
    sha512_block(h, buf);
    fill = 0;
  }
  memset(buf + fill, 0, 128 - fill);
  // 128-bit big-endian bit length; message sizes here fit 64 bits.
  store_be64(buf + 120, (u64)total << 3);
  store_be64(buf + 112, (u64)total >> 61);
  sha512_block(h, buf);
  for (int i = 0; i < 8; ++i) store_be64(out + 8 * i, h[i]);
}

// L = 2^252 + DELTA (the ed25519 group order)
static const u64 L_LIMBS[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                               0ULL, 0x1000000000000000ULL};
// DELTA = L - 2^252 (125 bits)
static const u64 DELTA_LIMBS[2] = {0x5812631a5cf5d3edULL,
                                   0x14def9dea2f79cd6ULL};
// P = 2^255 - 19 (field prime), for the y < p canonical-encoding check
static const u64 P_LIMBS[4] = {0xffffffffffffffedULL, 0xffffffffffffffffULL,
                               0xffffffffffffffffULL, 0x7fffffffffffffffULL};

// ---- n-limb helpers (little-endian limb order) ----------------------------

static inline int limbs_cmp(const u64 *a, const u64 *b, int n) {
  for (int i = n - 1; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  }
  return 0;
}

static inline bool limbs_is_zero(const u64 *a, int n) {
  for (int i = 0; i < n; ++i)
    if (a[i]) return false;
  return true;
}

// out[na+nb] = a[na] * b[nb] (schoolbook; out must not alias inputs)
static void limbs_mul(const u64 *a, int na, const u64 *b, int nb, u64 *out) {
  memset(out, 0, sizeof(u64) * (na + nb));
  for (int i = 0; i < na; ++i) {
    u128 carry = 0;
    for (int j = 0; j < nb; ++j) {
      u128 cur = (u128)a[i] * b[j] + out[i + j] + carry;
      out[i + j] = (u64)cur;
      carry = cur >> 64;
    }
    out[i + nb] = (u64)carry;
  }
}

// a[n] -= b[n]; requires a >= b
static void limbs_sub(u64 *a, const u64 *b, int n) {
  u64 borrow = 0;
  for (int i = 0; i < n; ++i) {
    u64 bi = b[i] + borrow;
    borrow = (b[i] + borrow < b[i]) || (a[i] < bi);
    a[i] -= bi;
  }
}

// Reduce x[nx] (nx <= 9) mod L into out[4]. Fold rule: for v = r + q*2^252,
// v === r - q*DELTA (mod L); track the sign of the running magnitude
// explicitly and fix it up at the end. Each fold shrinks the magnitude by
// ~127 bits, so at most 4 folds for 576-bit inputs.
static void reduce_mod_l(const u64 *x, int nx, u64 out[4]) {
  u64 v[10];
  memset(v, 0, sizeof(v));
  memcpy(v, x, sizeof(u64) * nx);
  int neg = 0;
  for (;;) {
    // done when v < 2^252 (limbs 4.. zero and limb3 < 2^60)
    bool high = v[3] >> 60;
    for (int i = 4; i < 10 && !high; ++i) high = v[i] != 0;
    if (!high) break;
    // q = v >> 252 (up to 6 limbs), r = v mod 2^252
    u64 q[7];
    for (int i = 0; i < 6; ++i) q[i] = (v[i + 3] >> 60) | (v[i + 4] << 4);
    q[6] = v[9] >> 60;
    u64 r[4] = {v[0], v[1], v[2], v[3] & 0x0fffffffffffffffULL};
    // y = q * DELTA (<= 9 limbs)
    u64 y[9];
    limbs_mul(q, 7, DELTA_LIMBS, 2, y);
    // v = |r - y|, flipping the sign when y > r
    u64 rwide[9];
    memset(rwide, 0, sizeof(rwide));
    memcpy(rwide, r, sizeof(r));
    memset(v, 0, sizeof(v));
    if (limbs_cmp(rwide, y, 9) >= 0) {
      memcpy(v, rwide, sizeof(rwide));
      limbs_sub(v, y, 9);
    } else {
      memcpy(v, y, sizeof(y));
      limbs_sub(v, rwide, 9);
      neg ^= 1;
    }
  }
  // v < 2^252 < L
  if (neg && !limbs_is_zero(v, 4)) {
    u64 l[4];
    memcpy(l, L_LIMBS, sizeof(l));
    limbs_sub(l, v, 4);
    memcpy(out, l, sizeof(l));
  } else {
    memcpy(out, v, sizeof(u64) * 4);
  }
}

// out[4] = a[na] * b[nb] mod L (na+nb <= 9)
static void mulmod_l(const u64 *a, int na, const u64 *b, int nb, u64 out[4]) {
  u64 prod[9];
  memset(prod, 0, sizeof(prod));
  limbs_mul(a, na, b, nb, prod);
  reduce_mod_l(prod, na + nb, out);
}

// acc[4] = (acc + t) mod L; both < L
static void addmod_l(u64 acc[4], const u64 t[4]) {
  u64 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u64 s = acc[i] + t[i];
    u64 c1 = s < acc[i];
    acc[i] = s + carry;
    carry = c1 | (acc[i] < s);
  }
  if (carry || limbs_cmp(acc, L_LIMBS, 4) >= 0) limbs_sub(acc, L_LIMBS, 4);
}

// ---- exported batch entry points ------------------------------------------

extern "C" {

// Precheck + challenge scalars for n signatures.
//   pk:      n x 32 bytes      sig: n x 64 bytes (R || S)
//   msg:     concatenated messages, item i = msg[msg_off[i] : msg_off[i+1]]
//   out_k:   n x 32 bytes, k_i = SHA512(R_i || A_i || M_i) mod L (LE)
//   out_ok:  n bytes, 1 iff the item passes the canonicality prechecks
//            (s < L, masked y_A < p, masked y_R < p)
// Returns 0 on success, nonzero on internal failure (EVP init).
int ed25519_precheck_k(int64_t n, const uint8_t *pk, const uint8_t *sig,
                       const uint8_t *msg, const int64_t *msg_off,
                       uint8_t *out_k, uint8_t *out_ok) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t *a = pk + 32 * i;
    const uint8_t *r = sig + 64 * i;
    const uint8_t *s = sig + 64 * i + 32;
    out_ok[i] = 0;
    memset(out_k + 32 * i, 0, 32);

    u64 sl[4], yl[4];
    memcpy(sl, s, 32);
    if (limbs_cmp(sl, L_LIMBS, 4) >= 0) continue;  // non-canonical s
    memcpy(yl, a, 32);
    yl[3] &= 0x7fffffffffffffffULL;  // drop the x-sign bit
    if (limbs_cmp(yl, P_LIMBS, 4) >= 0) continue;  // non-canonical A
    memcpy(yl, r, 32);
    yl[3] &= 0x7fffffffffffffffULL;
    if (limbs_cmp(yl, P_LIMBS, 4) >= 0) continue;  // non-canonical R

    uint8_t digest[64];
    sha512_3seg(r, 32, a, 32, msg + msg_off[i],
                (size_t)(msg_off[i + 1] - msg_off[i]), digest);
    u64 h[8], k[4];
    memcpy(h, digest, 64);
    reduce_mod_l(h, 8, k);
    memcpy(out_k + 32 * i, k, 32);
    out_ok[i] = 1;
  }
  return 0;
}

// Self-test hook: SHA512 over one contiguous buffer.
void sha512_test(const uint8_t *data, int64_t n, uint8_t *out) {
  sha512_3seg(data, (size_t)n, nullptr, 0, nullptr, 0, out);
}

// Random-linear-combination scalars for one msm bucket of m items.
//   k_rows: m x 32 (challenge scalars < L)   s_rows: m x 32 (sig S < L)
//   z_rows: m x 16 (fresh 128-bit coefficients)
//   out_ak: m x 32, ak_i = z_i * k_i mod L
//   out_sum: 32 bytes, sum(z_i * s_i) mod L
void scalar_fold(int64_t m, const uint8_t *k_rows, const uint8_t *s_rows,
                 const uint8_t *z_rows, uint8_t *out_ak, uint8_t *out_sum) {
  u64 acc[4] = {0, 0, 0, 0};
  for (int64_t i = 0; i < m; ++i) {
    u64 z[2], k[4], s[4], ak[4], zs[4];
    memcpy(z, z_rows + 16 * i, 16);
    memcpy(k, k_rows + 32 * i, 32);
    memcpy(s, s_rows + 32 * i, 32);
    mulmod_l(z, 2, k, 4, ak);
    memcpy(out_ak + 32 * i, ak, 32);
    mulmod_l(z, 2, s, 4, zs);
    addmod_l(acc, zs);
  }
  memcpy(out_sum, acc, 32);
}

// Pairwise 256-bit modular multiply: out_i = a_i * b_i mod L. Used by the
// aggregate-certificate lane (y_i = w_g * z_i, then y_i * k_i) where the
// scalars exceed the 128-bit z lane scalar_fold handles.
void scalar_mulmod(int64_t m, const uint8_t *a_rows, const uint8_t *b_rows,
                   uint8_t *out_rows) {
  for (int64_t i = 0; i < m; ++i) {
    u64 a[4], b[4], o[4];
    memcpy(a, a_rows + 32 * i, 32);
    memcpy(b, b_rows + 32 * i, 32);
    mulmod_l(a, 4, b, 4, o);
    memcpy(out_rows + 32 * i, o, 32);
  }
}

// Self-test hook: reduce one nx-limb value mod L (nx <= 9).
void reduce_mod_l_test(const uint8_t *x, int64_t nx, uint8_t *out) {
  u64 xl[9], o[4];
  memset(xl, 0, sizeof(xl));
  memcpy(xl, x, (size_t)nx * 8);
  reduce_mod_l(xl, (int)nx, o);
  memcpy(out, o, 32);
}

}  // extern "C"
