#pragma once

// The commit mask of the consensus step (consensus_commit_kernel in
// dag_window.cu): the per-thread pieces of its CTAs.
//
// The flat [B, W, M] byte arrays (masks in, committed out; under 2^31
// bytes) are streamed by every thread of the launch in a grid-stride loop
// over 16-byte words, kBatch of a thread's words loaded at once (the first
// batch before the quorum is known): byte i belongs to walk i / (W * M),
// column i % M and round row (i / M) % W. A word inside one walk is masked
// whole by that walk's quorum test; a word across a walk boundary byte by
// byte. The bytes before masks' first 16-byte boundary and after its last
// go byte by byte, and so does everything when masks and committed differ
// in their alignment mod 16 (a view), or when the launch has a thread for
// every byte (the dry run's 64-byte blocks: a byte a thread is a short
// loop, a word's 16 table updates a long chain). A committed byte raises
// its column's best row in the CTA's table; the fold takes the launch's
// tables and `last`.
//
// The functions are CM_HD (host and device under nvcc, plain inline C++
// otherwise) and the CTA's barriers, its stake sum and its table updates
// are left to the caller (`mx(addr, w)` raises *addr to w), so a host
// compiler can run a launch as loops over its CTAs and threads, phase by
// phase, and hold it against the plain version.

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CM_HD __host__ __device__ __forceinline__
#else
#define CM_HD inline
#endif

namespace commit_mask {

// A CTA's threads, and the bytes a CTA streams before the launch takes
// another (up to kMaxCtas): 256 threads, a 16-byte word each, the fastest
// grid over the consensus step's launches on the H100 (PERF.md: 128 to
// 1024 threads, one to four words a thread, one CTA of 1024 threads).
constexpr int kThreads = 256;
constexpr int kMaxCtas = 8;  // the portable cluster size
constexpr int kCtaBytes = 16 * kThreads;
constexpr int kBatch = 4;    // words a thread loads before it uses them

// CTAs of a launch over n bytes: 1 to kMaxCtas.
CM_HD int ctas_for(int n) {
  const int c = (n + kCtaBytes - 1) / kCtaBytes;
  return c < 1 ? 1 : (c > kMaxCtas ? kMaxCtas : c);
}

// quorum = sum(stakes) // 3 + 1 on the wrapped int32 sum, floor division
// as jnp's // (the C quotient rounds toward zero).
CM_HD int32_t quorum_of(uint32_t total) {
  const int32_t t = (int32_t)total;
  int32_t q = t / 3;
  if (t % 3 != 0 && t < 0) q -= 1;
  return q + 1;
}

// Thread g of G's share of the stake sum (unsigned: wrap-around without
// undefined behaviour, in any order).
CM_HD uint32_t stake_part(const int32_t* stakes, int S, int g, int G) {
  uint32_t s = 0;
  for (int a = g; a < S; a += G) s += (uint32_t)stakes[a];
  return s;
}

// Thread t of nt's share of a CTA's table: every column's best row starts
// at 0 (the max of committed * w counts the rows not committed), or at
// INT32_MIN when there is no walk or no row (new_last = last).
CM_HD void init_best(int* best, int M, int B, int W, int t, int nt) {
  const int v = (B > 0 && W > 0) ? 0 : INT32_MIN;
  for (int p = t; p < M; p += nt) best[p] = v;
}

// The flat array's parts (n < 2^31 bytes, the wrapper checks) for a
// launch of G threads: bytes [0, head) and [tail, n) one at a time, the
// 16-byte words of [head, tail) whole.
struct Span {
  int n, head, tail;
};

CM_HD Span span_of(const void* masks, const void* committed, int n, int G) {
  const uintptr_t a = (uintptr_t)masks, c = (uintptr_t)committed;
  Span s{n, n, n};
  if (((a ^ c) & 15) == 0 && n > G) {
    const int h = (int)((16 - (a & 15)) & 15);
    s.head = h < n ? h : n;
    s.tail = s.head + (n - s.head) / 16 * 16;
  }
  return s;
}

CM_HD int words_of(const Span& sp) { return (sp.tail - sp.head) / 16; }

// The bytes outside the words, and the index of the e-th of them.
CM_HD int edge_of(const Span& sp) { return sp.head + (sp.n - sp.tail); }
CM_HD int edge_byte(const Span& sp, int e) { return e < sp.head ? e : sp.tail + (e - sp.head); }

struct Dims {
  int slab;  // W * M: the bytes of a walk
  int W, M;
  int32_t quorum;
};

// Raise the columns of the committed bytes i + j (bit j of `set`, j < 16:
// the bytes of one word) to their rows. The table entries are read first,
// all together, and only a byte whose row is higher than its entry takes
// the atomic (entries only grow, so a stale read costs an atomic at most).
template <class Mx>
CM_HD void raise_rows(int* best, const Dims& d, int i, uint32_t set, const Mx& mx) {
  const int r = i / d.M;
  int p[16], w[16], cur[16];
  p[0] = i - r * d.M;
  w[0] = r % d.W;
#pragma unroll
  for (int j = 1; j < 16; j++) {
    const bool wrap = p[j - 1] + 1 == d.M;
    p[j] = wrap ? 0 : p[j - 1] + 1;
    w[j] = wrap ? (w[j - 1] + 1 == d.W ? 0 : w[j - 1] + 1) : w[j - 1];
  }
#pragma unroll
  for (int j = 0; j < 16; j++) cur[j] = ((set >> j) & 1u) ? best[p[j]] : INT32_MAX;
#pragma unroll
  for (int j = 0; j < 16; j++) {
    if (w[j] > cur[j]) mx(best + p[j], w[j]);
  }
}

CM_HD void load16(const uint8_t* p, uint32_t v[4]) {
#ifdef __CUDA_ARCH__
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
#else
  std::memcpy(v, p, 16);
#endif
}

CM_HD void store16(uint8_t* p, const uint32_t v[4]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
#else
  std::memcpy(p, v, 16);
#endif
}

// The loaded word v of bytes [i, i + 16), whose first byte is in walk b0
// (ok0 its quorum test): masked (byte by byte across a walk boundary),
// stored, its committed bytes' rows raised.
template <class Mx>
CM_HD void commit_word(uint32_t v[4], uint8_t* committed, const int32_t* support,
                       const Dims& d, int i, int b0, bool ok0, int* best, const Mx& mx) {
  if (b0 == (i + 15) / d.slab) {
    if (!ok0) v[0] = v[1] = v[2] = v[3] = 0;
  } else {
    for (int j = 0; j < 16; j++) {
      if (support[(i + j) / d.slab] < d.quorum) v[j >> 2] &= ~(0xFFu << (8 * (j & 3)));
    }
  }
  store16(committed + i, v);
  uint32_t set = 0;  // bit j: byte j committed
#pragma unroll
  for (int j = 0; j < 16; j++) set |= ((v[j >> 2] >> (8 * (j & 3))) & 1u) << j;
  if (set) raise_rows(best, d, i, set, mx);
}

// kBatch of a thread's words, u0, u0 + G, ..., loaded with their walks'
// support before any is used (a word past the last reloads u0, unused);
// in the first batch also the thread's first byte outside the words.
struct Batch {
  uint32_t v[kBatch][4];
  int i[kBatch], b[kBatch];
  int32_t support[kBatch];
  uint8_t byte;
  int32_t byte_support;
};

CM_HD void load_batch(const uint8_t* masks, const int32_t* support, int slab, const Span& sp,
                      int u0, int G, Batch& x) {
  const int words = words_of(sp);
  if (u0 >= words) return;
#pragma unroll
  for (int k = 0; k < kBatch; k++) {
    const int u = u0 + k * G;
    x.i[k] = sp.head + 16 * (u < words ? u : u0);
    x.b[k] = x.i[k] / slab;
    load16(masks + x.i[k], x.v[k]);
    x.support[k] = support[x.b[k]];
  }
}

// Thread g of G's first batch: its words g, g + G, ... and its byte g
// outside them, each with its walk's support.
CM_HD void load_first(const uint8_t* masks, const int32_t* support, int slab, const Span& sp,
                      int g, int G, Batch& x) {
  load_batch(masks, support, slab, sp, g, G, x);
  if (g < edge_of(sp)) {
    const int i = edge_byte(sp, g);
    x.byte = masks[i];
    x.byte_support = support[i / slab];
  }
}

// Thread g of the launch's G: its words, kBatch at a time, then its bytes
// outside them; x holds its first batch (load_first).
template <class Mx>
CM_HD void commit_stream(const uint8_t* masks, uint8_t* committed, const int32_t* support,
                         const Dims& d, const Span& sp, int* best, int g, int G, Batch& x,
                         const Mx& mx) {
  const int words = words_of(sp);
  for (int u0 = g; u0 < words; u0 += kBatch * G) {
    if (u0 != g) load_batch(masks, support, d.slab, sp, u0, G, x);
#pragma unroll
    for (int k = 0; k < kBatch; k++) {
      if (u0 + k * G < words)
        commit_word(x.v[k], committed, support, d, x.i[k], x.b[k], x.support[k] >= d.quorum,
                    best, mx);
    }
  }
  const int edge = edge_of(sp);
  for (int e = g; e < edge; e += G) {
    const int i = edge_byte(sp, e);
    uint8_t m = x.byte;
    int32_t s = x.byte_support;
    if (e != g) {
      m = masks[i];
      s = support[i / d.slab];
    }
    const bool c = m && s >= d.quorum;
    committed[i] = c;
    if (c) raise_rows(best, d, i, 1u, mx);
  }
}

// Thread t of nt of the folding CTA: new_last[p] = max(last[p], the best
// row of column p in each of the C tables); table(c) is CTA c's, and
// last_t is last[t] (read before the stream) when t < M.
template <class Tab>
CM_HD void fold(int32_t last_t, const int32_t* last, int32_t* new_last, int M, int C,
                const Tab& table, int t, int nt) {
  for (int p = t; p < M; p += nt) {
    int32_t v = p == t ? last_t : last[p];
    for (int c = 0; c < C; c++) {
      const int b = table(c)[p];
      v = b > v ? b : v;
    }
    new_last[p] = v;
  }
}

}  // namespace commit_mask
