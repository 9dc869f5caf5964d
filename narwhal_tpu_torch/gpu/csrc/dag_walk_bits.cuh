#pragma once

// The packed-bit form of the commit walk (B2, chain_commit_kernel and
// chain_commit_wide_kernel in dag_window.cu) and of the batched reach walk
// (B6, reach_many_kernel and reach_many_wide_kernel): byte tensors turned
// into bit strings, rows read out of them, the walk of one leader (B2) or
// one read (B6) by one warp over packed rows, and the wide walk of a CTA.
//
// Every function is WB_HD (host and device under nvcc, plain inline C++
// otherwise), and the walks are thread code with the warp's or the CTA's
// collectives behind a small interface (`WarpLanes`, `CtaThreads` on the
// card), so a host compiler can run them on threads and hold them against
// the plain version without a card.
//
// Bit strings: bit j of a string over bytes [lo, hi) of a tensor is
// (byte lo + j != 0), bit j in word j / 32 at position j % 32 (the order of
// __ballot_sync over 32 consecutive bytes); bytes at or past hi read as 0.
// The walk's strings: parent rows 1..top from byte lo = N*N rounded down to
// 32 (so the string's words start 16-byte aligned), present rows 0..top
// from byte 0. Row (w, a) of parent is bits ((w*N + a)*N - lo) .. +N; the
// walk reads parent through a column table built from its string.

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WB_HD __host__ __device__ __forceinline__
#else
#define WB_HD inline
#endif

namespace walk_bits {

constexpr int kSentinel = -(1 << 30);

// Bit k (k < 4) = byte k of x is nonzero. Bit 0 of each byte gathers the
// byte's 8 bits (shifts stay inside the byte for bit 0), then one multiply
// moves the four bytes' bit 0 to bits 21..24 (terms 8i + 7j, i + j = 3)
// without carries (every other term lands on its own bit).
WB_HD uint32_t nz_nibble(uint32_t x) {
  uint32_t t = x | (x >> 4);
  t |= t >> 2;
  t |= t >> 1;
  return (((t & 0x01010101u) * 0x00204081u) >> 21) & 0xFu;
}

// The 32 bytes at p as 8 little-endian words. On the card: two 16-byte
// loads when p is 16-byte aligned, else 8-, 4- or 1-byte loads.
WB_HD void load32(const uint8_t* p, uint32_t q[8]) {
#ifdef __CUDA_ARCH__
  const uintptr_t a = (uintptr_t)p;
  if ((a & 15) == 0) {
    const uint4 x = __ldg((const uint4*)p), y = __ldg((const uint4*)p + 1);
    q[0] = x.x; q[1] = x.y; q[2] = x.z; q[3] = x.w;
    q[4] = y.x; q[5] = y.y; q[6] = y.z; q[7] = y.w;
  } else if ((a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const uint2 x = __ldg((const uint2*)p + i);
      q[2 * i] = x.x;
      q[2 * i + 1] = x.y;
    }
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 8; i++) q[i] = __ldg((const uint32_t*)p + i);
  } else {
#pragma unroll
    for (int i = 0; i < 8; i++) {
      q[i] = (uint32_t)__ldg(p + 4 * i) | ((uint32_t)__ldg(p + 4 * i + 1) << 8) |
             ((uint32_t)__ldg(p + 4 * i + 2) << 16) | ((uint32_t)__ldg(p + 4 * i + 3) << 24);
    }
  }
#else
  std::memcpy(q, p, 32);
#endif
}

// Word i of the bit string of bytes [lo, hi) of src.
WB_HD uint32_t pack_word(const uint8_t* src, long long lo, long long hi, long long i) {
  const long long b = lo + 32 * i;
  if (b + 32 <= hi) {
    uint32_t q[8];
    load32(src + b, q);
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) w |= nz_nibble(q[k]) << (4 * k);
    return w;
  }
  uint32_t w = 0;
  for (int j = 0; j < 32 && b + j < hi; j++) w |= (uint32_t)(src[b + j] != 0) << j;
  return w;
}

// Bits [bit, bit + n) of the string s (n <= 64) as two words, bits past n
// zero. Reads words bit/32 .. bit/32 + 2: a string carries two zero words
// of slack past its end.
WB_HD void row_bits(const uint32_t* s, long long bit, int n, uint32_t& w0, uint32_t& w1) {
  const long long q = bit >> 5;
  const int r = (int)(bit & 31);
  const uint32_t a = s[q], b = s[q + 1], c = s[q + 2];
#ifdef __CUDA_ARCH__
  w0 = __funnelshift_r(a, b, r);
  w1 = __funnelshift_r(b, c, r);
#else
  w0 = r ? (a >> r) | (b << (32 - r)) : a;
  w1 = r ? (b >> r) | (c << (32 - r)) : b;
#endif
  if (n < 32) {
    w0 &= (1u << n) - 1u;
    w1 = 0;
  } else if (n < 64) {
    w1 &= (1u << (n - 32)) - 1u;
  }
}

// The warp's collectives, as lane code calls them: `lane` is the caller's
// lane, ballot returns the warp-uniform vote, shfl_xor lane ^ m's value,
// sync orders the lanes' shared-memory writes before their reads. On the
// card, the warp intrinsics; a host harness implements the same interface
// over 32 threads.
#ifdef __CUDACC__
struct WarpLanes {
  int lane;
  __device__ __forceinline__ uint32_t ballot(bool b) const { return __ballot_sync(0xffffffffu, b); }
  __device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int m) const {
    return __shfl_xor_sync(0xffffffffu, v, m);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

// The CTA's, as thread code calls them: `tid` is the caller's thread, `nt`
// the CTA's size, ballot the vote of the caller's warp, sync a CTA barrier,
// sync_or a barrier that returns whether any thread passed true,
// atomic_max the shared-memory atomic.
struct CtaThreads {
  int tid, nt;
  __device__ __forceinline__ uint32_t ballot(bool b) const { return __ballot_sync(0xffffffffu, b); }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ bool sync_or(bool b) const { return __syncthreads_or(b) != 0; }
  __device__ __forceinline__ void atomic_max(int* a, int v) const { atomicMax(a, v); }
};
#endif

// The column table: ct[w * N + p] = the parent bits of column p of row w
// over the certificates a of that row (word 0: a < 32, word 1: a >= 32), so
// a row step tests a column against the row above's reach set directly.
struct Tables {
  const uint32_t* ct;   // [W][N][2]
  const uint32_t* pre;  // [W][2]: row w's present bits (rows 0..top)
  int N;
};

// A 32 x 32 bit transpose across the warp: lane i holds row i (bit j =
// column j); after it lane j holds column j (bit i = row i). Five rounds
// swap the off-diagonal blocks of width 16, 8, 4, 2, 1.
template <class L>
WB_HD uint32_t transpose32(const L& x, uint32_t v) {
  const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u, 0x55555555u};
  int k = 0;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1, k++) {
    const uint32_t m = masks[k];
    const uint32_t y = x.shfl_xor(v, s);
    v = (x.lane & s) ? (v & ~m) | ((y & ~m) >> s) : (v & m) | ((y & m) << s);
  }
  return v;
}

// Warp `warp` of `nwarps`: the column table of parent rows 1..top from the
// parent string (rows from byte par_lo), one 32 x 32 block (row block A,
// column block P) of one row a task; and the present rows 0..top as word
// pairs from the present string, a lane a row.
template <class L>
WB_HD void column_table(const L& x, const uint32_t* par, int par_lo, const uint32_t* pre,
                        int N, int top, uint32_t* ct, uint32_t* prw, int warp, int nwarps) {
  for (int w = warp * 32 + x.lane; w <= top; w += nwarps * 32) {
    row_bits(pre, (long long)w * N, N, prw[2 * w], prw[2 * w + 1]);
  }
  const int nb = (N + 31) >> 5, per_row = nb * nb, tasks = top * per_row;
  // two tasks at a time, so their shuffle rounds overlap
  for (int t0 = warp; t0 < tasks; t0 += 2 * nwarps) {
    uint32_t r[2] = {0u, 0u}, c[2];
    int at[2], pt[2], wt[2];
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int task = t0 + h * nwarps;
      const int w = 1 + task / per_row, blk = task % per_row, A = blk / nb, P = blk % nb;
      const int a = 32 * A + x.lane, cols = N - 32 * P < 32 ? N - 32 * P : 32;
      uint32_t hi = 0;
      if (task < tasks && a < N) {
        row_bits(par, ((long long)w * N + a) * N - par_lo + 32 * P, cols, r[h], hi);
      }
      wt[h] = task < tasks ? w : -1;
      at[h] = A;
      pt[h] = 32 * P + x.lane;
    }
    c[0] = transpose32(x, r[0]);
    c[1] = transpose32(x, r[1]);
#pragma unroll
    for (int h = 0; h < 2; h++) {
      if (wt[h] >= 0 && pt[h] < N) ct[((size_t)wt[h] * N + pt[h]) * 2 + at[h]] = c[h];
    }
  }
}

// One leader's walk by one warp (N <= 64: a row is two words). lc [N] is the
// last committed round per column (read and advanced), keep [W][2] receives
// the kept words of every row (rows above the start zero), lcr is advanced
// as chain_commit_plain advances it. `oh` is the leader's one-hot bytes, s
// its start row. Row by row, from the start down: lane l decides columns l
// and l + 32, reached when their column words of the row above meet that
// row's reach set (`links^T @ frontier > 0`, bit-parallel), and a ballot
// makes the row's set, ANDed with its uncommitted words (present bits and a
// ballot of w > lc[p]); the gc test is one compare a row. No barrier and no
// cross-lane reduction: a row's dependent chain is an AND, a compare and a
// vote. What a row reads that does not depend on the reach set (its column
// words, its present bits, its lc ballots) is loaded one row ahead.
//
// kChain false is reach_mask alone (B6's read): `t.pre` holds the caller's
// uncommitted rows, there is no lc ballot, no gc test and no bookkeeping
// (lc, gc_depth and lcr are not touched), and the walk stops at the first
// row whose reach set is empty, writing zero words for the rows below it
// (nothing under an empty row is reached; the set is a ballot, so the stop
// is warp-uniform).
template <bool kChain, class L>
WB_HD void walk_leader(const L& x, const Tables& t, const uint8_t* oh, int s, int W,
                       int gc_depth, int* lc, int& lcr, uint32_t* keep) {
  const int N = t.N, l = x.lane;
  const uint32_t o0 = x.ballot(l < N && oh[l] != 0);
  const uint32_t o1 = x.ballot(l + 32 < N && oh[l + 32] != 0);
  const bool live = (o0 | o1) != 0 && s >= 0 && s < W;
  const int first = live ? s : -1;
  for (int w = first + 1 + l; w < W; w += 32) {
    keep[2 * w] = 0;
    keep[2 * w + 1] = 0;
  }
  const bool has0 = l < N, has1 = l + 32 < N;
  const int lc0 = kChain && has0 ? lc[l] : 0, lc1 = kChain && has1 ? lc[l + 32] : 0;
  int top_kept = kSentinel;
  int c0 = kSentinel, c1 = kSentinel;  // this lane's columns' committed rows
  uint32_t f0 = 0, f1 = 0;             // the reach set of the row above
  uint32_t a0 = 0, a1 = 0, b0 = 0, b1 = 0;  // row w's column words (w + 1, l), (w + 1, l + 32)
  uint32_t p0 = 0, p1 = 0, m0 = ~0u, m1 = ~0u;  // row w's present words and lc ballots
  if (first >= 0) {
    p0 = t.pre[2 * first];
    p1 = t.pre[2 * first + 1];
    if (kChain) {
      m0 = x.ballot(first > lc0);
      m1 = x.ballot(first > lc1);
    }
  }
  for (int w = first; w >= 0; w--) {
    // row w - 1's reads, ahead of this row's dependent chain (used one row
    // later, so no load latency stands in the chain)
    uint32_t na0 = 0, na1 = 0, nb0 = 0, nb1 = 0, np0 = 0, np1 = 0, nm0 = ~0u, nm1 = ~0u;
    if (w > 0) {
      // every lane loads (lanes past N read column 0 and drop it): no
      // divergence on the row's path
      const uint32_t* col = t.ct + (size_t)w * N * 2;
      const int pa = has0 ? l : 0, pb = has1 ? l + 32 : 0;
      na0 = has0 ? col[2 * pa] : 0u;
      na1 = has0 ? col[2 * pa + 1] : 0u;
      nb0 = has1 ? col[2 * pb] : 0u;
      nb1 = has1 ? col[2 * pb + 1] : 0u;
      np0 = t.pre[2 * (w - 1)];
      np1 = t.pre[2 * (w - 1) + 1];
      if (kChain) {
        nm0 = x.ballot(w - 1 > lc0);
        nm1 = x.ballot(w - 1 > lc1);
      }
    }
    uint32_t r0 = o0, r1 = o1;
    if (w < first) {
      r0 = x.ballot(((a0 & f0) | (a1 & f1)) != 0);
      r1 = x.ballot(((b0 & f0) | (b1 & f1)) != 0);
    }
    f0 = r0 & p0 & m0;  // reached, present and not committed before this leader
    f1 = r1 & p1 & m1;
    if (!kChain) {
      keep[2 * w] = f0;
      keep[2 * w + 1] = f1;
      if ((f0 | f1) == 0) {
        for (int j = l; j < w; j += 32) {
          keep[2 * j] = 0;
          keep[2 * j + 1] = 0;
        }
        break;
      }
    } else {
      const bool gc = w + gc_depth >= lcr;
      const uint32_t k0 = gc ? f0 : 0u, k1 = gc ? f1 : 0u;
      keep[2 * w] = k0;  // every lane stores the same words: no branch on the row's path
      keep[2 * w + 1] = k1;
      if (((k0 >> l) & 1u) && c0 == kSentinel) c0 = w;
      if (((k1 >> l) & 1u) && c1 == kSentinel) c1 = w;
      if ((k0 | k1) != 0 && top_kept == kSentinel) top_kept = w;
    }
    a0 = na0;
    a1 = na1;
    b0 = nb0;
    b1 = nb1;
    p0 = np0;
    p1 = np1;
    m0 = nm0;
    m1 = nm1;
  }
  if (kChain) {
    // lc = max(lc, committed), lcr = max(lcr, max_p committed), committed[p]
    // the highest kept row of column p, else the sentinel.
    if (has0 && c0 > lc0) lc[l] = c0;
    if (has1 && c1 > lc1) lc[l + 32] = c1;
    if (top_kept > lcr) lcr = top_kept;
  }
  x.sync();
}

// B6's read by one warp over the CTA's column table: walked
// (walk_leader<false>) into the warp's keep rows [W][2] and expanded into
// its [W, N] mask bytes a row at a time, lane l writing columns l and l + 32
// (every byte of the mask).
template <class L>
WB_HD void reach_read(const L& x, const Tables& t, int s, const uint8_t* onehot, bool* mask,
                      int W, uint32_t* keep) {
  const int N = t.N, l = x.lane;
  int unused = 0;
  walk_leader<false>(x, t, onehot, s, W, 0, nullptr, unused, keep);
  for (int w = 0; w < W; w++) {
    const uint32_t k0 = keep[2 * w], k1 = keep[2 * w + 1];
    if (l < N) mask[(size_t)w * N + l] = (k0 >> l) & 1u;
    if (l + 32 < N) mask[(size_t)w * N + l + 32] = (k1 >> l) & 1u;
  }
}

// The byte at src, as a word (__ldg on the card), and the index of the
// lowest set bit of a nonzero word.
WB_HD uint32_t ld_byte(const uint8_t* src) {
#ifdef __CUDA_ARCH__
  return __ldg(src);
#else
  return *src;
#endif
}

WB_HD int low_bit(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __ffs(v) - 1;
#else
  return __builtin_ctz(v);
#endif
}

// One batch of has_parent's scan: the next U set bits of f (from word *wi,
// whose bits not yet taken are *bits), their bytes loaded together. Returns
// 1 on a parent, 0 when the bits ran out, -1 when more are left.
template <int U>
WB_HD int parent_batch(const uint8_t* col, long long N, const uint32_t* f, int nw, int& wi,
                       uint32_t& bits) {
  int a[U];
#pragma unroll
  for (int u = 0; u < U; u++) {
    while (bits == 0 && wi + 1 < nw) bits = f[++wi];
    a[u] = bits ? wi * 32 + low_bit(bits) : -1;
    bits &= bits - 1u;
  }
  uint32_t hit = 0;
#pragma unroll
  for (int u = 0; u < U; u++) hit |= a[u] >= 0 ? ld_byte(col + a[u] * N) : 0u;
  return hit ? 1 : a[U - 1] < 0 ? 0 : -1;
}

// Whether column p has a parent among the set bits of the frontier words
// f[0, nw): col points at byte (a = 0, p) of a parent row block, row a at
// col + a * N. The set bits are taken lowest first in batches whose loads
// go out together: 8, which ends the scan at a dense quorum of links, then
// 16 at a time for a column that has not found one.
WB_HD bool has_parent(const uint8_t* col, long long N, const uint32_t* f, int nw) {
  int wi = 0;
  uint32_t bits = f[0];
  int r = parent_batch<8>(col, N, f, nw, wi, bits);
  while (r < 0) r = parent_batch<16>(col, N, f, nw, wi, bits);
  return r > 0;
}

// The wide walk (chain_commit_wide_kernel: N > 64, or a window whose tables
// do not fit in shared memory), one CTA of 32 * ceil(N / 32) threads, thread
// p owning column p, one CTA barrier a row. A row's frontier (its reached,
// uncommitted certificates) is a ballot per warp, packed words in shared
// memory by row parity. Row w's step: column p, if present and above lc[p],
// is reached when it has a parent among the set bits of row w + 1's
// frontier (`has_parent`: the loads of a batch of set bits go out together,
// coalesced over the warp's columns, and a dense quorum of links ends the
// scan at the first batch); its present byte is loaded a row ahead. The gc
// test is one compare a row, committed[p] the first kept row from the top.
// sm is 2 * ceil(N / 32) shared words, cand two shared ints (the lcr
// candidate, by leader parity). B6's wide route runs it for one read (K 1)
// with lc_rel null (every column's lc the sentinel), gc_depth 0 and lcr the
// sentinel: every present column is uncommitted and every reached one kept,
// which is reach_mask.
template <class C>
WB_HD void wide_walk(const C& x, const uint8_t* parent, const uint8_t* present,
                     const int32_t* lc_rel, const int32_t* offs, const uint8_t* onehots,
                     bool* masks, int W, int N, int K, int gc_depth, int lcr_rel, uint32_t* sm,
                     int* s_cand) {
  const int NW = (N + 31) >> 5;
  const int p = x.tid, lane = p & 31, warp = p >> 5;
  const bool col = p < N;
  int lc = !col ? 0 : lc_rel ? lc_rel[p] : kSentinel;
  int lcr = lcr_rel;
  for (int k = 0; k < K; k++) {
    int* cand = s_cand + (k & 1);
    const bool bit = col && onehots[(size_t)k * N + p] != 0;
    if (p == 0) *cand = kSentinel;
    const int s = offs[k];
    const bool live = x.sync_or(bit) && s >= 0 && s < W;
    const int first = live ? s : -1;
    bool* out = masks + (size_t)k * W * N;
    if (col) {
      for (int w = W - 1; w > first; w--) out[(size_t)w * N + p] = false;
    }
    int committed = kSentinel;
    uint32_t pres = col && first >= 0 ? ld_byte(present + (size_t)first * N + p) : 0u;
    for (int w = first; w >= 0; w--) {
      const uint32_t next = col && w > 0 ? ld_byte(present + (size_t)(w - 1) * N + p) : 0u;
      const bool unc = pres != 0 && w > lc;
      const bool here =
          unc && (w == first ? bit
                             : has_parent(parent + (size_t)(w + 1) * N * N + p, N,
                                          sm + ((w + 1) & 1) * NW, NW));
      const uint32_t f = x.ballot(here);
      if (lane == 0) sm[(w & 1) * NW + warp] = f;
      const bool keep = here && w + gc_depth >= lcr;
      if (col) out[(size_t)w * N + p] = keep;
      if (keep && committed == kSentinel) committed = w;
      pres = next;
      x.sync();
    }
    if (committed > kSentinel) x.atomic_max(cand, committed);
    x.sync();
    if (committed > lc) lc = committed;
    if (*cand > lcr) lcr = *cand;
  }
}

}  // namespace walk_bits
