#pragma once

// The window sync (window_sync_kernel in dag_window.cu): its parameter
// block, the host code that packs it, and the per-row body of a CTA.
//
// The device functions are WS_HD (host and device under nvcc, plain inline
// C++ otherwise), and the body is thread code with the CTA's one barrier
// between its two phases left to the caller, so a host compiler can run a
// CTA as a loop over its threads (the copy of every thread, then the
// placements of every thread) and hold it against the plain version.
//
// The parameter block carries T slots as one bit string: slot i is the
// S = ob + ib + N bits from bit i * S, its round offset in the low ob bits
// (ob = the bits of W - 1), then its authority index (ib = the bits of
// N - 1), then its parent row, bit c = column c. Bit j of the string is
// bit j % 32 of word j / 32. `for_each_block` packs the blocks of one sync
// on the host: at W = 64, N = 50 a slot is 62 bits and a block holds 515
// slots.

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WS_HD __host__ __device__ __forceinline__
#else
#define WS_HD inline
#endif

namespace window_sync {

// Words of slot bits a launch carries. The block (4 + 4 * kWords bytes)
// and the kernel's other arguments (four pointers and four ints) stay
// under the 4,096 bytes of parameters every CUDA 12 launch accepts. The
// last word is slack: a field that ends in word k is read with word k + 1.
constexpr int kWords = 1000;

// The default grid: a parent row over kRowSplit CTAs of kMinChunk to
// kChunk bytes each (640 bytes, four CTAs a row, at N = 50: 0.0002-0.0004
// ms less device time than a CTA a row at W 64 and 128, the sweep of
// msm_breakdown.py's window section on an H100; a CTA of at most
// kMinChunk bytes pays more to start than it copies).
constexpr long long kRowSplit = 4;
constexpr long long kMinChunk = 640;
constexpr long long kChunk = 16384;

struct Slots {
  int T;              // slots in this block
  uint32_t w[kWords];
};

static_assert(sizeof(Slots) + 4 * sizeof(void*) + 4 * sizeof(int) <= 4096,
              "window_sync's parameters must fit the 4 KB every launch takes");

// Bits that hold the values 0 .. x - 1.
WS_HD int field_bits(int x) {
  int b = 0;
  while (b < 31 && (1 << b) < x) b++;
  return b;
}

WS_HD int slot_bits(int W, int N) { return field_bits(W) + field_bits(N) + N; }

// Slots a block holds (0 when one slot is wider than a block).
WS_HD int capacity(int W, int N) { return (int)((kWords - 1) * 32LL / slot_bits(W, N)); }

// The n <= 32 bits of the string from bit p.
WS_HD uint32_t bits_at(const uint32_t* w, long long p, int n) {
  const long long k = p >> 5;
  const uint64_t v = (((uint64_t)w[k + 1] << 32) | w[k]) >> (p & 31);
  return n >= 32 ? (uint32_t)v : (uint32_t)v & ((1u << n) - 1u);
}

// Slot i of the block: its offset and index; returns the bit of its row's
// column 0.
WS_HD long long slot_at(const Slots& s, int i, int W, int N, int& off, int& idx) {
  const int ob = field_bits(W), ib = field_bits(N);
  const long long p = (long long)i * (ob + ib + N);
  const uint32_t cell = bits_at(s.w, p, ob + ib);
  off = (int)(cell & ((1u << ob) - 1u));
  idx = (int)(cell >> ob);
  return p + ob + ib;
}

#ifdef __CUDACC__
using Word16 = uint4;
#else
struct alignas(16) Word16 {
  uint32_t x, y, z, w;
};
#endif

// Thread tid of nt: bytes [lo, hi) of row w of a tensor of W rows of `row`
// bytes get the input's row w + shift, or zeros when w + shift >= W
// (shift <= W), in words of V, which divides row, lo, hi and the bases.
template <typename V>
WS_HD void copy_words(int tid, int nt, const uint8_t* in, uint8_t* out, long long row,
                      long long lo, long long hi, int w, int W, int shift) {
  V* dst = (V*)(out + (long long)w * row + lo);
  const long long n = (hi - lo) / (long long)sizeof(V);
  if (w + shift < W) {
    const V* src = (const V*)(in + (long long)(w + shift) * row + lo);
    for (long long i = tid; i < n; i += nt) dst[i] = src[i];
  } else {
    for (long long i = tid; i < n; i += nt) dst[i] = V{};
  }
}

// copy_words in the widest word the row's stride, the chunk and the two
// tensors' alignment allow: 16 bytes, else 4, else 1.
WS_HD void copy_row(int tid, int nt, const uint8_t* in, uint8_t* out, long long row,
                    long long lo, long long hi, int w, int W, int shift) {
  const uint64_t a = (uint64_t)(uintptr_t)in | (uint64_t)(uintptr_t)out | (uint64_t)row |
                     (uint64_t)lo | (uint64_t)hi;
  if ((a & 15) == 0) {
    copy_words<Word16>(tid, nt, in, out, row, lo, hi, w, W, shift);
  } else if ((a & 3) == 0) {
    copy_words<uint32_t>(tid, nt, in, out, row, lo, hi, w, W, shift);
  } else {
    copy_words<uint8_t>(tid, nt, in, out, row, lo, hi, w, W, shift);
  }
}

// Thread tid of nt: the block's slots tid, tid + nt, ... that sit at round
// offset w, each written into bytes [lo, hi) of parent row w (its N bytes
// from idx * N on, from its bits, 32 columns a read), and its present byte
// set to 1 by the CTA that holds byte 0 of the row (lo == 0). A thread a
// slot puts every cell read of the CTA in flight at once (a warp a slot
// waited on one read after another). Duplicate slots write equal bytes.
WS_HD void place_row(int tid, int nt, const Slots& s, int w, int W, int N, long long lo,
                     long long hi, uint8_t* parent, uint8_t* present) {
  uint8_t* dst = parent + (long long)w * N * N;
  for (int i = tid; i < s.T; i += nt) {
    int off, idx;
    const long long r = slot_at(s, i, W, N, off, idx);
    if (off != w) continue;
    const long long base = (long long)idx * N;
    const long long b0 = base > lo ? base : lo;
    const long long b1 = base + N < hi ? base + N : hi;
    const long long q = r - base;  // bit of byte j of the row: q + j
    for (long long j = b0; j < b1; j += 32) {
      const int n = b1 - j < 32 ? (int)(b1 - j) : 32;
      const uint32_t bits = bits_at(s.w, q + j, n);
      for (int k = 0; k < n; k++) dst[j + k] = (uint8_t)((bits >> k) & 1u);
    }
    if (lo == 0) present[(long long)w * N + idx] = 1;
  }
}

// CTA (w, y) of the grid (W, chunks of `chunk` bytes of a parent row),
// thread tid of nt. Phase 1, when the outputs are not the inputs (a roll,
// out of place): chunk y of parent row w and, y == 0, present row w,
// rolled by shift.
WS_HD void cta_copy(int tid, int nt, int w, int y, long long chunk, const uint8_t* parent,
                    const uint8_t* present, uint8_t* out_parent, uint8_t* out_present, int W,
                    int N, int shift) {
  const long long row = (long long)N * N, lo = (long long)y * chunk;
  const long long hi = lo + chunk < row ? lo + chunk : row;
  copy_row(tid, nt, parent, out_parent, row, lo, hi, w, W, shift);
  if (y == 0) copy_row(tid, nt, present, out_present, N, 0, N, w, W, shift);
}

// Phase 2, after the CTA's barrier: the block's slots in the CTA's chunk.
WS_HD void cta_place(int tid, int nt, int w, int y, long long chunk, const Slots& s,
                     uint8_t* out_parent, uint8_t* out_present, int W, int N) {
  const long long row = (long long)N * N, lo = (long long)y * chunk;
  const long long hi = lo + chunk < row ? lo + chunk : row;
  place_row(tid, nt, s, w, W, N, lo, hi, out_parent, out_present);
}

// -- host: the grid and the blocks of one sync --------------------------------

// Bytes of a parent row of `row` bytes a CTA takes when the caller asks
// for `chunk` (0: the default grid): a multiple of 16, so a CTA's copy can
// move 16-byte words.
inline long long chunk_bytes(int chunk, long long row) {
  if (chunk > 0) return (chunk + 15LL) / 16 * 16;
  const long long c = ((row + kRowSplit - 1) / kRowSplit + 15) / 16 * 16;
  return c < kMinChunk ? kMinChunk : c > kChunk ? kChunk : c;
}

// ORs the n <= 32 bits of v into the string at bit p (bits above n of v
// are zero).
inline void put_bits(uint32_t* w, long long p, uint64_t v, int n) {
  if (n == 0) return;
  const long long k = p >> 5;
  const uint64_t x = v << (p & 31);
  w[k] |= (uint32_t)x;
  if ((p & 31) + n > 32) w[k + 1] |= (uint32_t)(x >> 32);
}

// Packs into s the slots from `first` on that lie inside the window
// (0 <= offs[t] < W, 0 <= idxs[t] < N; the rest are dropped) until s is
// full; returns the first slot it did not reach. rows[t] is row t's
// (N + 7) / 8 bytes, column c at bit c % 8 of byte c / 8 (numpy's
// packbits with bitorder "little").
inline int pack_block(const int32_t* offs, const int32_t* idxs, const uint8_t* rows, int first,
                      int T, int W, int N, Slots& s) {
  const int ob = field_bits(W), ib = field_bits(N), cap = capacity(W, N), rb = (N + 7) / 8;
  std::memset(&s, 0, sizeof(s));
  int t = first;
  for (; t < T && s.T < cap; t++) {
    if (offs[t] < 0 || offs[t] >= W || idxs[t] < 0 || idxs[t] >= N) continue;
    const long long p = (long long)s.T * slot_bits(W, N);
    put_bits(s.w, p, (uint64_t)offs[t] | ((uint64_t)idxs[t] << ob), ob + ib);
    const uint8_t* r = rows + (long long)t * rb;
    for (int j = 0; j < rb; j++) {
      const int n = N - 8 * j < 8 ? N - 8 * j : 8;
      put_bits(s.w, p + ob + ib + 8 * j, r[j] & ((1u << n) - 1u), n);
    }
    s.T++;
  }
  return t;
}

// The launches of one sync of T slots: launch(s, shift) for each parameter
// block s, the first with the sync's shift and the rest with 0. When
// `rolls` (the outputs are not the inputs) the first launch runs even with
// no slot; otherwise a sync with no slot inside the window launches
// nothing. Stops at the first launch that returns nonzero and returns
// that; `launches` counts the launches made.
template <typename Launch>
int for_each_block(const int32_t* offs, const int32_t* idxs, const uint8_t* rows, int T, int W,
                   int N, int shift, bool rolls, int& launches, Launch&& launch) {
  Slots s;
  launches = 0;
  int t = 0;
  do {
    t = pack_block(offs, idxs, rows, t, T, W, N, s);
    if (s.T == 0 && !(rolls && launches == 0)) break;
    const int rc = launch(s, launches == 0 ? shift : 0);
    if (rc != 0) return rc;
    launches++;
  } while (t < T);
  return 0;
}

}  // namespace window_sync
