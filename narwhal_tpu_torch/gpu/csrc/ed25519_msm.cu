// Window-lane sums of a random linear combination of ed25519 points, for
// Hopper (sm_90a): the device half of batch (RLC) signature verification.
//
// Replaces: narwhal_tpu/tpu/ed25519.py:666 `msm_accumulate_kernel` (TPU kernel
// A2). Same inputs (the JAX host layout: int16 radix-2^13 limbs a_y/r_y
// [B, 20], int8 signs [B], int8 4-bit digits ak_digits [B, 64] and z_digits
// [B, 32], MSB first) and the same outputs:
//   V_a[:, :, w] = sum_j ak_digits[j, w] * (-A_j)   w < 64   int32 [4, 20, 64]
//   V_r[:, :, w] = sum_j  z_digits[j, w] * (-R_j)   w < 32   int32 [4, 20, 32]
//   valid[j]     = A_j and R_j both decompress                bool [B]
// V is projective (X, Y, Z, T) per window lane, written as canonical limbs
// mod p in the JAX radix-2^13 layout, so the host epilogue
// (verifier.msm_epilogue_check) reads the kernel and the plain version alike.
// The plain PyTorch version is `msm_accumulate_plain` in ../ed25519.py.
//
// The same source holds two more entry points of the mesh-sharded verifier:
//   A6  ed25519_msm_window replaces narwhal_tpu/tpu/ed25519.py:549
//       `msm_window_kernel`: one point set already decompressed by A3
//       (int32 [4, 20, B], the JAX stage layout) and one digit set int8
//       [B, W] (W = 64 for A or 32 for R, the two widths it is built for)
//       -> V int32 [4, 20, W]. It is A2's kernel over one lane set that
//       reads points instead of decompressing them, so A3 -> A6 (A) and
//       A3 -> A6 (R) give A2's V_a and V_r as points, invalid rows included.
//   A6' ed25519_msm_shard_reduce, the port's counterpart of the
//       cross-device reduce that XLA inserts after A6 on a mesh
//       (narwhal_tpu/tpu/verifier.py:96-102, out_specs=None): the n shards'
//       lane sets of both A6 calls of a bucket, the A set (n x [4, 20, WA])
//       and the R set (n x [4, 20, WR]), each lane summed with the complete
//       addition in shard order, set 0 first (off the curve the addition
//       law is not associative, so the order is part of the result).
//       Bound: bytes, the 2n lane sets read once and two written (~0.06 us
//       at n = 2), so its time is a launch and (n - 1) dependent additions.
//       One launch for both sets: a CTA a set, a quad per lane
//       (quad_shard_sum: each addition is quad_add, 3 product rounds deep
//       instead of 9 dependent products, the next addend loaded during
//       it), reading every shard's set in place through a table of 2n
//       pointers passed in the launch's parameters (no stack of the sets,
//       nothing uploaded).
// Their plain versions are `msm_window_plain` and `msm_shard_reduce_plain`.
//
// The order of the point additions is the JAX kernel's. Off the curve (an
// invalid encoding) the addition law is not associative, so another grouping
// would give another lane:
//   - table entry i of a point P is entry i - 1 plus P (i = 2 .. 15), entry
//     1 the cached -P; digit d selects entry d;
//   - chain c of C = min(128, B) (the wrapper's `chains`, the JAX `chunk`)
//     adds the points c, c + C, c + 2C, ... of each lane in that order;
//   - the tree over the C chain sums adds chain t + C/2^(r+1) into chain t
//     in round r.
// A digit 0 selects the cached identity (1, 1, 1, 0), with which the JAX
// kernel's cached add returns (4XZ, 4YZ, 4Z^2, 4XY): the same projective
// point, and every later addition is homogeneous. So the kernel skips such
// an add when all eight lanes of a warp have a digit 0 (zero rows, the
// group lane's all-zero R slot, which also builds no table), and adds the
// identity entry when only some have. Its V is the plain version's V as
// projective points: chip_smoke.py and tests/test_torch_cuda.py compare the
// lanes as affine points (canonical x = X/Z, y = Y/Z), and valid bit for bit.
//
// Two launches per call on one stream, for Hopper:
//   - msm_chains_kernel, one CTA per chain c, 4 threads per window lane (A2:
//     96 lanes, 384 threads; A6: 4W). The CTA's rows are j = c + s C, s < S
//     = B / C, taken in tiles of `tile` rows (all S at B <= 2048; A2 32 and
//     A6 64 above it, so a tile fits the 227 KB of shared memory), the lane
//     sums carried in registers from tile to tile. Per tile: the rows'
//     digits into shared memory; the points, negated, into shared memory
//     (A2: a thread per point decompresses it and writes the row's
//     validity; A6: a thread per coordinate reads it); the 15 cached
//     multiples of every point with a nonzero digit, in shared memory (a
//     quad of threads per point); then each lane adds its digit's entry of
//     each row into its sum. The chain sums go to a global scratch (C x
//     lanes x 160 bytes: 1.9 MB for A2 at C = 128, in L2).
//   - msm_tree_kernel, one CTA per lane: that lane's C chain sums in shared
//     memory, the tree's rounds a quad per addition with a barrier between
//     them, then the lane's canonical limbs. (A tree across the chains'
//     CTAs on atomic tickets, tried first, paid a global write, a fence, an
//     atomic and a read every round: ~30 us for the 7 rounds at C = 128,
//     against ~15 for this launch; PERF.md, PR 7.)
// A quad (4 threads of a warp) does one point addition: thread l holds
// coordinate l of the point (X, Y, Z, T) and field l of a cached point
// (Y-X, Y+X, Z, 2dT), and the add's two rounds of four independent
// products (a, b, d, c, then X3, Y3, Z3, T3) are one product per thread,
// the operands exchanged with __shfl_xor_sync (ed25519_quad.cuh, shared
// with A1 and A4). A cached add is 2 products deep instead of 8; a table step (add, then cache: 2dT) 2 to 3 instead of
// 9, as the cache of one entry overlaps the next add's first product; a
// tree round (the complete add) 3.
//
// What bounds it on the H100: integer multiplies (ed25519.msm_field_ops counts
// them, at 100 32-bit multiply-adds a product and 55 a squaring), far from
// the card's rate because the work is a few long dependent chains per CTA:
// A2's decompression (255 squarings + 20 products, one thread per point:
// over half of A2's time), a table (29-43 products deep), a chain (2 per
// row) and the tree (3 a round). Its bytes (~180 a row in, 33 KB out)
// never bound it. Splitting a squaring's ten columns over threads, for the
// decompression, is the next lever (msm_breakdown.py --phases times each
// phase).
//
// Bounds: the quad operations keep the rule of ed25519_field.cuh (a sum of at
// most 3 tight values; the argument is ed25519_quad.cuh's). The staged points
// are tight: decompress outputs and their negations (A2), or fe_from13_loose
// outputs (A6). fe_to13 canonicalises before it repacks, so the output limbs
// are exact.

#include "ed25519_quad.cuh"

namespace ed25519_msm {

using namespace ed25519_field;
using namespace ed25519_quad;

constexpr int kWa = 64;        // window lanes of the A scalars (256-bit z k)
constexpr int kWr = 32;        // window lanes of the R scalars (128-bit z)
constexpr int kMaxChains = 128;
constexpr int kEntries = 15;   // cached multiples P .. 15P a point keeps (0P is implicit)
constexpr int kSmemLimit = 232448;  // shared bytes a CTA may use on the H100

// Dynamic shared bytes of a CTA whose tiles hold `tile` rows of each lane set
// (widths wa and wr; wr = 0 for one set). Per row and set: the table
// (kEntries x 4 fields x 10 limbs), the staged point (4 x 10 limbs) and a
// flags word; per row the digits of every lane (wa + wr bytes).
HD int msm_smem_bytes(int tile, int wa, int wr) {
  const int sets = wr > 0 ? 2 : 1;
  return tile * (sets * ((kEntries * 4 + 4) * 10 * 4 + 4) + wa + wr);
}

constexpr int kMaxShards = 16;  // lane sets a reduce takes in its launch parameters

// A6' for window lane w of one lane set (width W) in quad thread l: m <- its
// coordinate l of parts[0]'s lane plus parts[1] .. parts[n - 1]'s, in that
// order, with the complete addition (pt_add's values mod p). Each part is
// a [4, 20, W] set of radix-2^13 limbs. A thread loads coordinate l of each
// addend (its xor-1 partner's comes by shuffle), a step ahead: the next
// addend's limbs are in flight during this addition. Every thread of the
// warp calls it with the same n.
template <class X>
HD void quad_shard_sum(fe& m, const i32* const* parts, int n, int W, int w, int l,
                       const Consts& k, const X& x) {
  const size_t at = (size_t)l * 20 * W + w;
  fe_from13_loose(m, parts[0] + at, W);
  i32 raw[20];
  for (int i = 0; i < 20 && n > 1; i++) raw[i] = parts[1][at + (size_t)i * W];
  for (int s = 1; s < n; s++) {
    fe qm, qo;
    fe_from13_loose(qm, raw, 1);
    if (s + 1 < n) {
#pragma unroll
      for (int i = 0; i < 20; i++) raw[i] = parts[s + 1][at + (size_t)i * W];
    }
    fe_shfl_xor(qo, qm, 1, x);
    quad_add(m, qm, qo, l, k, x);
  }
}

}  // namespace ed25519_msm

#ifdef __CUDACC__
using namespace ed25519_msm;

constexpr unsigned kFull = 0xffffffffu;

// Built with -DMSM_PHASE_TIMES (msm_breakdown.py --phases), thread 0 of each
// chain CTA records %globaltimer at the start, after the staged points,
// after the tables and after every warp's chains of its last tile, and the
// library exports them. A build without it has no trace of this.
#ifdef MSM_PHASE_TIMES
__device__ unsigned long long g_phase[kMaxChains][4];
#define MSM_PHASE(i)                                              \
  if (threadIdx.x == 0) {                                         \
    unsigned long long t_;                                        \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));        \
    g_phase[blockIdx.x][i] = t_;                                  \
  }
extern "C" int ed25519_msm_phase_times(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
#define MSM_PHASE_ALL(i) \
  __syncthreads();       \
  MSM_PHASE(i)
#else
#define MSM_PHASE(i)
#define MSM_PHASE_ALL(i)
#endif

// Every chain of one call: blockIdx.x = c, 4 (WA + WR) threads. Lane set 0
// (WA lanes) is A2's A set or A6's set, lane set 1 (WR lanes) A2's R set.
// kDecompress: rows are y limbs and signs (A2), else points (A6). Writes
// chain c's lane sums to partial [C][WA + WR][4][10] for msm_tree_kernel.
template <int WA, int WR, bool kDecompress>
__global__ void __launch_bounds__(4 * (WA + WR), 1)
msm_chains_kernel(const int16_t* __restrict__ a_y, const int8_t* __restrict__ a_sign,
                  const int16_t* __restrict__ r_y, const int8_t* __restrict__ r_sign,
                  const int32_t* __restrict__ pts, const int8_t* __restrict__ digits_a,
                  const int8_t* __restrict__ digits_r, const int32_t* __restrict__ consts13,
                  int32_t* __restrict__ partial, bool* __restrict__ valid, int B, int C,
                  int tile) {
  constexpr int kSets = WR > 0 ? 2 : 1;
  constexpr int kLanes = WA + WR;
  constexpr int kThreads = 4 * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Consts s_k;
  fe* tab = reinterpret_cast<fe*>(smem);             // [kSets][tile][kEntries][4]
  fe* stage = tab + (size_t)kSets * tile * kEntries * 4;  // [kSets][tile][4]
  int* flags = reinterpret_cast<int*>(stage + (size_t)kSets * tile * 4);  // [kSets][tile]
  int8_t* dig = reinterpret_cast<int8_t*>(flags + kSets * tile);  // [tile][kLanes]

  const int tid = threadIdx.x, l = tid & 3, lane = tid >> 2;
  const int c = blockIdx.x, S = B / C;
  const QuadShfl x{};
  const int set = lane < WA ? 0 : 1;
  const fe* my_tab = tab + (size_t)set * tile * kEntries * 4;
  for (int i = tid; i < 3; i += kThreads) load_consts(i, consts13, s_k);
  fe acc;  // this thread's coordinate of its lane's chain sum
  quad_identity(acc, l);
  MSM_PHASE(0)

  for (int s0 = 0; s0 < S; s0 += tile) {
    const int rows = S - s0 < tile ? S - s0 : tile;  // the last tile may be short
    __syncthreads();  // the constants are loaded; the last tile's tables are read
    for (int i = tid; i < rows * kLanes; i += kThreads) {
      const int p = i / kLanes, w = i % kLanes;
      const size_t j = (size_t)c + (size_t)(s0 + p) * C;
      dig[i] = w < WA ? digits_a[j * WA + w] : digits_r[j * WR + (w - WA)];
    }
    __syncthreads();
    const Consts& k = s_k;
    // The points, negated (-X, Y, Z, -T), and the flags: bit 0 a nonzero
    // digit in the row's lane set, bit 1 (A2) the point decompressed.
    if constexpr (kDecompress) {
      for (int i = tid; i < kSets * rows; i += kThreads) {
        const int s = i / rows, p = i % rows;
        const size_t j = (size_t)c + (size_t)(s0 + p) * C;
        fe y;
        fe_from13(y, (s == 0 ? a_y : r_y) + j * 20);
        ge P;
        const bool ok = decompress(P, y, (i32)(s == 0 ? a_sign : r_sign)[j], k);
        fe* st = stage + ((size_t)s * tile + p) * 4;
        fe_neg(st[0], P.X);
        st[1] = P.Y;
        st[2] = P.Z;
        fe_neg(st[3], P.T);
        int live = 0;
        const int w0 = s == 0 ? 0 : WA, w1 = s == 0 ? WA : kLanes;
        for (int w = w0; w < w1; w++) live |= dig[p * kLanes + w] & 15;
        flags[s * tile + p] = (live != 0 ? 1 : 0) | (ok ? 2 : 0);
      }
    } else {
      for (int i = tid; i < rows * 4; i += kThreads) {
        const int p = i >> 2, coord = i & 3;
        const size_t j = (size_t)c + (size_t)(s0 + p) * C;
        fe x;
        fe_from13_loose(x, pts + (size_t)coord * 20 * B + j, B);
        if (coord == 0 || coord == 3) fe_neg(x, x);
        stage[i] = x;
      }
      for (int p = tid; p < rows; p += kThreads) {
        int live = 0;
        for (int w = 0; w < WA; w++) live |= dig[p * kLanes + w] & 15;
        flags[p] = live != 0 ? 1 : 0;
      }
    }
    __syncthreads();
    MSM_PHASE(1)
    if constexpr (kDecompress) {
      for (int p = tid; p < rows; p += kThreads)
        valid[(size_t)c + (size_t)(s0 + p) * C] = (flags[p] & flags[tile + p] & 2) != 0;
    }
    // Tables: a quad per (set, row) with a nonzero digit; a warp whose rows
    // are all zero builds nothing. Quads past the last job run job 0's
    // arithmetic (their warp's shuffles need them) and store nothing.
    for (int base = 0; base < kSets * rows; base += kLanes) {
      const int job = base + lane;
      const bool active = job < kSets * rows;
      const int jj = active ? (job / rows) * tile + job % rows : 0;  // [set][tile] index
      if (!__any_sync(kFull, active && (flags[jj] & 1))) continue;
      // Entry e + 1 = entry e + P: each step's cache of entry e and the
      // round-1 product of the next add depend only on entry e, so they are
      // formed together and overlap.
      fe cur = stage[(size_t)jj * 4 + l];
      fe o, q1, qe, s, p;
      fe_shfl_xor(o, cur, 1, x);
      quad_cache(q1, cur, o, l, k);
      fe* t = tab + (size_t)jj * kEntries * 4;
      if (active) t[l] = q1;
      quad_round1(s, cur, o, l);
      fe_mul(p, s, q1);
      for (int e = 1; e < kEntries; e++) {
        quad_finish(cur, p, l, x);
        fe_shfl_xor(o, cur, 1, x);
        quad_cache(qe, cur, o, l, k);
        quad_round1(s, cur, o, l);
        fe_mul(p, s, q1);  // the next add's; unused after entry 15
        if (active) t[e * 4 + l] = qe;
      }
    }
    __syncthreads();
    MSM_PHASE(2)
    // Chains: each lane adds its digit's entry of each row, in row order.
    for (int p = 0; p < rows; p++) {
      const int d = dig[p * kLanes + lane] & 15;
      if (!__any_sync(kFull, d != 0)) continue;
      fe q;
      if (d != 0) q = my_tab[((size_t)p * kEntries + d - 1) * 4 + l];
      else quad_cached_identity(q, l);
      quad_add_cached(acc, q, l, x);
    }
  }

  MSM_PHASE_ALL(3)
  int32_t* slot = partial + (((size_t)c * kLanes + lane) * 4 + l) * 10;
#pragma unroll
  for (int i = 0; i < 10; i++) slot[i] = acc.v[i];
}

// The tree over the C chain sums of one lane (blockIdx.x, of WA + WR), in
// shared memory: round r adds chain t + off into chain t for t < off = C >>
// (r + 1), a quad per addition (pt_add), then the lane's canonical limbs.
template <int WA, int WR>
__global__ void __launch_bounds__(2 * kMaxChains)
msm_tree_kernel(const int32_t* __restrict__ partial, const int32_t* __restrict__ consts13,
                int32_t* __restrict__ v_a, int32_t* __restrict__ v_r, int C) {
  constexpr int kLanes = WA + WR;
  __shared__ Consts s_k;
  __shared__ fe s[kMaxChains][4];
  const int w = blockIdx.x, tid = threadIdx.x, l = tid & 3, quad = tid >> 2;
  const QuadShfl x{};
  for (int i = tid; i < 3; i += blockDim.x) load_consts(i, consts13, s_k);
  for (int i = tid; i < C * 4; i += blockDim.x) {
    const int32_t* src = partial + (((size_t)(i >> 2) * kLanes + w) * 4 + (i & 3)) * 10;
#pragma unroll
    for (int j = 0; j < 10; j++) s[i >> 2][i & 3].v[j] = src[j];
  }
  __syncthreads();
  const Consts& k = s_k;
  for (int off = C >> 1; off >= 1; off >>= 1) {
    // A warp takes part while its first quad has a node; quads past the
    // round's nodes add chains no round writes (their shuffles need them)
    // and store nothing.
    if ((quad & ~7) < off) {
      fe m = s[quad][l];
      quad_add(m, s[quad + off][l], s[quad + off][l ^ 1], l, k, x);  // pt_add(s[t], s[t + off])
      if (quad < off) s[quad][l] = m;
    }
    __syncthreads();
  }
  if (quad == 0) {
    if (w < WA) fe_to13(s[0][l], v_a + (size_t)l * 20 * WA + w, WA);
    else fe_to13(s[0][l], v_r + (size_t)l * 20 * WR + (w - WA), WR);
  }
}

// The shard sets of one reduce: a[s] and r[s] the A and R sets of shard s.
struct ShardSets {
  const i32* a[kMaxShards];
  const i32* r[kMaxShards];
};

// A6' over both lane sets, CTA 0 the A set (kWa lanes) and CTA 1 the R set
// (kWr lanes): two CTAs of 4 kWa threads rather than one of 4 (kWa + kWr),
// so a thread keeps up to 255 registers. Quad q sums lane q; the warps of
// CTA 1 past its kWr lanes leave (8 quads a warp, both widths multiples
// of 8).
__global__ void __launch_bounds__(4 * kWa)
msm_shard_reduce_kernel(const ShardSets sets, const int32_t* __restrict__ consts13,
                        int32_t* __restrict__ v_a, int32_t* __restrict__ v_r, int n) {
  __shared__ Consts s_k;
  for (int i = threadIdx.x; i < 3; i += blockDim.x) load_consts(i, consts13, s_k);
  __syncthreads();
  const bool is_a = blockIdx.x == 0;
  const int W = is_a ? kWa : kWr, l = threadIdx.x & 3, q = threadIdx.x >> 2;
  if (q >= W) return;  // warp-uniform
  fe m;
  quad_shard_sum(m, is_a ? sets.a : sets.r, n, W, q, l, s_k, QuadShfl{});
  fe_to13(m, (is_a ? v_a : v_r) + (size_t)l * 20 * W + q, W);
}

// The launch plan the wrapper computed (ed25519.msm_plan): chains a power of
// two dividing B, at most 128; a tile of 1 .. B / chains rows; the dynamic
// shared bytes that tile needs, within the card's limit.
static bool plan_ok(int B, int chains, int tile, int smem, int wa, int wr) {
  if (chains < 1 || chains > kMaxChains || (chains & (chains - 1)) || B % chains) return false;
  if (tile < 1 || tile > B / chains) return false;
  return smem == msm_smem_bytes(tile, wa, wr) && smem <= kSmemLimit;
}

// The chains, then the tree, on one stream.
template <int WA, int WR, bool kDecompress>
static int launch_lanes(const int16_t* a_y, const int8_t* a_sign, const int16_t* r_y,
                        const int8_t* r_sign, const int32_t* pts, const int8_t* digits_a,
                        const int8_t* digits_r, const int32_t* consts13, int32_t* partial,
                        int32_t* v_a, int32_t* v_r, bool* valid, int B, int chains, int tile,
                        int smem, cudaStream_t s) {
  if (!plan_ok(B, chains, tile, smem, WA, WR)) return (int)cudaErrorInvalidValue;
  auto kernel = msm_chains_kernel<WA, WR, kDecompress>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<chains, 4 * (WA + WR), smem, s>>>(a_y, a_sign, r_y, r_sign, pts, digits_a, digits_r,
                                              consts13, partial, valid, B, chains, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_tree_kernel<WA, WR><<<WA + WR, 2 * kMaxChains, 0, s>>>(partial, consts13, v_a, v_r,
                                                             chains);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_msm_accumulate(const void* a_y, const void* a_sign, const void* r_y,
                                      const void* r_sign, const void* ak_digits,
                                      const void* z_digits, const void* consts13,
                                      void* partial, void* v_a, void* v_r, void* valid, int B,
                                      int chains, int tile, int smem, void* stream) {
  return launch_lanes<kWa, kWr, true>(
      (const int16_t*)a_y, (const int8_t*)a_sign, (const int16_t*)r_y, (const int8_t*)r_sign,
      nullptr, (const int8_t*)ak_digits, (const int8_t*)z_digits, (const int32_t*)consts13,
      (int32_t*)partial, (int32_t*)v_a, (int32_t*)v_r, (bool*)valid, B, chains, tile, smem,
      (cudaStream_t)stream);
}

extern "C" int ed25519_msm_window(const void* pts, const void* digits, const void* consts13,
                                  void* partial, void* v, int B, int W, int chains, int tile,
                                  int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* d = (const int8_t*)digits;
  if (W == kWa)
    return launch_lanes<kWa, 0, false>(nullptr, nullptr, nullptr, nullptr, (const int32_t*)pts,
                                       d, nullptr, (const int32_t*)consts13, (int32_t*)partial,
                                       (int32_t*)v, nullptr, nullptr, B, chains, tile, smem, s);
  if (W == kWr)
    return launch_lanes<kWr, 0, false>(nullptr, nullptr, nullptr, nullptr, (const int32_t*)pts,
                                       d, nullptr, (const int32_t*)consts13, (int32_t*)partial,
                                       (int32_t*)v, nullptr, nullptr, B, chains, tile, smem, s);
  return (int)cudaErrorInvalidValue;
}

// table: host memory, the n A sets' device addresses ([4, 20, kWa] each)
// then the n R sets' ([4, 20, kWr]).
extern "C" int ed25519_msm_shard_reduce(const void* table, const void* consts13, void* v_a,
                                        void* v_r, int n, void* stream) {
  if (n < 1 || n > kMaxShards) return (int)cudaErrorInvalidValue;
  ShardSets sets = {};
  const uint64_t* t = (const uint64_t*)table;
  for (int s = 0; s < n; s++) {
    sets.a[s] = (const i32*)t[s];
    sets.r[s] = (const i32*)t[n + s];
  }
  msm_shard_reduce_kernel<<<2, 4 * kWa, 0, (cudaStream_t)stream>>>(
      sets, (const int32_t*)consts13, (int32_t*)v_a, (int32_t*)v_r, n);
  return (int)cudaGetLastError();
}

extern "C" const char* ed25519_msm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif
