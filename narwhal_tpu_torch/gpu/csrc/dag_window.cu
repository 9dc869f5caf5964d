// The device DAG window, the commit walk and the batched causal reads, for
// Hopper (sm_90a).
//
// Tensors (the JAX package's layout, narwhal_tpu/tpu/dag_kernels.py):
//   parent  [W, N, N] uint8   parent[w, a, p] = cert (w, a) links (w-1, p)
//   present [W, N]    uint8   a certificate exists at (round offset w, authority)
// Six kernels, each with a plain PyTorch version in ../dag_kernels.py:
//
// window_sync  replaces narwhal_tpu/tpu/dag_kernels.py:79 `roll_window` (B4)
//   and :95 `place_batch` (B3), which the JAX DagWindow.device_view runs
//   one after the other (:329-378): out[w] = in[w + shift] for
//   w < W - shift, else 0, for parent and present; then for each slot t of
//   the launch's parameter block,
//   present[off_t, idx_t] = 1 and parent[off_t, idx_t, :] = row_t. Duplicate
//   (off, idx) slots carry identical rows (device_view reads them from its
//   mirror at sync time), so their order does not matter. The entry point
//   packs the slots inside the window on the host (the rest are dropped)
//   into the launch's parameters, a by-value __grid_constant__ struct of
//   under 4 KB (dag_window_sync.cuh: a slot is its offset, index and row as
//   one bit string, 62 bits at W = 64, N = 50, so 515 slots a block): no
//   upload, no staging tensor. A batch past a block takes more launches,
//   the first rolling and placing, the rest placing in place.
//   A CTA per chunk of a round row w (by default a quarter of the parent
//   row, 640 bytes to 16 KB: four CTAs a row at N = 50, one up to N = 25):
//   when the outputs are not the inputs (a roll, out of place), the CTA
//   copies its chunk of parent row w + shift (and, chunk 0, present row
//   w + shift) into row w, or zeroes it when w + shift >= W, in 16-byte
//   words where the row stride and the tensors' alignment allow, else
//   4-byte words, else bytes: the row index is the CTA's, so no division a
//   byte. Then one barrier, and its threads write the block's slots at
//   offset w, a slot a thread (so the CTA's reads of the block's cells are
//   in flight together), the slot's bytes in its chunk. So
//   every output byte is written by the CTA that owns it, a slot after the
//   rolled copy of its row. In place (shift 0) nothing is copied.
//   Bound: bytes, (W - shift) rows read and W rows written (N * N + N
//   bytes each) when it rolls, and the slot bits read: ~0.1 us of HBM time
//   at W = 64, N = 50, shift 1; in place only the slot bits and the cells
//   they write (~7 KB at T = 64). The launch is the cost.
//
// chain_commit replaces narwhal_tpu/tpu/dag_kernels.py:128 `chain_commit` (B2),
//   with `reach_mask` (:48, B1) inside it, as a walk over packed bits
//   (dag_walk_bits.cuh). Semantics kept exactly:
//     - the start row is seeded by the leader's one-hot, rows above it are
//       empty, a zero one-hot slot reaches nothing (a no-op);
//     - uncommitted = present & (row > lc[p]) is re-derived per leader from
//       the lc that the earlier leaders of this chain advanced;
//     - keep = reach & (row + gc_depth >= lcr) with the lcr from BEFORE this
//       leader's update;
//     - committed_round[p] = max row with keep, else the sentinel -(2^30);
//       lc[p] = max(lc[p], committed_round[p]), lcr = max(lcr, max_p ...);
//     - every byte of the [K, W, N] masks is written.
//   N <= 64 and the window's tables fit in shared memory (W = 64, N = 50:
//   47 KB; W = 256 at N = 50 on the H100's 227 KB): one CTA of 512
//   threads packs parent rows 1..top and present rows 0..top (top = the
//   highest start row of a live leader; rows above it are never read) into
//   bit strings with 16-byte loads, one bit a byte, and its warps transpose
//   the parent rows into a column table (32 x 32 bit blocks, five shuffle
//   rounds each): the parents of column p of row w as two words over the
//   row's certificates. Then warp 0 walks the leaders in order with no CTA
//   barrier and no cross-lane reduction: lane l decides columns l and
//   l + 32 of a row by ANDing their column words with the row above's
//   reach set (two words in every lane), a ballot makes the row's set,
//   ANDed with its uncommitted words (present bits and a ballot of
//   w > lc[p]); the gc test is one compare a row, committed rounds are each
//   column's first kept row from the top. The other warps expand the
//   previous leader's kept words into mask bytes (one barrier a leader).
//   Other shapes (N <= 1024, any W) run chain_commit_wide_kernel
//   (walk_bits::wide_walk): a thread per column and one barrier a row, the
//   row above's frontier as packed words in shared memory, and column p
//   reached when one of the frontier's set bits is its parent, the parent
//   bytes of eight set bits loaded together (coalesced over the warp's
//   columns) until one is found.
//   Bound: bytes. Rows above the newest leader are empty by definition, so
//   the least traffic is parent rows 1..max(offs) and present rows
//   0..max(offs) read once, lc, offs and the one-hots read, and the K masks
//   written: ~150 KB with the leader at row 58 of W = 64, N = 50, K = 1,
//   well under a microsecond of HBM time. What is left is the latency of
//   the packing loads, the walk's dependent row steps (a few warp
//   reductions each) and the launch.
//
// reach_many   replaces narwhal_tpu/consensus/dag.py:262 `_reach_k` (B6), the
//   jitted vmap of reach_mask over K read starts that serves the Dag
//   service's coalesced read_causal: masks[k] = reach_mask(parent,
//   uncommitted, offs[k], onehots[k]) for k < K. `uncommitted` is what the
//   caller passes (the service passes `present`, the consensus step its
//   own mask): no lc or gc filter between walks. A zero one-hot, or an
//   offset outside [0, W), reaches nothing; every byte of the [K, W, N]
//   masks is written. W is an argument, so the window may grow (64, 128,
//   256, ...) without a rebuild.
//   Bound: bytes, as for chain_commit: parent rows 1..top and uncommitted
//   rows 0..top read once (top the highest live start), offs and the
//   one-hots read, and the K masks written (K * W * N bytes): ~0.1 us of
//   HBM time at W = 64, N = 50, K = 64. What is left is B2's latency: the
//   packing loads and a dependent row step (an AND and a vote) a row.
//   The K reads share one window, so on the packed route (N <= 64 and the
//   tables fit in shared memory: W = 256 at N = 50) reach_many_kernel runs
//   a CTA of 16 warps per group of 16 reads: it packs parent rows 1..top
//   and uncommitted rows 0..top of its group (`top` over its live reads
//   only; a group of padding reads packs nothing) and builds B2's column
//   table once, then each warp walks its read with B2's row step
//   (walk_leader<false>: ballots, no barrier, no lc ballot and no gc test,
//   stopping at the first empty row) into its own keep rows and expands
//   them into mask bytes. A read a warp was the fastest group on the H100
//   (PERF.md: 16 against 32 and 64 reads a CTA at K = 64). Other shapes (N > 64, or a
//   window past shared memory) run reach_many_wide_kernel: a CTA per read,
//   B2's wide walk (`wide_walk`, a thread a column, one barrier a row, the
//   parents of a batch of frontier bits loaded together) with K = 1, every
//   lc the sentinel, gc_depth 0 and lcr the sentinel, which is reach_mask.
//
// leader_support replaces narwhal_tpu/tpu/dag_kernels.py:119 `leader_support`
//   (B5), batched over B walks as __graft_entry__.py:235 vmaps it: out[b] =
//   sum of stakes[a] over the a with parent[offs[b], a, leaders[b]] and
//   present[offs[b], a] set, in wrapping int32 arithmetic like jnp.sum. The
//   link axis has M columns (M = N unsharded; a shard's column block under
//   the committee-axis mesh), so `leaders` index that block. A warp a walk,
//   16 walks a CTA (B = 64: one wave of 4 CTAs); each lane issues the
//   walk's offset and leader and its first stakes at once, then its
//   voters' link and present bytes in one second round, and
//   __reduce_add_sync sums the lanes (dag_support.cuh). The range check is
//   the kernel's: a walk whose offset lies outside [0, W) or whose leader
//   lies outside [0, M) reads nothing, writes 0, and each CTA writes its
//   lowest such walk {walk, offset, leader} to its error word (a shared
//   atomicMin on the walk, so the choice is the same in any order); the
//   wrapper reads the words with the result and raises. No host read
//   before the launch.
//   Bound: bytes, the B parent columns, present rows and stakes it reads
//   (under 20 KB at B = 64, N = 50): the launch is the cost.
//
// consensus_commit replaces the tail of __graft_entry__.py:229
//   `consensus_step` (B7): quorum = sum(stakes) // 3 + 1 (wrapping int32,
//   floor division), committed[b, w, p] = masks[b, w, p] & (support[b] >=
//   quorum), new_last[p] = max(last[p], max over (b, w) of committed * w).
//   Bound: bytes, the B x W x M masks read and committed written once (410
//   KB at B = 64, W = 64, N = 50: 0.12 us of HBM time); the launch is the
//   cost. One launch of one thread-block cluster of up to 8 CTAs (a CTA
//   for each 4 KB of the slab, commit_mask::ctas_for) of 256 threads:
//   each thread first issues its stake reads, its first four words and
//   its first byte outside them, with their walks' support, and (CTA 0)
//   its entry of `last`, so one global read's latency precedes the
//   stream; every CTA sums the S stakes (a warp reduction, a shared word a
//   warp); all the launch's threads stream the flat [B, W, M] slab in a
//   grid-stride loop of 16-byte words, four in flight a thread
//   (dag_commit.cuh: a word masked whole by its walk's quorum test,
//   bytewise across a walk boundary, outside the aligned words, and
//   everywhere when the launch has a thread a byte), each committed byte
//   raising its column's best row in its CTA's shared table (a shared
//   atomicMax when the row is higher than the table's); after a cluster
//   barrier CTA 0 reads the tables through distributed shared memory and
//   writes new_last (a launch of one CTA: its own table after a CTA
//   barrier, no cluster barrier). No scratch tensor, no global atomic, and
//   the same result in any order. A thread a column would leave one CTA of
//   50 live threads at N = 50, each moving 4,096 single bytes.
//
// sharded_walk replaces narwhal_tpu/tpu/dag_kernels.py:497-519, the sharded
//   `chain_commit` (one XLA program under shard_map, P(None, None, "auth"),
//   whose per-row frontier all-gather XLA places on the interconnect): a
//   whole walk set, every row and every leader, in ONE launch per card.
//   Layout: one CTA per shard of the auth row held on this card, one thread
//   per column of the shard's block (m <= 1024); the card's CTAs form one
//   thread-block cluster (cluster size = local shards, <= 16). A shard's
//   operands are its column blocks: parent [W, Npad, m], present [W, m],
//   lc [m]; offs [K] and the one-hots [K, Npad] are whole (a slot is live
//   when any byte of its one-hot is set, which every CTA of every card sees
//   alike). Each CTA keeps the FULL frontier of the row above, [Npad]
//   bytes, in shared memory, double-buffered by row parity.
//   One row w: thread p runs `reach_step` (unchanged, so the bits equal
//   B2's) against buf[(w+1)&1], applies the uncommitted and gc filters
//   (uncommitted = present & (w > lc[p]), keep = reached & (w + gc_depth >=
//   lcr)), writes its mask byte, stores its bit into
//   buf[w&1][s*m + p] of EVERY CTA of the cluster (distributed shared
//   memory, map_shared_rank), then one cluster.sync():
//
//     CTA r:  | read buf[(w+1)&1], write buf[w&1] everywhere | SYNC(w) | read buf[w&1], write buf[(w-1)&1] everywhere | SYNC(w-1) | ...
//
//   A CTA writes buf[w&1] of a peer CTA only after SYNC(w+1), i.e. after
//   that peer finished reading buf[w&1] as row w+2's "row above": one
//   barrier per row is enough. Row 0 has no row below: no store, no sync.
//   Chain mode (chain_commit_sharded): the K leaders run in order inside
//   the launch as in chain_commit_kernel; an all-zero slot is skipped on
//   the device (its masks written zero, lc and lcr untouched); after each
//   live leader every CTA folds its committed rounds into its lc block and
//   the lcr candidates (a block atomicMax, then each CTA reads every CTA's
//   candidate through distributed shared memory after one cluster.sync,
//   double-buffered by live-leader parity) give the next leader's lcr. No
//   host round trip anywhere in the walk.
//   Many mode (reach_many_sharded, consensus_step_sharded): one cluster per
//   walk, K clusters in the grid, `present` is the caller's uncommitted, no
//   lc and no gc filter (as reach_many).
//   Across cards ("peer" and "host" routes, G > 1 launches, one per card,
//   or one per shard on a card repeated, each on its own stream): after a
//   row's SYNC A, rank 0 writes this card's frontier columns into the
//   exchange buffer of every peer card, fences system-wide and bumps its
//   generation flag on every peer with st.release.sys; it then spins
//   (ld.acquire.sys) on its own buffer's flags of every peer, bounded by a
//   %globaltimer deadline, and copies the peers' columns into every local
//   CTA's buf[w&1] before SYNC B. On "peer" the buffers are device memory
//   mapped between cards with peer access; on "host" (cards without it)
//   they are pinned host memory every card maps (portable, mapped: one
//   address under unified addressing), so every flag and byte crosses
//   PCIe. The peers' bytes and lcr candidates are read with
//   ld.relaxed.sys after the acquire and a CTA barrier: the writer's
//   stores are ordered before its release by its system fence, and the
//   strong loads take nothing from a cache that another card's stores to
//   host memory do not reach. The lcr reduction between leaders crosses cards the same way. The
//   buffer's layout is fixed by the number of walk slots it was allocated
//   for (`nslots`, not a launch's walk count): a buffer reused by a later
//   launch with fewer walks, or in the other mode, keeps every flag, lcr
//   and frontier byte where it was, so no stale value lands on a flag. Each
//   exchange event e of a walk uses buffer slot e&1 and target generation
//   gen_base + e + 1 (the host advances gen_base past every launch): a card
//   writes slot e&1 again at event e+2 only after it has seen the peer's
//   flag of event e+1, which the peer raises after reading event e. A
//   missed deadline writes {1, event} to the card's error word and every
//   CTA of the cluster leaves at the same barrier; the wrapper reads the
//   words back with the result and raises. Clusters that spin must be
//   co-resident: the wrapper checks cudaOccupancyMaxActiveClusters and
//   splits a walk set into waves that fit (the host synchronises between
//   waves).
//   Bound: bytes. With top = the highest start row of a live walk (rows
//   above it are empty by definition), the launch must read each shard's
//   parent rows 1..top and present rows 0..top of its block (top * Npad^2
//   and (top + 1) * Npad bytes over the row), lc (4 Npad), offs (4 K) and
//   the one-hots (K Npad), and write the masks (K W Npad): ~150 KB for one
//   leader at row 58 of W = 64, Npad = 50, under 0.05 us of HBM time. The
//   latency floor is `top` dependent row steps (each a parent load that
//   waits on the row above, and a cluster barrier); that floor, not the
//   bytes, is what the kernel is made of.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <cuda_runtime.h>

#include "dag_commit.cuh"
#include "dag_support.cuh"
#include "dag_walk_bits.cuh"
#include "dag_window_sync.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kSyncThreads = 256;

// Grid (W, chunks of `chunk` bytes of a parent row): CTA (w, y) writes
// chunk y of row w of out_parent and, y == 0, row w of out_present.
// out_parent == parent (in place, shift 0) copies nothing.
__global__ void __launch_bounds__(kSyncThreads)
window_sync_kernel(const uint8_t* parent, const uint8_t* present, uint8_t* out_parent,
                   uint8_t* out_present, int W, int N, int shift, int chunk,
                   const __grid_constant__ window_sync::Slots s) {
  if (out_parent != parent) {
    window_sync::cta_copy(threadIdx.x, blockDim.x, blockIdx.x, blockIdx.y, chunk, parent,
                          present, out_parent, out_present, W, N, shift);
    __syncthreads();
  }
  window_sync::cta_place(threadIdx.x, blockDim.x, blockIdx.x, blockIdx.y, chunk, s, out_parent,
                         out_present, W, N);
}

// One row step of the reach walk (reach_mask's scan body) for column p:
// whether certificate (w, p) is reached, given the row above's reach set.
// parent is [W, N, M]: N certificates a row link M columns (M = N, or a
// shard's column block).
__device__ __forceinline__ bool reach_step(const uint8_t* __restrict__ parent,
                                           const uint8_t* frontier, int w, int W, int N,
                                           int M, int p, int start_off, bool start_bit) {
  if (w > start_off) return false;
  if (w == start_off) return start_bit;
  if (w + 1 >= W) return false;  // nothing above the top row
  const uint8_t* links = parent + (size_t)(w + 1) * N * M;
  bool reached = false;
  for (int a = 0; a < N; a++) {
    if (frontier[a] && links[(size_t)a * M + p]) {
      reached = true;
      break;
    }
  }
  return reached;
}

// The packed walks' dynamic shared memory, in 32-bit words: the parent
// string of rows 1..W-1 from byte par_lo and the present string of rows
// 0..W-1 (two slack words each), the column table [W][N][2], the present
// rows [W][2], then `tail` words of the kernel's own (chain_commit_kernel:
// lc [64] and the keep rows [2][W][2]; reach_many_kernel: the keep rows
// [W][2] of each warp).
struct WalkLayout {
  long long par_lo, par_words, pre_words, ct_words, total;
  __host__ __device__ WalkLayout(int W, int N, long long tail) {
    par_lo = ((long long)N * N) & ~31LL;
    par_words = ((long long)W * N * N - par_lo + 31) / 32 + 2;
    pre_words = ((long long)W * N + 31) / 32 + 2;
    ct_words = 2LL * W * N;
    total = par_words + pre_words + ct_words + 2LL * W + tail;
  }
};

constexpr int kWalkThreads = 512;  // up to 128 registers a thread for the walking warp
constexpr int kWalkWarps = kWalkThreads / 32;

__host__ __device__ inline long long chain_tail(int W) { return 64 + 4LL * W; }
__host__ __device__ inline long long reach_tail(int W) { return 2LL * kWalkWarps * W; }

// Words [0, n) of the bit string of src bytes [lo, hi), then two zero
// words, by every thread of the CTA. Where src + lo is 16-byte aligned (the
// walk's strings start at multiples of 32 bytes of a tensor torch aligns),
// a thread issues the 16-byte loads of four words before it packs them.
__device__ void pack_range(uint32_t* dst, const uint8_t* __restrict__ src, long long lo,
                           long long hi) {
  const long long n = hi > lo ? (hi - lo + 31) / 32 : 0;
  const long long full = hi > lo ? (hi - lo) / 32 : 0;  // words of 32 bytes below hi
  const int nt = blockDim.x;
  long long i0 = threadIdx.x;
  if ((((uintptr_t)(src + lo)) & 15) == 0) {
    const uint4* v = (const uint4*)(src + lo);
    constexpr int U = 4;
    for (; i0 + (long long)(U - 1) * nt < full; i0 += (long long)U * nt) {
      uint4 x[U][2];
#pragma unroll
      for (int u = 0; u < U; u++) {
        x[u][0] = __ldg(v + 2 * (i0 + u * nt));
        x[u][1] = __ldg(v + 2 * (i0 + u * nt) + 1);
      }
#pragma unroll
      for (int u = 0; u < U; u++) {
        const uint32_t q[8] = {x[u][0].x, x[u][0].y, x[u][0].z, x[u][0].w,
                               x[u][1].x, x[u][1].y, x[u][1].z, x[u][1].w};
        uint32_t w = 0;
#pragma unroll
        for (int k = 0; k < 8; k++) w |= walk_bits::nz_nibble(q[k]) << (4 * k);
        dst[i0 + u * nt] = w;
      }
    }
  }
  for (long long i = i0; i < n + 2; i += nt) {
    dst[i] = i < n ? walk_bits::pack_word(src, lo, hi, i) : 0u;
  }
}

// B2 for N <= 64 with the window's strings in shared memory (see the head of
// this file): pack, transpose, then warp 0 walks the leaders while the
// other warps write the previous leader's masks.
__global__ void __launch_bounds__(kWalkThreads)
chain_commit_kernel(const uint8_t* __restrict__ parent, const uint8_t* __restrict__ present,
                    const int32_t* __restrict__ lc_rel, const int32_t* __restrict__ offs,
                    const uint8_t* __restrict__ onehots, bool* __restrict__ masks, int W, int N,
                    int K, int gc_depth, int lcr_rel) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_top;
  const WalkLayout lay(W, N, chain_tail(W));
  uint32_t* s_par = smem;
  uint32_t* s_pre = s_par + lay.par_words;
  uint32_t* s_ct = s_pre + lay.pre_words;
  uint32_t* s_prw = s_ct + lay.ct_words;  // [W][2]
  int* s_lc = (int*)(s_prw + 2 * W);
  uint32_t* s_keep = (uint32_t*)(s_lc + 64);  // [2][W][2], by leader parity
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const walk_bits::WarpLanes lanes{tid & 31};
  if (tid == 0) s_top = -1;
  for (int p = tid; p < 64; p += nt) s_lc[p] = p < N ? lc_rel[p] : 0;
  __syncthreads();
  for (int i = tid; i < K * N; i += nt) {  // the highest start row of a live leader
    if (onehots[i]) atomicMax(&s_top, min(offs[i / N], W - 1));
  }
  __syncthreads();
  const int top = s_top;  // rows above it are never read
  pack_range(s_par, parent, lay.par_lo, top >= 1 ? (long long)(top + 1) * N * N : lay.par_lo);
  pack_range(s_pre, present, 0, (long long)(top + 1) * N);
  __syncthreads();
  walk_bits::column_table(lanes, s_par, (int)lay.par_lo, s_pre, N, top, s_ct, s_prw, warp,
                          nt >> 5);
  __syncthreads();
  const walk_bits::Tables t{s_ct, s_prw, N};
  int lcr = lcr_rel;  // warp 0's
  for (int k = 0; k <= K; k++) {
    if (warp == 0 && k < K) {
      walk_bits::walk_leader<true>(lanes, t, onehots + (size_t)k * N, offs[k], W, gc_depth, s_lc,
                                   lcr, s_keep + (size_t)(k & 1) * 2 * W);
    } else if (k > 0) {  // leader k - 1's masks from its keep rows, every byte
      const uint32_t* kp = s_keep + (size_t)((k - 1) & 1) * 2 * W;
      bool* out = masks + (size_t)(k - 1) * W * N;
      const int t0 = k == K ? tid : tid - 32, tn = k == K ? nt : nt - 32;
      for (int i = t0; i < W * N; i += tn) {
        const int w = i / N, p = i - w * N;
        out[i] = (kp[2 * w + (p >> 5)] >> (p & 31)) & 1u;
      }
    }
    __syncthreads();
  }
}

// B2 for N > 64, or a window whose strings do not fit in shared memory:
// walk_bits::wide_walk on a CTA of 32 * ceil(N / 32) threads.
__global__ void __launch_bounds__(1024)
chain_commit_wide_kernel(const uint8_t* __restrict__ parent, const uint8_t* __restrict__ present,
                         const int32_t* __restrict__ lc_rel, const int32_t* __restrict__ offs,
                         const uint8_t* __restrict__ onehots, bool* __restrict__ masks, int W,
                         int N, int K, int gc_depth, int lcr_rel) {
  extern __shared__ uint32_t sm[];
  __shared__ int s_cand[2];
  walk_bits::wide_walk(walk_bits::CtaThreads{(int)threadIdx.x, (int)blockDim.x}, parent, present,
                       lc_rel, offs, onehots, masks, W, N, K, gc_depth, lcr_rel, sm, s_cand);
}

// B6 for N <= 64 with the window's tables in shared memory (see the head of
// this file): the CTA of reads kWalkWarps * blockIdx.x .. + kWalkWarps packs
// and transposes the window up to its highest live start, then warp i walks
// read i of the group.
__global__ void __launch_bounds__(kWalkThreads)
reach_many_kernel(const uint8_t* __restrict__ parent, const uint8_t* __restrict__ uncommitted,
                  const int32_t* __restrict__ offs, const uint8_t* __restrict__ onehots,
                  bool* __restrict__ masks, int W, int N, int K) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_top;
  const WalkLayout lay(W, N, reach_tail(W));
  uint32_t* s_par = smem;
  uint32_t* s_pre = s_par + lay.par_words;
  uint32_t* s_ct = s_pre + lay.pre_words;
  uint32_t* s_prw = s_ct + lay.ct_words;   // [W][2]
  uint32_t* s_keep = s_prw + 2 * W;        // [warps][W][2]
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, nwarps = nt >> 5;
  const int k0 = blockIdx.x * kWalkWarps, kn = min(kWalkWarps, K - k0);
  const walk_bits::WarpLanes lanes{tid & 31};
  if (tid == 0) s_top = -1;
  __syncthreads();
  for (int i = tid; i < kn * N; i += nt) {  // the highest start row of a live read
    const int s = offs[k0 + i / N];
    if (onehots[(size_t)k0 * N + i] && s >= 0 && s < W) atomicMax(&s_top, s);
  }
  __syncthreads();
  const int top = s_top;  // rows above it are never read; -1: nothing to pack
  pack_range(s_par, parent, lay.par_lo, top >= 1 ? (long long)(top + 1) * N * N : lay.par_lo);
  pack_range(s_pre, uncommitted, 0, (long long)(top + 1) * N);
  __syncthreads();
  walk_bits::column_table(lanes, s_par, (int)lay.par_lo, s_pre, N, top, s_ct, s_prw, warp,
                          nwarps);
  __syncthreads();
  if (warp < kn) {
    const int k = k0 + warp;
    walk_bits::reach_read(lanes, walk_bits::Tables{s_ct, s_prw, N}, offs[k],
                          onehots + (size_t)k * N, masks + (size_t)k * W * N, W,
                          s_keep + (size_t)warp * 2 * W);
  }
}

// B6 for N > 64, or a window whose tables do not fit in shared memory: the
// wide walk of one read a CTA (32 * ceil(N / 32) threads).
__global__ void __launch_bounds__(1024)
reach_many_wide_kernel(const uint8_t* __restrict__ parent,
                       const uint8_t* __restrict__ uncommitted,
                       const int32_t* __restrict__ offs, const uint8_t* __restrict__ onehots,
                       bool* __restrict__ masks, int W, int N) {
  extern __shared__ uint32_t sm[];
  __shared__ int s_cand[2];
  const int k = blockIdx.x;
  walk_bits::wide_walk(walk_bits::CtaThreads{(int)threadIdx.x, (int)blockDim.x}, parent,
                       uncommitted, nullptr, offs + k, onehots + (size_t)k * N,
                       masks + (size_t)k * W * N, W, N, 1, 0, walk_bits::kSentinel, sm, s_cand);
}

// B5 (see the head of this file and dag_support.cuh): warp i of CTA c
// walks c * kWarps + i; err[3c..3c+2] gets the CTA's lowest out-of-range
// walk {walk, offset, leader}, or {kNoWalk, 0, 0}.
__global__ void __launch_bounds__(32 * support::kWarps)
leader_support_kernel(const uint8_t* __restrict__ parent, const uint8_t* __restrict__ present,
                      const int32_t* __restrict__ stakes, const int32_t* __restrict__ offs,
                      const int32_t* __restrict__ leaders, int32_t* __restrict__ out,
                      int32_t* __restrict__ err, int W, int N, int M, int B) {
  __shared__ int s_bad;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * support::kWarps + (threadIdx.x >> 5);
  if (threadIdx.x == 0) s_bad = support::kNoWalk;
  int32_t off = 0, leader = 0;
  bool ok = true;
  uint32_t part = 0;
  if (b < B) {  // warp-uniform
    part = support::lane_part(parent, present, stakes, offs, leaders, b, W, N, M, lane, &off,
                              &leader, &ok);
  }
  const uint32_t sum = __reduce_add_sync(0xffffffffu, part);
  if (b < B && lane == 0) out[b] = (int32_t)sum;
  __syncthreads();  // s_bad set
  if (!ok && lane == 0) atomicMin(&s_bad, b);
  __syncthreads();
  const int bad = s_bad;
  int32_t* word = err + 3 * blockIdx.x;
  if (bad == support::kNoWalk) {
    if (threadIdx.x == 0) {
      word[0] = support::kNoWalk;
      word[1] = word[2] = 0;
    }
  } else if (b == bad && lane == 0) {
    word[0] = b;
    word[1] = off;
    word[2] = leader;
  }
}

// A column's best row in the CTA's table, raised; a read first skips the
// atomic when the table already holds a row as high (tables only grow).
struct SharedMax {
  __device__ __forceinline__ void operator()(int* a, int w) const {
    if (w > *a) atomicMax(a, w);
  }
};

// CTA r's table of the cluster, through distributed shared memory.
struct ClusterTables {
  cg::cluster_group& cluster;
  int* table;
  __device__ __forceinline__ int* operator()(int r) const {
    return cluster.map_shared_rank(table, r);
  }
};

// The CTA's own table (a launch of one CTA).
struct OwnTable {
  int* table;
  __device__ __forceinline__ int* operator()(int) const { return table; }
};

// B7's tail: one cluster of C CTAs (see the head of this file and
// dag_commit.cuh). Every global read that does not wait on the quorum goes
// out first: the thread's stakes, its first words and byte with their
// walks' support, and in CTA 0 last[t]. Each CTA sums the stakes (a warp
// reduction, a shared word a warp, one barrier), streams its share of the
// words into its own table of column bests; after a cluster barrier CTA 0
// folds the C tables through distributed shared memory, and a second
// barrier keeps every table alive until it has. A launch of one CTA folds
// its own table after a CTA barrier.
__global__ void __launch_bounds__(commit_mask::kThreads)
consensus_commit_kernel(const uint8_t* __restrict__ masks, const int32_t* __restrict__ support,
                        const int32_t* __restrict__ stakes, const int32_t* __restrict__ last,
                        uint8_t* __restrict__ committed, int32_t* __restrict__ new_last,
                        int B, int W, int M, int S) {
  extern __shared__ int s_best[];
  __shared__ uint32_t s_part[commit_mask::kThreads / 32];
  const int t = threadIdx.x, nt = blockDim.x;
  const int g = (int)blockIdx.x * nt + t, G = (int)gridDim.x * nt;
  const int n = B * W * M;  // < 2^31: the wrapper checks
  const commit_mask::Span sp = commit_mask::span_of(masks, committed, n, G);
  const uint32_t part = commit_mask::stake_part(stakes, S, t, nt);
  commit_mask::Batch x;
  commit_mask::load_first(masks, support, W * M, sp, g, G, x);
  const int32_t last_t = (blockIdx.x == 0 && t < M) ? last[t] : 0;
  commit_mask::init_best(s_best, M, B, W, t, nt);
  const uint32_t warp_part = __reduce_add_sync(0xffffffffu, part);
  if ((t & 31) == 0) s_part[t >> 5] = warp_part;
  __syncthreads();
  uint32_t total = 0;
#pragma unroll
  for (int k = 0; k < commit_mask::kThreads / 32; k++) total += s_part[k];
  const commit_mask::Dims d{W * M, W, M, commit_mask::quorum_of(total)};
  commit_mask::commit_stream(masks, committed, support, d, sp, s_best, g, G, x, SharedMax{});
  if (gridDim.x == 1) {
    __syncthreads();
    commit_mask::fold(last_t, last, new_last, M, 1, OwnTable{s_best}, t, nt);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    commit_mask::fold(last_t, last, new_last, M, (int)cluster.num_blocks(),
                      ClusterTables{cluster, s_best}, t, nt);
  }
  cluster.sync();
}

constexpr int kSentinel = -(1 << 30);

// One card's view of the exchange with the other cards of its auth row
// ("peer" and "host" routes). G == 1 on the "cluster" route: no exchange at
// all, and the pointers are null. A card's buffer holds, for each of `nslots` walk
// slots: flags uint32 [nslots][G] (the generation each card raised last),
// lcr int32 [nslots][2][G] and frontier uint8 [nslots][2][Npad] (the
// values of an exchange event, by event parity).
struct PeerExchange {
  uint8_t* const* bufs;  // [G] every card's exchange buffer, this card's included
  const int32_t* owner;  // [a] the card (launch) that holds each shard of the row
  int32_t* err;          // [2] this card's error word: {code, event}
  int G, g, nslots;
  uint32_t gen_base;
  long long timeout_ns;
};

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(uint32_t* p, uint32_t v) {
  asm volatile("st.release.sys.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t load_acquire_sys(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.sys.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A peer's byte or lcr candidate, after the acquire of its flag: strong
// at system scope (see the head of this file).
__device__ __forceinline__ uint8_t load_relaxed_sys(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.sys.u8 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return (uint8_t)v;
}

__device__ __forceinline__ int32_t load_relaxed_sys(const int32_t* p) {
  int32_t v;
  asm volatile("ld.relaxed.sys.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t* x_flags(uint8_t* buf, const PeerExchange& x, int slot) {
  return (uint32_t*)buf + (size_t)slot * x.G;
}

__device__ __forceinline__ int32_t* x_lcr(uint8_t* buf, const PeerExchange& x, int slot,
                                          int par) {
  return (int32_t*)(buf + 4 * (size_t)x.nslots * x.G) + ((size_t)slot * 2 + par) * x.G;
}

__device__ __forceinline__ uint8_t* x_front(uint8_t* buf, const PeerExchange& x, int slot,
                                            int par, int Npad) {
  return buf + 12 * (size_t)x.nslots * x.G + ((size_t)slot * 2 + par) * Npad;
}

// Thread 0 of rank 0: raise this card's flag on every peer to `gen` (after
// the stores to the peers, fenced system-wide), then wait for every peer's
// flag on this card's buffer. 0, or 1 when the deadline passes first.
__device__ int signal_and_wait(const PeerExchange& x, int slot, uint32_t gen) {
  for (int h = 0; h < x.G; h++) {
    if (h != x.g) store_release_sys(x_flags(x.bufs[h], x, slot) + x.g, gen);
  }
  const uint32_t* mine = x_flags(x.bufs[x.g], x, slot);
  const uint64_t t0 = global_ns();
  for (int h = 0; h < x.G; h++) {
    if (h == x.g) continue;
    while ((int32_t)(load_acquire_sys(mine + h) - gen) < 0) {
      if ((long long)(global_ns() - t0) > x.timeout_ns) return 1;
    }
  }
  return 0;
}

// Every thread of rank 0, after SYNC A of a row (event ev): this card's
// columns of the row's frontier `row` to every peer, then the peers'
// columns into `row` of every CTA of the cluster. Returns 0 or 1 (deadline).
__device__ int exchange_row(cg::cluster_group& cluster, const PeerExchange& x, uint8_t* row,
                            int Npad, int m, int slot, uint32_t ev) {
  __shared__ int s_rc;
  const int par = ev & 1;
  const int nr = (int)cluster.num_blocks();
  for (int h = 0; h < x.G; h++) {
    if (h == x.g) continue;
    uint8_t* dst = x_front(x.bufs[h], x, slot, par, Npad);
    for (int i = threadIdx.x; i < Npad; i += blockDim.x) {
      if (x.owner[i / m] == x.g) dst[i] = row[i];
    }
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) s_rc = signal_and_wait(x, slot, x.gen_base + ev + 1);
  __syncthreads();
  const int rc = s_rc;
  if (!rc) {
    const uint8_t* src = x_front(x.bufs[x.g], x, slot, par, Npad);
    for (int i = threadIdx.x; i < Npad; i += blockDim.x) {
      if (x.owner[i / m] == x.g) continue;
      const uint8_t v = load_relaxed_sys(src + i);
      for (int r = 0; r < nr; r++) cluster.map_shared_rank(row, r)[i] = v;
    }
  }
  return rc;
}

// The barrier after a row's stores: SYNC A, the exchange across cards on
// rank 0 (G > 1), SYNC B. Returns the status, the same in every CTA.
__device__ int row_barrier(cg::cluster_group& cluster, const PeerExchange& x, uint8_t* row,
                           int Npad, int m, int slot, uint32_t& ev, int* s_status) {
  cluster.sync();
  if (x.G == 1) return 0;
  if (cluster.block_rank() == 0) {
    const int rc = exchange_row(cluster, x, row, Npad, m, slot, ev);
    if (threadIdx.x == 0) {
      for (int r = 0; r < (int)cluster.num_blocks(); r++) *cluster.map_shared_rank(s_status, r) = rc;
      if (rc) {
        x.err[0] = 1;
        x.err[1] = (int)ev;
      }
    }
  }
  ev++;
  cluster.sync();
  return *s_status;
}

// The max of every CTA's lcr candidate `cand` over the cluster, then over
// the cards (G > 1, an exchange event). Sets *rc to the status.
__device__ int reduce_lcr(cg::cluster_group& cluster, const PeerExchange& x, int* cand,
                          int slot, uint32_t& ev, int* s_status, int* s_glob, int* rc) {
  cluster.sync();  // every CTA's atomicMax into its own candidate is done
  int best = kSentinel;
  const int nr = (int)cluster.num_blocks();
  for (int r = 0; r < nr; r++) best = max(best, *cluster.map_shared_rank(cand, r));
  *rc = 0;
  if (x.G == 1) return best;
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    const int par = ev & 1;
    for (int h = 0; h < x.G; h++) {
      if (h != x.g) x_lcr(x.bufs[h], x, slot, par)[x.g] = best;
    }
    __threadfence_system();
    const int status = signal_and_wait(x, slot, x.gen_base + ev + 1);
    int glob = best;
    if (!status) {
      const int32_t* src = x_lcr(x.bufs[x.g], x, slot, par);
      for (int h = 0; h < x.G; h++) {
        if (h != x.g) glob = max(glob, load_relaxed_sys(src + h));
      }
    } else {
      x.err[0] = 1;
      x.err[1] = (int)ev;
    }
    for (int r = 0; r < nr; r++) {
      *cluster.map_shared_rank(s_glob, r) = glob;
      *cluster.map_shared_rank(s_status, r) = status;
    }
  }
  ev++;
  cluster.sync();
  *rc = *s_status;
  return *s_glob;
}

// parent [a_l, W, Npad, m], present [a_l, W, m], lc [a_l, m] (chain mode),
// masks [a_l, K, W, m]: the blocks of this card's a_l shards, rank r holding
// shard slots[r] of the row (slots null: rank r holds shard r). offs [K],
// onehots [K, Npad]. Chain mode: one cluster walks the K leaders in order.
// Many mode: cluster c walks k0 + c.
__global__ void sharded_walk_kernel(const uint8_t* __restrict__ parent,
                                    const uint8_t* __restrict__ present,
                                    const int32_t* __restrict__ lc_in,
                                    const int32_t* __restrict__ offs,
                                    const uint8_t* __restrict__ onehots,
                                    bool* __restrict__ masks, const int32_t* __restrict__ slots,
                                    int W, int Npad, int m, int K, int k0, int gc_depth,
                                    int lcr_rel, int chain, PeerExchange x) {
  extern __shared__ uint8_t s_front[];  // [2][Npad], the frontier rows of parity 0 and 1
  __shared__ int s_cand[2];             // this CTA's lcr candidate, by live-leader parity
  __shared__ int s_status, s_glob;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nr = (int)cluster.num_blocks();
  const int c = blockIdx.x / nr;  // this cluster's walk slot
  const int s = slots ? slots[rank] : rank;
  const int p = threadIdx.x;
  const bool live = p < m;
  const uint8_t* par = parent + (size_t)rank * W * Npad * m;
  const uint8_t* pre = present + (size_t)rank * W * m;
  int lc = (chain && live) ? lc_in[(size_t)rank * m + p] : 0;
  int lcr = lcr_rel;
  uint32_t ev = 0;  // exchange events of this walk slot
  int n_live = 0;   // live leaders walked so far
  if (p == 0) s_status = 0;
  cluster.sync();  // every CTA of the cluster runs before the first remote store
  const int k_first = chain ? 0 : k0 + c;
  const int k_end = chain ? K : k_first + 1;
  for (int k = k_first; k < k_end; k++) {
    bool* out = masks + ((size_t)rank * K + k) * W * m;
    const uint8_t* oh = onehots + (size_t)k * Npad;
    int any = 0;
    for (int i = p; i < Npad; i += blockDim.x) any |= oh[i];
    int* cand = s_cand + (n_live & 1);
    if (p == 0) *cand = kSentinel;
    any = __syncthreads_or(any);
    const int start_off = offs[k];
    const bool start_bit = live && oh[(size_t)s * m + p] != 0;
    const int top = any ? min(start_off, W - 1) : -1;
    if (live) {
      for (int w = W - 1; w > top; w--) out[(size_t)w * m + p] = false;
    }
    if (!any) continue;  // a padding slot reaches nothing and changes nothing
    int committed = kSentinel;
    for (int w = top; w >= 0; w--) {
      bool here = false;
      if (live) {
        here = reach_step(par, s_front + ((w + 1) & 1) * Npad, w, W, Npad, m, p, start_off,
                          start_bit);
        here = here && pre[(size_t)w * m + p] != 0 && (!chain || w > lc);  // uncommitted
        const bool keep = here && (!chain || w + gc_depth >= lcr);
        out[(size_t)w * m + p] = keep;
        if (keep && w > committed) committed = w;
      }
      if (w == 0) break;  // no row below
      uint8_t* row = s_front + (w & 1) * Npad;
      if (live) {
        for (int r = 0; r < nr; r++) cluster.map_shared_rank(row, r)[(size_t)s * m + p] = here;
      }
      if (row_barrier(cluster, x, row, Npad, m, c, ev, &s_status)) return;
    }
    if (!chain) continue;
    if (live && committed > kSentinel) atomicMax(cand, committed);
    int rc;
    const int best = reduce_lcr(cluster, x, cand, c, ev, &s_status, &s_glob, &rc);
    if (rc) return;
    if (committed > lc) lc = committed;
    if (best > lcr) lcr = best;
    n_live++;
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

}  // namespace

// The window_sync launches of one sync: the T slots (offs, idxs: int32
// [T]; rows: [T, (N + 7) / 8] bytes of bits, as dag_window_sync.cuh's
// pack_block reads them) packed into parameter blocks on the host, so the
// host arrays are free when this returns; slots outside the window are
// dropped. The first launch rolls by shift (0 <= shift <= W) when the
// outputs are not the inputs, the rest place in place; a sync in place
// with no slot inside the window launches nothing. `chunk` bytes of a
// parent row a CTA and `threads` a CTA (0: the defaults, chunk_bytes's
// split of a row and kSyncThreads). *launches gets the launches made.
extern "C" int dag_window_window_sync(const void* parent, const void* present,
                                      void* out_parent, void* out_present, const void* offs,
                                      const void* idxs, const void* rows, void* launches,
                                      int W, int N, int shift, int T, int chunk, int threads,
                                      void* stream) {
  if (W < 1 || N < 1 || W > 65536 || N > 65536 || window_sync::capacity(W, N) < 1 ||
      shift < 0 || shift > W || T < 0 || chunk < 0 || threads < 0 ||
      threads > kSyncThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row = (long long)N * N;
  const long long ch = window_sync::chunk_bytes(chunk, row);
  const dim3 grid((unsigned)W, (unsigned)((row + ch - 1) / ch));
  const int nt = threads > 0 ? threads : kSyncThreads;
  const uint8_t* src_p = (const uint8_t*)parent;
  const uint8_t* src_q = (const uint8_t*)present;
  int n = 0;
  const int rc = window_sync::for_each_block(
      (const int32_t*)offs, (const int32_t*)idxs, (const uint8_t*)rows, T, W, N, shift,
      out_parent != parent, n, [&](const window_sync::Slots& s, int sh) {
        window_sync_kernel<<<grid, nt, 0, (cudaStream_t)stream>>>(
            src_p, src_q, (uint8_t*)out_parent, (uint8_t*)out_present, W, N, sh, (int)ch, s);
        src_p = (const uint8_t*)out_parent;
        src_q = (const uint8_t*)out_present;
        return (int)cudaGetLastError();
      });
  *(int*)launches = n;
  return rc;
}

// The parameter block's layout at W, N: the slots a window_sync launch
// carries (0: a slot is wider than a block), and the bits of a slot in
// *slot_bits.
extern "C" int dag_window_sync_layout(int W, int N, void* slot_bits) {
  *(int*)slot_bits = window_sync::slot_bits(W, N);
  return window_sync::capacity(W, N);
}

// The packed walks' shared-memory limits per card: the opt-in maximum, read
// once, and the largest dynamic size set on each kernel so far, so a launch
// calls cudaFuncSetAttribute only when it needs more than that.
constexpr int kMaxCards = 64;
static std::atomic<int> g_walk_optin[kMaxCards];
static std::atomic<int> g_chain_smem[kMaxCards];
static std::atomic<int> g_reach_smem[kMaxCards];
static std::mutex g_walk_smem_lock;

// The current card and its opt-in shared bytes per block.
static cudaError_t walk_card(int& dev, int& optin) {
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxCards) return cudaErrorInvalidDevice;
  optin = g_walk_optin[dev].load(std::memory_order_relaxed);
  if (optin == 0) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    g_walk_optin[dev].store(optin, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// Let `kernel` take `bytes` of dynamic shared memory on card dev (the size
// set on it, `set[dev]`, only grows).
static cudaError_t walk_smem(const void* kernel, std::atomic<int>* set, int dev, size_t bytes) {
  if (bytes <= 48 * 1024 || (int)bytes <= set[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  std::lock_guard<std::mutex> hold(g_walk_smem_lock);
  if ((int)bytes > set[dev].load(std::memory_order_relaxed)) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    set[dev].store((int)bytes, std::memory_order_release);
  }
  return cudaSuccess;
}

extern "C" int dag_window_chain_commit(const void* parent, const void* present,
                                       const void* lc_rel, const void* offs,
                                       const void* onehots, void* masks, int W, int N,
                                       int K, int gc_depth, int lcr_rel, void* stream) {
  int dev = 0, optin = 0;
  cudaError_t e = walk_card(dev, optin);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = (size_t)WalkLayout(W, N, chain_tail(W)).total * 4;
  if (N <= 64 && bytes <= (size_t)optin) {
    e = walk_smem((const void*)chain_commit_kernel, g_chain_smem, dev, bytes);
    if (e != cudaSuccess) return (int)e;
    chain_commit_kernel<<<1, kWalkThreads, bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)parent, (const uint8_t*)present, (const int32_t*)lc_rel,
        (const int32_t*)offs, (const uint8_t*)onehots, (bool*)masks, W, N, K, gc_depth,
        lcr_rel);
  } else {
    const int nw = (N + 31) / 32;
    chain_commit_wide_kernel<<<1, 32 * nw, (size_t)2 * nw * 4, (cudaStream_t)stream>>>(
        (const uint8_t*)parent, (const uint8_t*)present, (const int32_t*)lc_rel,
        (const int32_t*)offs, (const uint8_t*)onehots, (bool*)masks, W, N, K, gc_depth,
        lcr_rel);
  }
  return (int)cudaGetLastError();
}

// B6's packed route: N <= 64 and the tables fit in `optin` shared bytes.
static bool reach_packed(int W, int N, int optin) {
  return N <= 64 && (size_t)WalkLayout(W, N, reach_tail(W)).total * 4 <= (size_t)optin;
}

// B6's route on the current card for a window of W rows and N columns: 1 the
// packed reach_many_kernel, 0 the wide walk, or a negative cudaError_t.
extern "C" int dag_window_reach_route(int W, int N) {
  int dev = 0, optin = 0;
  const cudaError_t e = walk_card(dev, optin);
  if (e != cudaSuccess) return -(int)e;
  return reach_packed(W, N, optin) ? 1 : 0;
}

// B6: ceil(K / 16) CTAs of 16 reads on the packed route, else K CTAs of one.
extern "C" int dag_window_reach_many(const void* parent, const void* uncommitted,
                                     const void* offs, const void* onehots, void* masks,
                                     int W, int N, int K, void* stream) {
  int dev = 0, optin = 0;
  cudaError_t e = walk_card(dev, optin);
  if (e != cudaSuccess) return (int)e;
  if (reach_packed(W, N, optin)) {
    const size_t bytes = (size_t)WalkLayout(W, N, reach_tail(W)).total * 4;
    e = walk_smem((const void*)reach_many_kernel, g_reach_smem, dev, bytes);
    if (e != cudaSuccess) return (int)e;
    reach_many_kernel<<<(K + kWalkWarps - 1) / kWalkWarps, kWalkThreads, bytes,
                        (cudaStream_t)stream>>>((const uint8_t*)parent,
                                                (const uint8_t*)uncommitted,
                                                (const int32_t*)offs, (const uint8_t*)onehots,
                                                (bool*)masks, W, N, K);
  } else {
    const int nw = (N + 31) / 32;
    reach_many_wide_kernel<<<K, 32 * nw, (size_t)2 * nw * 4, (cudaStream_t)stream>>>(
        (const uint8_t*)parent, (const uint8_t*)uncommitted, (const int32_t*)offs,
        (const uint8_t*)onehots, (bool*)masks, W, N);
  }
  return (int)cudaGetLastError();
}

// B5: support::ctas_for(B) CTAs of support::kWarps walks; err holds 3
// int32 a CTA (its lowest out-of-range walk, see leader_support_kernel).
extern "C" int dag_window_leader_support(const void* parent, const void* present,
                                         const void* stakes, const void* offs,
                                         const void* leaders, void* out, void* err, int W,
                                         int N, int M, int B, void* stream) {
  if (B < 1 || W < 0 || N < 0 || M < 0) return (int)cudaErrorInvalidValue;
  leader_support_kernel<<<support::ctas_for(B), 32 * support::kWarps, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)parent, (const uint8_t*)present, (const int32_t*)stakes,
      (const int32_t*)offs, (const int32_t*)leaders, (int32_t*)out, (int32_t*)err, W, N, M, B);
  return (int)cudaGetLastError();
}

// B5's walks a CTA (the error words of a launch over B walks: 3 int32 for
// each of ceil(B / walks) CTAs) and the error word's walk when none is out
// of range.
extern "C" int dag_window_leader_support_layout(void* no_walk) {
  *(int32_t*)no_walk = support::kNoWalk;
  return support::kWarps;
}

// B7: one cluster of commit_mask::ctas_for(B * W * M) CTAs, 4 * M bytes of
// shared memory each; a launch of one CTA is an ordinary launch.
extern "C" int dag_window_consensus_commit(const void* masks, const void* support,
                                           const void* stakes, const void* last,
                                           void* committed, void* new_last, int B, int W, int M,
                                           int S, void* stream) {
  const size_t smem = (size_t)4 * M;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        consensus_commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int C = commit_mask::ctas_for(B * W * M);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3((unsigned)commit_mask::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, consensus_commit_kernel, (const uint8_t*)masks, (const int32_t*)support,
      (const int32_t*)stakes, (const int32_t*)last, (uint8_t*)committed, (int32_t*)new_last, B,
      W, M, S);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One card's launch of sharded_walk: nk clusters of `a` CTAs (chain mode:
// nk = 1), one thread per column, 2 * Npad bytes of shared memory. G == 1
// (the "cluster" route) passes null bufs, owner and err; G > 1 passes the
// walk slots (nslots >= nk) every card's exchange buffer was laid out for.
extern "C" int dag_window_sharded_walk(const void* parent, const void* present, const void* lc,
                                       const void* offs, const void* onehots, void* masks,
                                       const void* slots, const void* bufs, const void* owner,
                                       void* err, int W, int Npad, int m, int K, int k0, int nk,
                                       int nslots, int a, int gc_depth, int lcr_rel, int chain,
                                       int G, int g, int gen_base, int timeout_ms,
                                       void* stream) {
  if (a > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        sharded_walk_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nk * a));
  cfg.blockDim = dim3((unsigned)(((m + 31) / 32) * 32));
  cfg.dynamicSmemBytes = (size_t)2 * Npad;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)a;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const PeerExchange x{(uint8_t* const*)bufs, (const int32_t*)owner, (int32_t*)err,
                       G, g, nslots, (uint32_t)gen_base, (long long)timeout_ms * 1000000LL};
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, sharded_walk_kernel, (const uint8_t*)parent, (const uint8_t*)present,
      (const int32_t*)lc, (const int32_t*)offs, (const uint8_t*)onehots, (bool*)masks,
      (const int32_t*)slots, W, Npad, m, K, k0, gc_depth, lcr_rel, chain, x);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `a` CTAs of sharded_walk (m columns, Npad frontier
// bytes) the current card holds at once; a negative cudaError_t on failure.
extern "C" int dag_window_sharded_walk_max_clusters(int a, int m, int Npad) {
  if (a > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        sharded_walk_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return -(int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a);
  cfg.blockDim = dim3((unsigned)(((m + 31) / 32) * 32));
  cfg.dynamicSmemBytes = (size_t)2 * Npad;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)a;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, sharded_walk_kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return n;
}

// Map card `peer`'s memory into card `dev`'s address space (an ordered
// pair); an already mapped pair is success.
extern "C" int dag_window_enable_peer(int dev, int peer) {
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(cur);
  return (int)(e != cudaSuccess ? e : back);
}

// Pinned host memory that every card can address, for the "host" route's
// exchange buffers: portable and mapped, its host pointer its device
// pointer under unified addressing (checked), zeroed. *ptr gets it.
extern "C" int dag_window_host_alloc(long long bytes, void* ptr) {
  void* p = nullptr;
  cudaError_t e = cudaHostAlloc(&p, (size_t)bytes, cudaHostAllocPortable | cudaHostAllocMapped);
  if (e != cudaSuccess) return (int)e;
  void* d = nullptr;
  e = cudaHostGetDevicePointer(&d, p, 0);
  if (e != cudaSuccess || d != p) {
    cudaFreeHost(p);
    return e != cudaSuccess ? (int)e : (int)cudaErrorNotSupported;
  }
  std::memset(p, 0, (size_t)bytes);
  *(void**)ptr = p;
  return 0;
}

// Frees what dag_window_host_alloc gave, once no launch that holds it runs.
extern "C" int dag_window_host_free(void* p) { return (int)cudaFreeHost(p); }

extern "C" const char* dag_window_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
