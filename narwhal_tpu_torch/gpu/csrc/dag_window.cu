// The device DAG window, the commit walk and the batched causal reads, for
// Hopper (sm_90a).
//
// Tensors (the JAX package's layout, narwhal_tpu/tpu/dag_kernels.py):
//   parent  [W, N, N] uint8   parent[w, a, p] = cert (w, a) links (w-1, p)
//   present [W, N]    uint8   a certificate exists at (round offset w, authority)
// Seven kernels, each with a plain PyTorch version in ../dag_kernels.py:
//
// place_batch  replaces narwhal_tpu/tpu/dag_kernels.py:95 `place_batch` (B3).
//   Scatter T padded placements: for each slot t with valid[t] != 0,
//   present[offs[t], idxs[t]] = 1 and parent[offs[t], idxs[t], :] = rows[t].
//   One block per slot, threads stride over the N columns, so a row is
//   written by consecutive threads (coalesced). Padding slots are no-ops;
//   duplicate (off, idx) slots carry identical rows (the host reads them from
//   its mirror at sync time), so their write order does not matter. Slots
//   whose coordinates fall outside the window are dropped. Bound: bytes,
//   valid[T] read, offs, idxs and the row of each live slot read, and each
//   distinct (off, idx) cell written once (N + 1 bytes); at T <= 64,
//   N = 50 that is under 6 KB, so the launch itself is the cost. Updates the window in place (the JAX kernel donates
//   its inputs for the same reason: the old generation is dead).
//
// roll_window  replaces narwhal_tpu/tpu/dag_kernels.py:79 `roll_window` (B4).
//   out[w] = in[w + shift] for w < W - shift, else 0, for parent and present
//   in one launch. The wrapper allocates the outputs, so a copy never
//   overlaps its own source. Bound: bytes, (W - shift) rows read and W rows
//   written; one thread per 4-byte word of the output is plenty at
//   W = 64, N = 50 (160 KB).
//
// chain_commit replaces narwhal_tpu/tpu/dag_kernels.py:128 `chain_commit` (B2),
//   with `reach_mask` (:48, B1) as the device function `reach_step` inside it.
//   One CTA runs the whole scan over the K chain leaders, oldest first; thread
//   p owns authority column p (N <= 1024). For each leader it walks rows
//   W-1 .. 0: the row above's reach set ("frontier") sits in shared memory and
//   thread p ORs parent[w+1, a, p] over the a with frontier[a] set, which is
//   the JAX kernel's `links^T @ frontier > 0`. Semantics kept exactly:
//     - the start row is seeded by the leader's one-hot, rows above it are
//       empty, a zero one-hot slot reaches nothing (a no-op);
//     - uncommitted = present & (row > lc[p]) is re-derived per leader from
//       the lc that the earlier leaders of this chain advanced;
//     - keep = reach & (row + gc_depth >= lcr) with the lcr from BEFORE this
//       leader's update;
//     - committed_round[p] = max row with keep, else the sentinel -(2^30);
//       lc[p] = max(lc[p], committed_round[p]), lcr = max(lcr, max_p ...).
//   Bound: bytes. Rows above the newest leader are empty by definition, so
//   the least traffic is parent rows 1..max(offs) and present rows
//   0..max(offs) read once, lc, offs and the one-hots read, and the K masks
//   written: ~150 KB with the leader at row 58 of W = 64, N = 50, K = 1,
//   well under a microsecond of HBM time. The kernel is latency-bound by its
//   sequential row steps (two block barriers each), which is why it is one
//   CTA and not many.
//
// reach_many   replaces narwhal_tpu/consensus/dag.py:262 `_reach_k` (B6), the
//   jitted vmap of reach_mask over K read starts that serves the Dag
//   service's coalesced read_causal: masks[k] = reach_mask(parent,
//   uncommitted, offs[k], onehots[k]) for k < K. One CTA per walk (K CTAs,
//   the walks are independent), thread p owns authority column p (N <= 1024),
//   and each row step is the same `reach_step` device function as
//   chain_commit's, with the same two barriers per row; the frontier sits
//   in shared memory. `uncommitted` is what the caller passes (the service
//   passes `present`): no lc or gc filter. A padding slot (zero one-hot)
//   reaches nothing and writes an all-zero mask. W is an argument, so the
//   window may grow (64, 128, 256, ...) without a rebuild. Bound: bytes,
//   as for chain_commit: parent rows 1..max(offs) and uncommitted rows
//   0..max(offs) read once, offs and the one-hots read, and the K masks
//   written (K * W * N bytes). It inherits chain_commit's latency: W serial
//   row steps with a dependent-load loop each, and the walk goes on below
//   an empty frontier.
//
// leader_support replaces narwhal_tpu/tpu/dag_kernels.py:119 `leader_support`
//   (B5), batched over B walks as __graft_entry__.py:235 vmaps it: out[b] =
//   sum of stakes[a] over the a with parent[offs[b], a, leaders[b]] and
//   present[offs[b], a] set, in wrapping int32 arithmetic like jnp.sum. The
//   link axis has M columns (M = N unsharded; a shard's column block under
//   the committee-axis mesh), so `leaders` index that block. One warp per
//   walk, lanes stride over the N voters (a strided byte column of the
//   parent row: one 32-byte sector per voter), then a shuffle reduction.
//   The wrapper rejects offsets and leader indices outside the window.
//   Bound: bytes, the B parent columns, present rows and stakes it reads
//   (under 20 KB at B = 64, N = 50): the launch is the cost.
//
// consensus_commit replaces the tail of __graft_entry__.py:229
//   `consensus_step` (B7): quorum = sum(stakes) // 3 + 1 (wrapping int32,
//   floor division), committed[b, w, p] = masks[b, w, p] & (support[b] >=
//   quorum), new_last[p] = max(last[p], max over (b, w) of committed * w).
//   One thread per authority column p loops over the B walks and W rows, so
//   a warp reads and writes 32 consecutive bytes of a mask row; each thread
//   sums the S stakes itself (S <= 1024). Bound: bytes, the B x W x M masks
//   read and written once (410 KB at B = 64, W = 64, N = 50).
//
// reach_shard_step replaces narwhal_tpu/tpu/dag_kernels.py:128 `chain_commit`
//   and `reach_mask` (:48) under the committee-axis mesh (node.py:296-330,
//   in-specs P(None, None, "auth")): one row step of K walks on one shard.
//   The shard holds a column block of M = N / auth link columns, parent
//   [W, N, M], present [W, M] and lc [M]; the frontier of the row above is
//   replicated, [K, N]. For each walk k and column p of the block it runs
//   `reach_step` at row w, masks by uncommitted = present & (w > lc[p]),
//   keeps = reached & (w + gc_depth >= *lcr), writes masks[k, w, p] and
//   frontier_out[k, p] (this shard's block of the next frontier), and raises
//   committed[k, p] to w where kept: chain_commit_kernel's bookkeeping for
//   its own columns. The host all-gathers the frontier blocks between rows
//   and takes the max of the shards' committed rounds (the lcr candidates)
//   between leaders. One CTA per walk, one thread per column (M <= 1024);
//   the row above's frontier is staged in shared memory. Bound: bytes, the
//   parent row w + 1 block, present row, lc, the frontier and the walk's
//   one-hots read, the mask row, frontier block and committed written; a few
//   KB per launch at N = 50, so each launch costs its launch latency, and a
//   walk costs W of them per shard.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void place_batch_kernel(uint8_t* __restrict__ parent, uint8_t* __restrict__ present,
                                   const int32_t* __restrict__ offs,
                                   const int32_t* __restrict__ idxs,
                                   const uint8_t* __restrict__ rows,
                                   const uint8_t* __restrict__ valid, int W, int N) {
  const int t = blockIdx.x;
  if (!valid[t]) return;
  const int off = offs[t], idx = idxs[t];
  if (off < 0 || off >= W || idx < 0 || idx >= N) return;
  uint8_t* dst = parent + ((size_t)off * N + idx) * N;
  const uint8_t* src = rows + (size_t)t * N;
  for (int c = threadIdx.x; c < N; c += blockDim.x) dst[c] = src[c];
  if (threadIdx.x == 0) present[(size_t)off * N + idx] = 1;
}

// out_parent [W*N*N] and out_present [W*N] from the inputs shifted by `shift`
// rows; one thread per output byte, grid-stride.
__global__ void roll_window_kernel(const uint8_t* __restrict__ parent,
                                   const uint8_t* __restrict__ present,
                                   uint8_t* __restrict__ out_parent,
                                   uint8_t* __restrict__ out_present, int W, int N,
                                   int shift) {
  const size_t row_p = (size_t)N * N;
  const size_t n_parent = (size_t)W * row_p;
  const size_t n_total = n_parent + (size_t)W * N;
  const size_t keep_rows = shift < W ? (size_t)(W - shift) : 0;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_total;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < n_parent) {
      const size_t w = i / row_p;
      out_parent[i] = w < keep_rows ? parent[i + (size_t)shift * row_p] : 0;
    } else {
      const size_t j = i - n_parent;
      const size_t w = j / N;
      out_present[j] = w < keep_rows ? present[j + (size_t)shift * N] : 0;
    }
  }
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

__global__ void chain_commit_kernel(const uint8_t* __restrict__ parent,
                                    const uint8_t* __restrict__ present,
                                    const int32_t* __restrict__ lc_rel,
                                    const int32_t* __restrict__ offs,
                                    const uint8_t* __restrict__ onehots,
                                    bool* __restrict__ masks, int W, int N, int K,
                                    int gc_depth, int lcr_rel) {
  extern __shared__ uint8_t frontier[];  // [N]
  __shared__ int s_lcr, s_lcr_next;
  const int p = threadIdx.x;
  const bool live = p < N;
  int lc = live ? lc_rel[p] : 0;
  if (p == 0) {
    s_lcr = lcr_rel;
    s_lcr_next = lcr_rel;
  }
  __syncthreads();
  for (int k = 0; k < K; k++) {
    const int start_off = offs[k];
    const bool start_bit = live && onehots[(size_t)k * N + p] != 0;
    const int lcr = s_lcr;
    int committed = -(1 << 30);
    if (live) frontier[p] = 0;
    __syncthreads();
    for (int w = W - 1; w >= 0; w--) {
      bool here = false;
      if (live) {
        here = reach_step(parent, frontier, w, W, N, N, p, start_off, start_bit);
        here = here && present[(size_t)w * N + p] != 0 && w > lc;  // uncommitted
        const bool keep = here && (w + gc_depth >= lcr);
        masks[((size_t)k * W + w) * N + p] = keep;
        if (keep && w > committed) committed = w;
      }
      __syncthreads();  // every column has read the row above
      if (live) frontier[p] = here;
      __syncthreads();  // the row is complete before the next step reads it
    }
    if (live) {
      if (committed > lc) lc = committed;
      atomicMax(&s_lcr_next, committed);
    }
    __syncthreads();
    if (p == 0) s_lcr = max(s_lcr, s_lcr_next);
    __syncthreads();
  }
}

__global__ void reach_many_kernel(const uint8_t* __restrict__ parent,
                                  const uint8_t* __restrict__ uncommitted,
                                  const int32_t* __restrict__ offs,
                                  const uint8_t* __restrict__ onehots,
                                  bool* __restrict__ masks, int W, int N) {
  extern __shared__ uint8_t frontier[];  // [N]
  const int k = blockIdx.x;
  const int p = threadIdx.x;
  const bool live = p < N;
  const int start_off = offs[k];
  const bool start_bit = live && onehots[(size_t)k * N + p] != 0;
  bool* out = masks + (size_t)k * W * N;
  if (live) frontier[p] = 0;
  __syncthreads();
  for (int w = W - 1; w >= 0; w--) {
    bool here = false;
    if (live) {
      here = reach_step(parent, frontier, w, W, N, N, p, start_off, start_bit);
      here = here && uncommitted[(size_t)w * N + p] != 0;
      out[(size_t)w * N + p] = here;
    }
    __syncthreads();  // every column has read the row above
    if (live) frontier[p] = here;
    __syncthreads();  // the row is complete before the next step reads it
  }
}

__global__ void leader_support_kernel(const uint8_t* __restrict__ parent,
                                      const uint8_t* __restrict__ present,
                                      const int32_t* __restrict__ stakes,
                                      const int32_t* __restrict__ offs,
                                      const int32_t* __restrict__ leaders,
                                      int32_t* __restrict__ out, int N, int M, int B) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  const int off = offs[b], l = leaders[b];
  const uint8_t* links = parent + (size_t)off * N * M;
  const uint8_t* pres = present + (size_t)off * N;
  uint32_t sum = 0;  // unsigned: int32 wrap-around without undefined behaviour
  for (int a = lane; a < N; a += 32) {
    if (links[(size_t)a * M + l] && pres[a]) sum += (uint32_t)stakes[a];
  }
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, d);
  if (lane == 0) out[b] = (int32_t)sum;
}

__global__ void consensus_commit_kernel(const bool* __restrict__ masks,
                                        const int32_t* __restrict__ support,
                                        const int32_t* __restrict__ stakes,
                                        const int32_t* __restrict__ last,
                                        bool* __restrict__ committed,
                                        int32_t* __restrict__ new_last, int B, int W, int M,
                                        int S) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  uint32_t total = 0;
  for (int a = 0; a < S; a++) total += (uint32_t)stakes[a];
  const int32_t t = (int32_t)total;
  int32_t q = t / 3;
  if (t % 3 != 0 && t < 0) q -= 1;  // floor division, as jnp's //
  const int32_t quorum = q + 1;
  int best = (B > 0 && W > 0) ? 0 : INT32_MIN;  // max of committed * w over (b, w)
  for (int b = 0; b < B; b++) {
    const bool ok = support[b] >= quorum;
    for (int w = 0; w < W; w++) {
      const size_t i = ((size_t)b * W + w) * M + p;
      const bool c = ok && masks[i];
      committed[i] = c;
      if (c && w > best) best = w;
    }
  }
  new_last[p] = max(last[p], best);
}

__global__ void reach_shard_step_kernel(const uint8_t* __restrict__ parent,
                                        const uint8_t* __restrict__ present,
                                        const int32_t* __restrict__ lc,
                                        const uint8_t* __restrict__ frontier_in,
                                        const int32_t* __restrict__ offs,
                                        const uint8_t* __restrict__ onehots,
                                        const int32_t* __restrict__ lcr,
                                        uint8_t* __restrict__ frontier_out,
                                        bool* __restrict__ masks,
                                        int32_t* __restrict__ committed, int W, int N, int M,
                                        int w, int gc_depth) {
  extern __shared__ uint8_t frontier[];  // [N], the row above, every column
  const int k = blockIdx.x;
  for (int a = threadIdx.x; a < N; a += blockDim.x) frontier[a] = frontier_in[(size_t)k * N + a];
  __syncthreads();
  const int p = threadIdx.x;
  if (p >= M) return;
  const bool start_bit = onehots[(size_t)k * M + p] != 0;
  bool here = reach_step(parent, frontier, w, W, N, M, p, offs[k], start_bit);
  here = here && present[(size_t)w * M + p] != 0 && w > lc[p];  // uncommitted
  const bool keep = here && (w + gc_depth >= lcr[0]);
  masks[((size_t)k * W + w) * M + p] = keep;
  frontier_out[(size_t)k * M + p] = here;
  int32_t* c = committed + (size_t)k * M + p;
  if (keep && w > *c) *c = w;
}

}  // namespace

extern "C" int dag_window_place_batch(void* parent, void* present, const void* offs,
                                      const void* idxs, const void* rows, const void* valid,
                                      int W, int N, int T, void* stream) {
  const int threads = N < 256 ? ((N + 31) / 32) * 32 : 256;
  place_batch_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)parent, (uint8_t*)present, (const int32_t*)offs, (const int32_t*)idxs,
      (const uint8_t*)rows, (const uint8_t*)valid, W, N);
  return (int)cudaGetLastError();
}

extern "C" int dag_window_roll_window(const void* parent, const void* present,
                                      void* out_parent, void* out_present, int W, int N,
                                      int shift, void* stream) {
  const size_t total = (size_t)W * N * N + (size_t)W * N;
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  roll_window_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)parent, (const uint8_t*)present, (uint8_t*)out_parent,
      (uint8_t*)out_present, W, N, shift);
  return (int)cudaGetLastError();
}

extern "C" int dag_window_chain_commit(const void* parent, const void* present,
                                       const void* lc_rel, const void* offs,
                                       const void* onehots, void* masks, int W, int N,
                                       int K, int gc_depth, int lcr_rel, void* stream) {
  const int threads = ((N + 31) / 32) * 32;
  chain_commit_kernel<<<1, threads, (size_t)N, (cudaStream_t)stream>>>(
      (const uint8_t*)parent, (const uint8_t*)present, (const int32_t*)lc_rel,
      (const int32_t*)offs, (const uint8_t*)onehots, (bool*)masks, W, N, K, gc_depth,
      lcr_rel);
  return (int)cudaGetLastError();
}

extern "C" int dag_window_reach_many(const void* parent, const void* uncommitted,
                                     const void* offs, const void* onehots, void* masks,
                                     int W, int N, int K, void* stream) {
  const int threads = ((N + 31) / 32) * 32;
  reach_many_kernel<<<K, threads, (size_t)N, (cudaStream_t)stream>>>(
      (const uint8_t*)parent, (const uint8_t*)uncommitted, (const int32_t*)offs,
      (const uint8_t*)onehots, (bool*)masks, W, N);
  return (int)cudaGetLastError();
}

extern "C" int dag_window_leader_support(const void* parent, const void* present,
                                         const void* stakes, const void* offs,
                                         const void* leaders, void* out, int N, int M, int B,
                                         void* stream) {
  const int warps = 4;
  const int blocks = (B + warps - 1) / warps;
  leader_support_kernel<<<blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)parent, (const uint8_t*)present, (const int32_t*)stakes,
      (const int32_t*)offs, (const int32_t*)leaders, (int32_t*)out, N, M, B);
  return (int)cudaGetLastError();
}

extern "C" int dag_window_consensus_commit(const void* masks, const void* support,
                                           const void* stakes, const void* last,
                                           void* committed, void* new_last, int B, int W, int M,
                                           int S, void* stream) {
  const int threads = 128;
  consensus_commit_kernel<<<(M + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const bool*)masks, (const int32_t*)support, (const int32_t*)stakes,
      (const int32_t*)last, (bool*)committed, (int32_t*)new_last, B, W, M, S);
  return (int)cudaGetLastError();
}

extern "C" int dag_window_reach_shard_step(const void* parent, const void* present,
                                           const void* lc, const void* frontier_in,
                                           const void* offs, const void* onehots,
                                           const void* lcr, void* frontier_out, void* masks,
                                           void* committed, int W, int N, int M, int K, int w,
                                           int gc_depth, void* stream) {
  const int threads = ((M + 31) / 32) * 32;
  reach_shard_step_kernel<<<K, threads, (size_t)N, (cudaStream_t)stream>>>(
      (const uint8_t*)parent, (const uint8_t*)present, (const int32_t*)lc,
      (const uint8_t*)frontier_in, (const int32_t*)offs, (const uint8_t*)onehots,
      (const int32_t*)lcr, (uint8_t*)frontier_out, (bool*)masks, (int32_t*)committed, W, N,
      M, w, gc_depth);
  return (int)cudaGetLastError();
}

extern "C" const char* dag_window_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
