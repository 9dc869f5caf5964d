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
//       -> V int32 [4, 20, W]. Its table
//       launch reads the points instead of y and sign; the chain and tree
//       launches are A2's, over one lane set of W. A3 -> A6 (A) and A3 -> A6
//       (R) give A2's V_a and V_r point for point (the same point operations
//       in the same order), invalid rows included.
//   The shard reduce ed25519_msm_shard_reduce, the port's counterpart of the
//       cross-device reduce that XLA inserts after A6 on a mesh
//       (narwhal_tpu/tpu/verifier.py:96-102, out_specs=None): n lane sets
//       [n][4, 20, W], one per shard, summed lane by lane with the complete
//       addition in shard order, one thread per lane. ~9 (n - 1) W products:
//       a few microseconds, bound by its launch.
// Their plain versions are `msm_window_plain` and `msm_shard_reduce_plain`.
//
// Three launches on one stream, each a thread per independent piece of work:
//   1. msm_table_kernel, one thread per point (2B: A then R): decompress,
//      negate, and the 16-entry cached table (identity, P, 2P .. 15P), written
//      to a global scratch table [2B][16] of gc (2.5 KB a point, 10 MB at
//      B = 2048, which stays in the 50 MB L2);
//   2. msm_chain_kernel, one thread per (window lane, chain): lane l < 64 is
//      window l of the A points, lane 64 + w window w of the R points; chain c
//      of C sums the points j = c, c + C, c + 2C, ... in that order with the
//      8-multiply cached add, starting from the identity; threads j < B also
//      AND the two validity bits of row j;
//   3. msm_reduce_kernel, one block per lane: a tree over the C chain sums in
//      shared memory (round r adds chain t + C/2^(r+1) into chain t), then the
//      lane's four coordinates canonicalised to radix 2^13.
// C is the wrapper's `chains` = min(128, B), a power of two dividing B: the
// JAX kernel's `chunk`. With it the chains hold the same points in the same
// order and the tree pairs them as the JAX fixed-width reduction does, so the
// kernel performs the plain version's point operations in the plain version's
// order: its V equals the plain V coordinate by coordinate mod p, even where
// an invalid encoding put a point off the curve (where the addition law is
// not associative and another order would give another sum).
//
// Zero digits select the cached identity (1, 1, 1, 0), so zero rows (the
// verifier's padding) and the group lane's all-zero R slot are inert; they
// are still decompressed and accumulated, as in the JAX kernel.
//
// What bounds it on the H100: integer multiplies. A row (one A and one R
// point) costs 2 decompressions (255 squarings + 20 products each), 2 tables
// (127 products each), 96 cached adds (8 products each) and its share of the
// tree, 9 (C - 1) 96 / B products (ed25519.msm_field_muls_per_signature):
// ~1.4e5 32-bit multiply-adds at 100 per product and 55 per squaring, against
// 132 SMs x 64 INT32 lanes. Its bytes (~180 a row in, 33 KB out) never bound
// it. This first version is one thread per point or per (lane, chain) and
// leaves the card far from full; bucket methods and wgmma are later work.
//
// Bounds: every operand keeps the rule of ed25519_field.cuh (a sum of at most
// 3 tight values). Table entries are pt_cache outputs: Y+X and Y-X are 2
// tight, Z and 2d*T are products (tight); the identity entry is tight. The
// chain accumulator starts at the identity and every pt_add_cached output is
// four products, so it stays tight; inside the add, Y1 -/+ X1 and 2*Z1 are 2
// tight and D -/+ C, B -/+ A are 2 tight. The tree's pt_add takes two such
// accumulators, and its operands are again sums of at most 2 tight values.
// decompress and the table chain are A1's code, whose operands were checked
// there. fe_to13 canonicalises before it repacks, so the output limbs are
// exact. A6's points and the shard reduce's lane sets enter through
// fe_from13_loose, whose outputs are tight, so A6's table and the reduce's
// pt_add see the operands that A2's do.

#include "ed25519_field.cuh"

namespace ed25519_msm {

using namespace ed25519_field;

constexpr int kWa = 64;        // window lanes of the A scalars (256-bit z k)
constexpr int kWr = 32;        // window lanes of the R scalars (128-bit z)
constexpr int kMaxLanes = 64;  // the most window lanes one lane set has
constexpr int kMaxChains = 128;

// The 16 cached multiples (identity, P, 2P .. 15P) of neg = -P to tab[0..15].
HD void msm_table_of(const ge& neg, const Consts& k, gc* tab) {
  fe_one(tab[0].YpX);
  fe_one(tab[0].YmX);
  fe_one(tab[0].Z);
  fe_zero(tab[0].T2d);
  pt_cache(tab[1], neg, k);
  ge cur = neg;
  for (int i = 2; i < 16; i++) {
    pt_add_cached(cur, cur, tab[1]);
    pt_cache(tab[i], cur, k);
  }
}

// A2's stage 1 for point p of 2B (A rows, then R rows): decompress, negate,
// and the table. Returns the point's validity.
template <typename L, typename S>
HD bool msm_point_table(const L* y13, S sign, const Consts& k, gc* tab) {
  fe y;
  fe_from13(y, y13);
  ge P;
  const bool valid = decompress(P, y, (i32)sign, k);
  ge neg;
  pt_neg(neg, P);
  msm_table_of(neg, k, tab);
  return valid;
}

// A6's stage 1 for point j of B: the point as A3 wrote it ([4, 20, B]),
// negated, and its table.
HD void msm_window_table(const i32* pts, int B, int j, const Consts& k, gc* tab) {
  ge P, neg;
  pt_load13(P, pts, B, j);
  pt_neg(neg, P);
  msm_table_of(neg, k, tab);
}

// Stage 2 for window w of a W-lane set and chain c: the chain's sum over
// points c, c + C, ... < B of its digit's entry of table ([B][16]).
template <typename D>
HD void msm_chain_sum(ge& acc, const gc* table, const D* digits, int W, int w, int B, int C,
                      int c) {
  pt_identity(acc);
  for (int j = c; j < B; j += C) {
    const int d = ((i32)digits[(size_t)j * W + w]) & 15;
    pt_add_cached(acc, acc, table[(size_t)j * 16 + d]);
  }
}

// Stage 2 for (lane, chain c) of a launch over two lane sets: lanes
// [0, wa) are the windows of digits_a over table rows [0, B), lanes
// [wa, wa + wr) those of digits_r over rows [B, 2B). A2 has wa = 64,
// wr = 32; A6 one set, wa = W, wr = 0. The set is chosen before the one
// loop, so the chain's point additions are inlined once.
template <typename D>
HD void msm_lane_chain(ge& acc, const gc* table, const D* digits_a, const D* digits_r,
                       int wa, int wr, int B, int C, int lane, int c) {
  const bool is_a = lane < wa;
  msm_chain_sum(acc, table + (is_a ? (size_t)0 : (size_t)B * 16), is_a ? digits_a : digits_r,
                is_a ? wa : wr, is_a ? lane : lane - wa, B, C, c);
}

// Stage 3, one tree round: chain t absorbs chain t + off (t < off).
HD void msm_reduce_step(ge* s, int t, int off, const Consts& k) {
  pt_add(s[t], s[t], s[t + off], k);
}

// Stage 3, the lane's output: coordinate `coord` (0..3 = X, Y, Z, T) of v,
// canonical, into v_a [4, 20, wa] (lane < wa) or v_r [4, 20, wr].
HD void msm_write_lane(const ge& v, int lane, int coord, int wa, int wr, i32* v_a, i32* v_r) {
  const fe& f = coord == 0 ? v.X : coord == 1 ? v.Y : coord == 2 ? v.Z : v.T;
  if (lane < wa) fe_to13(f, v_a + (size_t)coord * 20 * wa + lane, wa);
  else fe_to13(f, v_r + (size_t)coord * 20 * wr + (lane - wa), wr);
}

// The cross-shard reduce for window w: lane set 0 plus sets 1 .. n-1 of
// lanes ([n][4, 20, W]) in that order, with the complete addition.
HD void msm_shard_sum(ge& acc, const i32* lanes, int n, int W, int w, const Consts& k) {
  pt_load13(acc, lanes, W, w);
  for (int s = 1; s < n; s++) {
    ge q;
    pt_load13(q, lanes + (size_t)s * 4 * 20 * W, W, w);
    pt_add(acc, acc, q, k);
  }
}

}  // namespace ed25519_msm

#ifdef __CUDACC__
using namespace ed25519_msm;

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
msm_table_kernel(const int16_t* __restrict__ a_y, const int8_t* __restrict__ a_sign,
                 const int16_t* __restrict__ r_y, const int8_t* __restrict__ r_sign,
                 const int32_t* __restrict__ consts13, gc* __restrict__ table,
                 uint8_t* __restrict__ pvalid, int B) {
  __shared__ Consts s_k;
  for (int i = threadIdx.x; i < 3; i += blockDim.x) load_consts(i, consts13, s_k);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= 2 * B) return;
  const Consts k = s_k;
  const bool v = p < B
      ? msm_point_table(a_y + (size_t)p * 20, a_sign[p], k, table + (size_t)p * 16)
      : msm_point_table(r_y + (size_t)(p - B) * 20, r_sign[p - B], k,
                        table + (size_t)p * 16);
  pvalid[p] = v ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
msm_window_table_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ consts13,
                        gc* __restrict__ table, int B) {
  __shared__ Consts s_k;
  for (int i = threadIdx.x; i < 3; i += blockDim.x) load_consts(i, consts13, s_k);
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  const Consts k = s_k;
  msm_window_table(pts, B, j, k, table + (size_t)j * 16);
}

// The lane counts are template arguments, so A2's launches (<64, 32>) keep
// their compile-time index arithmetic; A6 instantiates <64, 0> and <32, 0>.
// valid may be null (A6 has no validity to combine).
template <int WA, int WR>
__global__ void __launch_bounds__(kThreads)
msm_chain_kernel(const gc* __restrict__ table, const int8_t* __restrict__ digits_a,
                 const int8_t* __restrict__ digits_r, const uint8_t* __restrict__ pvalid,
                 ge* __restrict__ partial, bool* __restrict__ valid, int B, int C) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (valid != nullptr && t < B) valid[t] = pvalid[t] && pvalid[B + t];
  constexpr int lanes = WA + WR;
  if (t >= lanes * C) return;
  const int lane = t % lanes, c = t / lanes;
  ge acc;
  msm_lane_chain(acc, table, digits_a, digits_r, WA, WR, B, C, lane, c);
  partial[(size_t)lane * C + c] = acc;
}

template <int WA, int WR>
__global__ void __launch_bounds__(kMaxChains / 2)
msm_reduce_kernel(const ge* __restrict__ partial, const int32_t* __restrict__ consts13,
                  int32_t* __restrict__ v_a, int32_t* __restrict__ v_r, int C) {
  __shared__ Consts s_k;
  __shared__ ge s[kMaxChains];
  const int lane = blockIdx.x, t = threadIdx.x;
  for (int i = t; i < 3; i += blockDim.x) load_consts(i, consts13, s_k);
  for (int i = t; i < C; i += blockDim.x) s[i] = partial[(size_t)lane * C + i];
  __syncthreads();
  const Consts k = s_k;
  for (int off = C / 2; off > 0; off >>= 1) {
    if (t < off) msm_reduce_step(s, t, off, k);
    __syncthreads();
  }
  for (int coord = t; coord < 4; coord += blockDim.x)
    msm_write_lane(s[0], lane, coord, WA, WR, v_a, v_r);
}

__global__ void __launch_bounds__(kMaxLanes)
msm_shard_reduce_kernel(const int32_t* __restrict__ lanes, const int32_t* __restrict__ consts13,
                        int32_t* __restrict__ v, int n, int W) {
  __shared__ Consts s_k;
  for (int i = threadIdx.x; i < 3; i += blockDim.x) load_consts(i, consts13, s_k);
  __syncthreads();
  const int w = threadIdx.x;
  if (w >= W) return;
  const Consts k = s_k;
  ge acc;
  msm_shard_sum(acc, lanes, n, W, w, k);
  pt_store13(acc, v, W, w);
}

static bool chains_ok(int B, int chains) {
  return chains >= 1 && chains <= kMaxChains && !(chains & (chains - 1)) && B % chains == 0;
}

// The chain and tree launches over a table already built: lanes WA + WR.
template <int WA, int WR>
static int msm_lanes(const gc* table, const int8_t* digits_a, const int8_t* digits_r,
                     const uint8_t* pvalid, ge* partial, bool* valid, int32_t* v_a,
                     int32_t* v_r, const int32_t* consts13, int B, int chains, int work,
                     cudaStream_t s) {
  msm_chain_kernel<WA, WR><<<(work + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      table, digits_a, digits_r, pvalid, partial, valid, B, chains);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = chains / 2 > 0 ? chains / 2 : 1;
  msm_reduce_kernel<WA, WR><<<WA + WR, threads, 0, s>>>(partial, consts13, v_a, v_r, chains);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_msm_accumulate(const void* a_y, const void* a_sign, const void* r_y,
                                      const void* r_sign, const void* ak_digits,
                                      const void* z_digits, const void* consts13,
                                      void* table, void* pvalid, void* partial, void* v_a,
                                      void* v_r, void* valid, int B, int chains,
                                      void* stream) {
  if (!chains_ok(B, chains)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int points = 2 * B;
  msm_table_kernel<<<(points + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const int16_t*)a_y, (const int8_t*)a_sign, (const int16_t*)r_y,
      (const int8_t*)r_sign, (const int32_t*)consts13, (gc*)table, (uint8_t*)pvalid, B);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int work = (kWa + kWr) * chains > B ? (kWa + kWr) * chains : B;
  return msm_lanes<kWa, kWr>((const gc*)table, (const int8_t*)ak_digits,
                             (const int8_t*)z_digits, (const uint8_t*)pvalid, (ge*)partial,
                             (bool*)valid, (int32_t*)v_a, (int32_t*)v_r,
                             (const int32_t*)consts13, B, chains, work, s);
}

extern "C" int ed25519_msm_window(const void* pts, const void* digits, const void* consts13,
                                  void* table, void* partial, void* v, int B, int W,
                                  int chains, void* stream) {
  if (!chains_ok(B, chains) || (W != kWa && W != kWr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  msm_window_table_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const int32_t*)pts, (const int32_t*)consts13, (gc*)table, B);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const gc* t = (const gc*)table;
  const int8_t* d = (const int8_t*)digits;
  if (W == kWa)
    return msm_lanes<kWa, 0>(t, d, nullptr, nullptr, (ge*)partial, nullptr, (int32_t*)v,
                             nullptr, (const int32_t*)consts13, B, chains, kWa * chains, s);
  return msm_lanes<kWr, 0>(t, d, nullptr, nullptr, (ge*)partial, nullptr, (int32_t*)v,
                           nullptr, (const int32_t*)consts13, B, chains, kWr * chains, s);
}

extern "C" int ed25519_msm_shard_reduce(const void* lanes, const void* consts13, void* v, int n,
                                        int W, void* stream) {
  if (n < 1 || W < 1 || W > kMaxLanes) return (int)cudaErrorInvalidValue;
  msm_shard_reduce_kernel<<<1, kMaxLanes, 0, (cudaStream_t)stream>>>(
      (const int32_t*)lanes, (const int32_t*)consts13, (int32_t*)v, n, W);
  return (int)cudaGetLastError();
}

extern "C" const char* ed25519_msm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif
