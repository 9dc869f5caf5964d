// The staged per-item ed25519 verify, three kernels for Hopper (sm_90a): the
// stages that the mesh-sharded verifier runs on every shard in place of A1's
// single launch. A3 and A5 run a group of ten lanes a row
// (ed25519_lanes.cuh), A4 a quad of four threads a row (ed25519_straus.cuh,
// ed25519_quad.cuh).
//
// Replaces (narwhal_tpu/tpu/ed25519.py):
//   A3 :485 `verify_decompress_kernel`  y int16 [B, 20], sign int8 [B]
//        -> points int32 [4, 20, B] (X, Y, Z, T), valid bool [B]
//   A4 :496 `verify_straus_kernel`      A points int32 [4, 20, B], k and S
//        digits int8 [B, 64] -> acc int32 [4, 20, B] = [S]B + [k](-A)
//   A5 :527 `verify_verdict_kernel`     acc, R points, r_y, r_sign, a_valid,
//        r_valid -> strict bool [B], cofactored bool [B]
// The plain PyTorch versions are `verify_decompress_plain`,
// `verify_straus_plain` and `verify_verdict_plain` in ../ed25519.py.
//
// Stage boundaries keep the JAX layout: int32 [4, 20, B], radix 2^13,
// limb-major, the batch last. A thread converts a coordinate on load
// (fe_from13_loose, which also takes the plain versions' loose limbs) and on
// store (fe_to13, canonical limbs), so a kernel and its plain version can
// stand in for each other, a warp's loads and stores are coalesced over B,
// and every stage output equals the plain version's as field values mod p.
// A3 writes every row, an invalid encoding too: its coordinates are the
// decompression's arithmetic on that y, as in the plain version, because A6
// sums invalid rows into V as A2 does.
//
// The arithmetic is A1's: A3 is `decompress` (ed25519_field.cuh) split over
// ten lanes, which gives the same canonical limbs, A4 the quad walk of
// ed25519_straus.cuh, and A5 the epilogue's operations split over ten lanes
// with its tests on the gathered canonical values, so A3 -> A4 -> A5 gives
// A1's verdicts bit for bit (chip_smoke.py and tests/test_torch_cuda.py
// check it).
//
// What bounds it on the H100: integer multiplies, as A1. Per row A3 is
// 255 squarings + 20 products (it runs twice, for A and R), A4 1024 + 2111,
// A5 266 + 34 (ed25519.staged_field_ops), at 55 and 100 32-bit
// multiply-adds each. The boundary traffic A1 does not pay, 320 bytes a
// point written and read back per stage, is ~1 MB per 2048-row bucket and
// point set: noise beside ~0.6 G multiply-adds. Each stage is a dependent
// chain a row, and a bucket is few rows for the card (2048, or a shard's
// 1024), so each splits its row over threads:
//   - A3: one thread a row left 32 CTAs at B = 2048 and every operation's
//     products serial; ten lanes split each operation by column, a CTA is
//     one warp (3 rows: 342 CTAs at a shard's 1024 rows, 683 at 2048);
//   - A4: one thread a row ran 47 dependent products a window on 64 warps
//     at B = 2048, its table in local memory; a quad a row runs 12 product
//     rounds a window on 256 warps, the table in shared memory (20 KB a
//     warp of 8 rows), kQuadCta threads a CTA (ed25519_straus.cuh);
//   - A5: one thread a row ran its 266 squarings and 34 products as one
//     dependent chain (248 registers, 16 CTAs at a shard's 1024 rows), the
//     inversion's ~0.1 ms of product latency; ten lanes split each operation
//     by column as A3 does (ed25519_lanes.cuh `verdict_lanes_row`), a CTA
//     one warp of three rows, each lane loading only the two radix-2^13
//     limbs that begin in its column, the cofactored half's 33 operations
//     placed beside the head of the inversion's chain.

#include "ed25519_lanes.cuh"
#include "ed25519_straus.cuh"

#ifdef __CUDACC__
using namespace ed25519_straus;

constexpr int kLaneRows = 3;      // A3 and A5: one warp, three groups of ten lanes

__global__ void __launch_bounds__(32)
decompress_kernel(const int16_t* __restrict__ y, const int8_t* __restrict__ sign,
                  const int32_t* __restrict__ consts13, int32_t* __restrict__ pts,
                  bool* __restrict__ valid, int B) {
  __shared__ Consts s_k;
  for (int t = threadIdx.x; t < 3; t += blockDim.x) load_consts(t, consts13, s_k);
  __syncthreads();
  const int g = threadIdx.x / ed25519_lanes::kLanes, q = threadIdx.x - g * ed25519_lanes::kLanes;
  const int row = blockIdx.x * kLaneRows + g;
  const bool live = g < kLaneRows && row < B;  // lanes 30 and 31 and groups past B run along
  const Consts k = s_k;
  const ed25519_lanes::Lanes10Shfl x{g * ed25519_lanes::kLanes};
  ed25519_lanes::decompress_lanes_row(y, sign, k, pts, valid, B, live ? row : B - 1,
                                      ed25519_lanes::lane_of(q), x, live);
}

// A4: a quad a row, kQuadCta / 4 rows a CTA, their -A tables in dynamic
// shared memory (kQuadCta * 640 bytes). Quads past B run on a copy of row
// B - 1 (their warp's shuffles need them) and store nothing; a warp with no
// row of the batch returns at once.
__global__ void __launch_bounds__(kQuadCta)
straus_kernel(const int32_t* __restrict__ a_pt, const int8_t* __restrict__ k_digits,
              const int8_t* __restrict__ s_digits, const int32_t* __restrict__ bt13,
              const int32_t* __restrict__ consts13, int32_t* __restrict__ acc_pt, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ga s_bt[16];
  __shared__ Consts s_k;
  for (int t = threadIdx.x; t < 19; t += blockDim.x) load_tables(t, bt13, consts13, s_bt, s_k);
  __syncthreads();
  const int l = threadIdx.x & 3, q = threadIdx.x >> 2;
  const int row0 = blockIdx.x * (kQuadCta / 4);
  if (row0 + (q & ~7) >= B) return;
  const int row = row0 + q;
  fe* tab = reinterpret_cast<fe*>(smem) + (size_t)q * kTabFields;
  straus_quad_row(a_pt, k_digits, s_digits, kWindows, s_bt, s_k, tab, acc_pt, B,
                  row < B ? row : B - 1, l, QuadShfl{}, row < B);
}

// A5: a group of ten lanes a row, as A3. Lane q keeps limb q of 2d.
__global__ void __launch_bounds__(32)
verdict_kernel(const int32_t* __restrict__ acc_pt, const int32_t* __restrict__ r_pt,
               const int16_t* __restrict__ r_y, const int8_t* __restrict__ r_sign,
               const bool* __restrict__ a_valid, const bool* __restrict__ r_valid,
               const int32_t* __restrict__ consts13, bool* __restrict__ strict,
               bool* __restrict__ cof, int B) {
  const int g = threadIdx.x / ed25519_lanes::kLanes, q = threadIdx.x - g * ed25519_lanes::kLanes;
  const int row = blockIdx.x * kLaneRows + g;
  const bool live = g < kLaneRows && row < B;  // lanes 30 and 31 and groups past B run along
  fe d2;
  fe_from13(d2, consts13 + 20);
  const ed25519_lanes::Lanes10Shfl x{g * ed25519_lanes::kLanes};
  ed25519_lanes::verdict_lanes_row(acc_pt, r_pt, r_y, r_sign, a_valid, r_valid,
                                   ed25519_lanes::limb(d2, q), strict, cof, B,
                                   live ? row : B - 1, ed25519_lanes::lane_of(q), x, live);
}

extern "C" int ed25519_verify_decompress(const void* y, const void* sign,
                                         const void* consts13, void* pts, void* valid,
                                         int B, void* stream) {
  decompress_kernel<<<(B + kLaneRows - 1) / kLaneRows, 32, 0, (cudaStream_t)stream>>>(
      (const int16_t*)y, (const int8_t*)sign, (const int32_t*)consts13, (int32_t*)pts,
      (bool*)valid, B);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_verify_straus(const void* a_pt, const void* k_digits,
                                     const void* s_digits, const void* bt13,
                                     const void* consts13, void* acc_pt, int B,
                                     void* stream) {
  straus_kernel<<<(B + kQuadCta / 4 - 1) / (kQuadCta / 4), kQuadCta, kQuadSmemBytes,
                  (cudaStream_t)stream>>>(
      (const int32_t*)a_pt, (const int8_t*)k_digits, (const int8_t*)s_digits,
      (const int32_t*)bt13, (const int32_t*)consts13, (int32_t*)acc_pt, B);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_verify_verdict(const void* acc_pt, const void* r_pt, const void* r_y,
                                      const void* r_sign, const void* a_valid,
                                      const void* r_valid, const void* consts13,
                                      void* strict, void* cof, int B, void* stream) {
  verdict_kernel<<<(B + kLaneRows - 1) / kLaneRows, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)acc_pt, (const int32_t*)r_pt, (const int16_t*)r_y,
      (const int8_t*)r_sign, (const bool*)a_valid, (const bool*)r_valid,
      (const int32_t*)consts13, (bool*)strict, (bool*)cof, B);
  return (int)cudaGetLastError();
}

extern "C" const char* ed25519_staged_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif
