// The staged per-item ed25519 verify, three kernels for Hopper (sm_90a), one
// row per thread: the stages that the mesh-sharded verifier runs on every
// shard in place of A1's single launch.
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
// limb-major, the batch last. A thread converts its point on load
// (fe_from13_loose, which also takes the plain versions' loose limbs) and on
// store (fe_to13, canonical limbs), so a kernel and its plain version can
// stand in for each other, a warp's loads and stores are coalesced over B,
// and every stage output equals the plain version's as field values mod p.
// A3 writes every row, an invalid encoding too: its coordinates are the
// decompression's arithmetic on that y, as in the plain version, because A6
// sums invalid rows into V as A2 does.
//
// The arithmetic is A1's: A3 is `decompress` (ed25519_field.cuh), A4 the
// walk and A5 the epilogue of ed25519_straus.cuh, so A3 -> A4 -> A5 gives
// A1's verdicts bit for bit (chip_smoke.py and tests/test_torch_cuda.py
// check it).
//
// What bounds it on the H100: integer multiplies, as A1. Per row A3 is
// 255 squarings + 20 products (it runs twice, for A and R), A4 1024 + 2111,
// A5 266 + 34 (ed25519.staged_field_ops), at 55 and 100 32-bit
// multiply-adds each. The boundary traffic A1 does not pay, 320 bytes a
// point written and read back per stage, is ~1 MB per 2048-row bucket and
// point set: noise beside ~0.6 G multiply-adds. A4 keeps A1's per-thread
// 16-entry table (2.5 KB, local memory) and 32 threads a block; A3 and A5
// hold no table and run 64 a block.

#include "ed25519_straus.cuh"

namespace ed25519_staged {

using namespace ed25519_straus;

// A3 for row b.
template <typename L, typename S>
HD void decompress_row(const L* y, const S* sign, const Consts& k, i32* pts, bool* valid,
                       int B, int b) {
  fe yf;
  fe_from13(yf, y + (size_t)b * 20);
  ge P;
  const bool v = decompress(P, yf, (i32)sign[b], k);
  pt_store13(P, pts, B, b);
  valid[b] = v;
}

// A4 for row b; tab is the thread's table.
template <typename D>
HD void straus_row(const i32* a_pt, const D* k_digits, const D* s_digits, const ga* bt,
                   const Consts& k, gc* tab, i32* acc_pt, int B, int b) {
  ge A, acc;
  pt_load13(A, a_pt, B, b);
  straus_walk(acc, A, k_digits + (size_t)b * 64, s_digits + (size_t)b * 64, bt, k, tab);
  pt_store13(acc, acc_pt, B, b);
}

// A5 for row b.
template <typename L, typename S>
HD void verdict_row(const i32* acc_pt, const i32* r_pt, const L* r_y, const S* r_sign,
                    const bool* a_valid, const bool* r_valid, const Consts& k,
                    bool* strict, bool* cof, int B, int b) {
  ge acc, R;
  pt_load13(acc, acc_pt, B, b);
  pt_load13(R, r_pt, B, b);
  fe ry;
  fe_from13(ry, r_y + (size_t)b * 20);
  bool s, c;
  straus_verdict(acc, R, ry, (i32)r_sign[b], a_valid[b], r_valid[b], k, s, c);
  strict[b] = s;
  cof[b] = c;
}

}  // namespace ed25519_staged

#ifdef __CUDACC__
using namespace ed25519_staged;

constexpr int kThreads = 64;
constexpr int kStrausThreads = 32;

__global__ void __launch_bounds__(kThreads)
decompress_kernel(const int16_t* __restrict__ y, const int8_t* __restrict__ sign,
                  const int32_t* __restrict__ consts13, int32_t* __restrict__ pts,
                  bool* __restrict__ valid, int B) {
  __shared__ Consts s_k;
  for (int t = threadIdx.x; t < 3; t += blockDim.x) load_consts(t, consts13, s_k);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Consts k = s_k;
  decompress_row(y, sign, k, pts, valid, B, b);
}

__global__ void __launch_bounds__(kStrausThreads)
straus_kernel(const int32_t* __restrict__ a_pt, const int8_t* __restrict__ k_digits,
              const int8_t* __restrict__ s_digits, const int32_t* __restrict__ bt13,
              const int32_t* __restrict__ consts13, int32_t* __restrict__ acc_pt, int B) {
  __shared__ ga s_bt[16];
  __shared__ Consts s_k;
  for (int t = threadIdx.x; t < 19; t += blockDim.x) load_tables(t, bt13, consts13, s_bt, s_k);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Consts k = s_k;
  gc tab[16];
  straus_row(a_pt, k_digits, s_digits, s_bt, k, tab, acc_pt, B, b);
}

__global__ void __launch_bounds__(kThreads)
verdict_kernel(const int32_t* __restrict__ acc_pt, const int32_t* __restrict__ r_pt,
               const int16_t* __restrict__ r_y, const int8_t* __restrict__ r_sign,
               const bool* __restrict__ a_valid, const bool* __restrict__ r_valid,
               const int32_t* __restrict__ consts13, bool* __restrict__ strict,
               bool* __restrict__ cof, int B) {
  __shared__ Consts s_k;
  for (int t = threadIdx.x; t < 3; t += blockDim.x) load_consts(t, consts13, s_k);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Consts k = s_k;
  verdict_row(acc_pt, r_pt, r_y, r_sign, a_valid, r_valid, k, strict, cof, B, b);
}

extern "C" int ed25519_verify_decompress(const void* y, const void* sign,
                                         const void* consts13, void* pts, void* valid,
                                         int B, void* stream) {
  decompress_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)y, (const int8_t*)sign, (const int32_t*)consts13, (int32_t*)pts,
      (bool*)valid, B);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_verify_straus(const void* a_pt, const void* k_digits,
                                     const void* s_digits, const void* bt13,
                                     const void* consts13, void* acc_pt, int B,
                                     void* stream) {
  straus_kernel<<<(B + kStrausThreads - 1) / kStrausThreads, kStrausThreads, 0,
                  (cudaStream_t)stream>>>(
      (const int32_t*)a_pt, (const int8_t*)k_digits, (const int8_t*)s_digits,
      (const int32_t*)bt13, (const int32_t*)consts13, (int32_t*)acc_pt, B);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_verify_verdict(const void* acc_pt, const void* r_pt, const void* r_y,
                                      const void* r_sign, const void* a_valid,
                                      const void* r_valid, const void* consts13,
                                      void* strict, void* cof, int B, void* stream) {
  verdict_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)acc_pt, (const int32_t*)r_pt, (const int16_t*)r_y,
      (const int8_t*)r_sign, (const bool*)a_valid, (const bool*)r_valid,
      (const int32_t*)consts13, (bool*)strict, (bool*)cof, B);
  return (int)cudaGetLastError();
}

extern "C" const char* ed25519_staged_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif
