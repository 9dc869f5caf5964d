// Batched ed25519 verification, one signature per thread, for Hopper (sm_90a).
//
// Replaces: narwhal_tpu/tpu/ed25519.py:395 `verify_batch_kernel` (TPU kernel
// A1). Same inputs (the JAX host layout: int16 radix-2^13 limbs [B, 20], int8
// signs [B], int8 4-bit digits [B, 64] MSB first) and the same two verdicts
// per signature:
//   strict     encode([S]B + [k](-A)) == R             (the host library's rule)
//   cofactored [8]([S]B + [k](-A) - R) == identity      (RFC 8032 batch rule)
// both masked by the validity of A's decompression (and R's, for the second).
// The plain PyTorch version is `verify_batch_plain` in ../ed25519.py.
//
// What bounds it on the H100: integer multiplies. One signature is ~1800
// field squarings and ~2200 field multiplications (ed25519.field_muls_per_
// signature), each 55 or 100 32x32->64-bit products here: ~3.2e5 products,
// against 64 INT32 lanes per SM. The bytes are ~210 per signature, so memory
// is never the limit. Design, for correctness first:
//   - one thread owns one signature end to end; the accumulator point lives in
//     registers, so no state crosses threads and no synchronisation is needed
//     after the table load;
//   - radix 2^25.5 (ref10's layout: 10 signed limbs alternating 26 and 25 bits,
//     limb i at bit ceil(25.5 i)) so one field product is 100 native
//     32x32->64 multiply-adds into int64 columns instead of the TPU kernel's
//     400 13-bit products;
//   - the 16-entry cached -A table (16 x 4 x 10 int32 = 2.5 KB per thread) is
//     indexed by a data-dependent digit, so it lives in local memory (L1/L2);
//     the spill is accepted in this version;
//   - the fixed-base table _BT and the curve constants arrive in the JAX
//     radix-2^13 layout and are repacked once per block into shared memory, so
//     lanes of a warp reading different digits hit shared memory, not the
//     serialising constant cache;
//   - a batch of 2048 is only 64 warps: at one signature per thread the card
//     is far from full (see PERF.md). Splitting a signature over several lanes
//     is the next step for speed, not for this version.
//
// The field and point layer, with its bound argument, is ed25519_field.cuh;
// the walk and the epilogue, shared with A4 and A5, are ed25519_straus.cuh.

#include "ed25519_straus.cuh"

namespace ed25519_verify {

using namespace ed25519_straus;

// The whole per-signature check.  tab: this thread's 16-entry -A table
// (local memory); bt: the fixed-base table; k: the curve constants. The walk
// and the epilogue are ed25519_straus.cuh's, shared with A4 and A5.
template <typename L, typename S, typename D>
HD void verify_one(const L* a_y, S a_sign, const L* r_y, S r_sign,
                   const D* k_digits, const D* s_digits, const ga* bt,
                   const Consts& k, gc* tab, bool& strict, bool& cof) {
  fe ay, ry;
  fe_from13(ay, a_y);
  fe_from13(ry, r_y);
  const i32 as = (i32)a_sign, rs = (i32)r_sign;

  ge A, acc, R;
  const bool valid = decompress(A, ay, as, k);
  straus_walk(acc, A, k_digits, s_digits, bt, k, tab);
  const bool r_valid = decompress(R, ry, rs, k);
  straus_verdict(acc, R, ry, rs, valid, r_valid, k, strict, cof);
}

}  // namespace ed25519_verify

#ifdef __CUDACC__
using namespace ed25519_verify;

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
verify_kernel(const int16_t* __restrict__ a_y, const int8_t* __restrict__ a_sign,
              const int16_t* __restrict__ r_y, const int8_t* __restrict__ r_sign,
              const int8_t* __restrict__ k_digits, const int8_t* __restrict__ s_digits,
              const int32_t* __restrict__ bt13, const int32_t* __restrict__ consts13,
              bool* __restrict__ out_strict, bool* __restrict__ out_cof, int B) {
  __shared__ ga s_bt[16];
  __shared__ Consts s_k;
  for (int t = threadIdx.x; t < 19; t += blockDim.x) load_tables(t, bt13, consts13, s_bt, s_k);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Consts k = s_k;
  gc tab[16];
  bool strict, cof;
  verify_one(a_y + (size_t)b * 20, a_sign[b], r_y + (size_t)b * 20, r_sign[b],
             k_digits + (size_t)b * 64, s_digits + (size_t)b * 64, s_bt, k, tab,
             strict, cof);
  out_strict[b] = strict;
  out_cof[b] = cof;
}

extern "C" int ed25519_verify_batch(const void* a_y, const void* a_sign, const void* r_y,
                                    const void* r_sign, const void* k_digits,
                                    const void* s_digits, const void* bt13,
                                    const void* consts13, void* out_strict, void* out_cof,
                                    int B, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)a_y, (const int8_t*)a_sign, (const int16_t*)r_y,
      (const int8_t*)r_sign, (const int8_t*)k_digits, (const int8_t*)s_digits,
      (const int32_t*)bt13, (const int32_t*)consts13, (bool*)out_strict,
      (bool*)out_cof, B);
  return (int)cudaGetLastError();
}

extern "C" const char* ed25519_verify_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif
