// Batched ed25519 verification, a quad of threads per signature, for Hopper
// (sm_90a).
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
// is never the limit. But a signature is one dependent chain, and a bucket
// of 2048 is few of them for the card, so the design cuts the chain's depth:
//   - radix 2^25.5 (ref10's layout: 10 signed limbs alternating 26 and 25 bits,
//     limb i at bit ceil(25.5 i)) so one field product is 100 native
//     32x32->64 multiply-adds into int64 columns instead of the TPU kernel's
//     400 13-bit products;
//   - a quad of four threads per signature (ed25519_quad.cuh): threads 0 and
//     1 decompress A and R at once (2 and 3 run along on copies), the quad
//     then runs the Straus walk, 12 product rounds a window against 47
//     dependent products on one thread, and the verdict's cofactored half;
//     every thread runs the strict half's inversion in step;
//   - the 16-entry cached -A table of each signature (2.5 KB) lives in
//     shared memory, each thread owning one field of every entry, so the
//     data-dependent reads stay on chip and no barrier guards them;
//   - the fixed-base table _BT and the curve constants arrive in the JAX
//     radix-2^13 layout and are repacked once per block into shared memory, so
//     lanes of a warp reading different digits hit shared memory, not the
//     serialising constant cache;
//   - a batch of 2048 is 256 warps of 8 signatures, kQuadCta threads a CTA.
//
// The field and point layer, with its bound argument, is ed25519_field.cuh,
// the quad operations ed25519_quad.cuh; the walk and the verdict, shared
// with A4 and A5, are ed25519_straus.cuh.

#include "ed25519_straus.cuh"

#ifdef __CUDACC__
using namespace ed25519_straus;

// A quad a signature, kQuadCta / 4 signatures a CTA, their -A tables in
// dynamic shared memory. Quads past B run on a copy of row B - 1 (their
// warp's shuffles need them) and store nothing; a warp with no row of the
// batch returns at once.
__global__ void __launch_bounds__(kQuadCta)
verify_kernel(const int16_t* __restrict__ a_y, const int8_t* __restrict__ a_sign,
              const int16_t* __restrict__ r_y, const int8_t* __restrict__ r_sign,
              const int8_t* __restrict__ k_digits, const int8_t* __restrict__ s_digits,
              const int32_t* __restrict__ bt13, const int32_t* __restrict__ consts13,
              bool* __restrict__ out_strict, bool* __restrict__ out_cof, int B) {
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
  verify_quad_row(a_y, a_sign, r_y, r_sign, k_digits, s_digits, s_bt, s_k, tab, out_strict,
                  out_cof, row < B ? row : B - 1, l, QuadShfl{}, row < B);
}

extern "C" int ed25519_verify_batch(const void* a_y, const void* a_sign, const void* r_y,
                                    const void* r_sign, const void* k_digits,
                                    const void* s_digits, const void* bt13,
                                    const void* consts13, void* out_strict, void* out_cof,
                                    int B, void* stream) {
  verify_kernel<<<(B + kQuadCta / 4 - 1) / (kQuadCta / 4), kQuadCta, kQuadSmemBytes,
                  (cudaStream_t)stream>>>(
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
