// Latency and throughput of the field products of ed25519_field.cuh on one
// card, against the forms they replaced: a design measurement, not a kernel
// of the port.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o field_bench narwhal_tpu_torch/gpu/csrc/bench/field_bench.cu && ./field_bench
//
// Each variant runs 2048 dependent products (a <- a * b, or a <- a^2) per
// thread: one warp alone (cycles an operation by clock64: the latency a
// dependent chain pays) and 132 x 8 blocks of 256 threads (operations a
// second: the card's rate). Variants:
//   fe_mul / fe_sq           the layer's (fe_mac: a low/high pair of 32-bit
//                            multiply-adds joined by the carry flag);
//   C++ form                 the same sums as `acc += (i64)a * (i64)b`;
//   parallel carry           the C++ form with two rounds of carries over all
//                            ten columns at once in place of ref10's chain.
// Every variant's canonical results must equal fe_mul's / fe_sq's.
#include "../ed25519_field.cuh"
#include <cstdio>
using namespace ed25519_field;

HD void reduce_parallel(i64 h[10], fe& r) {
#pragma unroll
  for (int round = 0; round < 2; round++) {
    i64 c[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
      const int s = (i & 1) ? 25 : 26;
      c[i] = (h[i] + ((i64)1 << (s - 1))) >> s;
      h[i] -= c[i] * ((i64)1 << s);
    }
#pragma unroll
    for (int i = 0; i < 10; i++) h[(i + 1) % 10] += i == 9 ? 19 * c[9] : c[i];
  }
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (i32)h[i];
}

template <bool kParallel>
HD void mul_cpp(fe& r, const fe& f, const fe& g) {
  i32 g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    g19[i] = 19 * g.v[i];
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  }
  i64 h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++)
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const i32 fi = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      h[(i + j) % 10] += (i64)fi * (i64)(i + j < 10 ? g.v[j] : g19[j]);
    }
  if (kParallel) reduce_parallel(h, r);
  else fe_reduce64(h, r);
}

HD void sq_cpp(fe& r, const fe& f) {
  i32 f2[10], f19[10], f38[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    f19[i] = 19 * f.v[i];
    f38[i] = (i & 1) ? 38 * f.v[i] : 0;
  }
  i64 h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++)
#pragma unroll
    for (int j = i; j < 10; j++) {
      const bool odd = (i & 1) && (j & 1), wrap = i + j >= 10;
      const i32 left = i < j ? f2[i] : f.v[i];
      const i32 right = odd ? (wrap ? f38[j] : f2[j]) : (wrap ? f19[j] : f.v[j]);
      h[(i + j) % 10] += (i64)left * (i64)right;
    }
  fe_reduce64(h, r);
}

constexpr int kVariants = 5;
const char* kNames[kVariants] = {"fe_mul", "fe_mul, C++ form", "fe_mul, parallel carry", "fe_sq",
                                 "fe_sq, C++ form"};

template <int V>
__global__ void chain(fe* io, int n, long long* cycles) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  fe a = io[t];
  const fe b = io[t];
  const long long t0 = clock64();
  for (int i = 0; i < n; i++) {
    if (V == 0) fe_mul(a, a, b);
    if (V == 1) mul_cpp<false>(a, a, b);
    if (V == 2) mul_cpp<true>(a, a, b);
    if (V == 3) fe_sq(a, a);
    if (V == 4) sq_cpp(a, a);
  }
  const long long t1 = clock64();
  fe c;
  fe_canonical(c, a);
  io[t] = c;
  if (t == 0) *cycles = t1 - t0;
}

int main() {
  const int n = 2048, wide_blocks = 132 * 8, threads = 256, nt = wide_blocks * threads;
  void (*kernels[kVariants])(fe*, int, long long*) = {chain<0>, chain<1>, chain<2>, chain<3>,
                                                      chain<4>};
  fe *io, *in = new fe[nt], *out[kVariants];
  long long* cycles;
  cudaMalloc(&io, nt * sizeof(fe));
  cudaMalloc(&cycles, sizeof(long long));
  for (int i = 0; i < nt; i++)  // tight limbs
    for (int l = 0; l < 10; l++) {
      const unsigned half = (l & 1) ? 1u << 24 : 1u << 25;
      in[i].v[l] = (i32)((i * 2654435761u + l * 40503u) % (2 * half)) - (i32)half;
    }
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int v = 0; v < kVariants; v++) {
    out[v] = new fe[nt];
    for (int wide = 0; wide < 2; wide++) {
      const int blocks = wide ? wide_blocks : 1, tpb = wide ? threads : 32;
      cudaMemcpy(io, in, nt * sizeof(fe), cudaMemcpyHostToDevice);
      kernels[v]<<<blocks, tpb>>>(io, 16, cycles);  // warm up
      cudaMemcpy(io, in, nt * sizeof(fe), cudaMemcpyHostToDevice);
      cudaEventRecord(e0);
      kernels[v]<<<blocks, tpb>>>(io, n, cycles);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      long long c;
      cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
      if (!wide)
        printf("%-24s one warp: %lld cycles an operation\n", kNames[v], c / n);
      else {
        printf("%-24s %d threads: %.1f G operations/s\n", kNames[v], nt,
               (double)nt * n / ms / 1e6);
        cudaMemcpy(out[v], io, nt * sizeof(fe), cudaMemcpyDeviceToHost);
      }
    }
  }
  int bad = 0;
  for (int v = 0; v < kVariants; v++)
    for (int i = 0; i < nt; i++)
      for (int l = 0; l < 10; l++) bad += out[v][i].v[l] != out[v < 3 ? 0 : 3][i].v[l];
  const cudaError_t err = cudaGetLastError();
  printf("results: %d limbs differ from fe_mul / fe_sq; %s\n", bad, cudaGetErrorString(err));
  return bad != 0 || err != cudaSuccess;
}
