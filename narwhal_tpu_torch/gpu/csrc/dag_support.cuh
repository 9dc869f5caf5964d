#pragma once

// The leader support of the consensus step (B5, leader_support_kernel in
// dag_window.cu): a warp a walk, each lane a share of the N voters.
//
// For walk b: out[b] = the int32-wrapping sum of stakes[a] over the voters
// a with parent[offs[b], a, leaders[b]] and present[offs[b], a] set;
// parent [W, N, M] (M = N, or a shard's link columns), present [W, N].
// A walk whose offset lies outside [0, W) or whose leader lies outside
// [0, M) reads nothing, writes 0 and is reported in its CTA's error word
// {walk, offset, leader} (the CTA's lowest such walk), so the wrapper
// raises after the launch instead of checking the indices before it.
//
// The data is a few KB, so the launch and the chain of dependent global
// reads are the cost. A lane issues every load that waits on no index at
// once (the walk's offset and leader and its first kPerLane stakes), then
// the link and present bytes of its voters in one second round, the range
// test between the two.
//
// The functions are LS_HD (host and device under nvcc, plain inline C++
// otherwise) and leave the warp's sum and the CTA's error word to the
// caller, so a host compiler can run a launch lane by lane and hold it
// against the plain version.

#include <climits>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LS_HD __host__ __device__ __forceinline__
#else
#define LS_HD inline
#endif

namespace support {

constexpr int kWarps = 16;           // walks a CTA: B = 64 is one wave of 4 CTAs
constexpr int kPerLane = 4;          // voters a lane loads at once
constexpr int kSpan = 32 * kPerLane;  // voters a warp loads at once
constexpr int32_t kNoWalk = INT_MAX;  // an error word's walk when every walk is in range

// The CTAs of a launch over B walks.
LS_HD int ctas_for(int B) { return (B + kWarps - 1) / kWarps; }

// Whether walk b's offset and leader index lie in the window and the link
// columns.
LS_HD bool in_range(int32_t off, int32_t leader, int W, int M) {
  return off >= 0 && off < W && leader >= 0 && leader < M;
}

// Lane `lane`'s share of walk b's support (unsigned: the sum wraps as
// int32), 0 when the walk is out of range; *off, *leader get the walk's
// indices and *ok the range test.
LS_HD uint32_t lane_part(const uint8_t* parent, const uint8_t* present, const int32_t* stakes,
                         const int32_t* offs, const int32_t* leaders, int b, int W, int N, int M,
                         int lane, int32_t* off, int32_t* leader, bool* ok) {
  const int32_t o = offs[b], l = leaders[b];
  int32_t st[kPerLane];
#pragma unroll
  for (int u = 0; u < kPerLane; u++) {
    const int a = lane + 32 * u;
    st[u] = a < N ? stakes[a] : 0;
  }
  *off = o;
  *leader = l;
  *ok = in_range(o, l, W, M);
  if (!*ok) return 0u;
  const uint8_t* links = parent + (size_t)o * N * M + l;  // column l of row o
  const uint8_t* pres = present + (size_t)o * N;
  uint32_t sum = 0;
  for (int a0 = 0; a0 < N; a0 += kSpan) {
    if (a0 > 0) {
#pragma unroll
      for (int u = 0; u < kPerLane; u++) {
        const int a = a0 + lane + 32 * u;
        st[u] = a < N ? stakes[a] : 0;
      }
    }
    uint8_t lk[kPerLane], pr[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; u++) {
      const int a = a0 + lane + 32 * u;
      lk[u] = a < N ? links[(size_t)a * M] : 0;
      pr[u] = a < N ? pres[a] : 0;
    }
#pragma unroll
    for (int u = 0; u < kPerLane; u++) {
      if (lk[u] && pr[u]) sum += (uint32_t)st[u];
    }
  }
  return sum;
}

}  // namespace support
