"""The redesigned kernels' own arithmetic, compiled for the host: B2, B6,
A3, A5, B3 and B4, and B7.

The kernels' device code is written as host-and-device functions
(`csrc/dag_walk_bits.cuh`, `csrc/ed25519_lanes.cuh`,
`csrc/dag_window_sync.cuh`, `csrc/dag_commit.cuh`) with the warp's or the
CTA's collectives behind a small interface, so g++ builds the same code
for the CPU and runs it a lane or a thread at a time (each test skips only
when g++ is missing):

- A3, the ten-lane decompression (`decompress_lanes_row`: ten fibers of
  one thread for the ten lanes of a group), over chip_smoke's A3 rows (the
  edge encodings y = 0, 1, p - 1 and the non-canonical p, p + 3 and
  2^255 - 1 with both signs, points with either sign, random y), held mod
  p against `verify_decompress_plain` and the JAX
  `verify_decompress_kernel` run eagerly, and limb for limb against the
  one-thread `decompress`;
- A5, the ten-lane verdicts (`verdict_lanes_row`, the same ten fibers),
  bit for bit against `verify_verdict_plain` and the JAX
  `verify_verdict_kernel` run eagerly (torsion, forged, invalid-A,
  invalid-R and random-limb rows, loose limbs), and `linvert` mod p
  against the one-thread `fe_invert`;
- B7, the commit mask (`dag_commit.cuh`): the launch run CTA by CTA and
  phase by phase, held bit for bit against `consensus_commit_plain`;
- B5, the leader support (`dag_support.cuh`): every lane of every walk's
  warp and each CTA's error word as `leader_support_kernel` writes them,
  held bit for bit against `leader_support_plain` on the in-range walks,
  0 on the out-of-range ones, and the words read as the wrapper reads
  them against the lowest out-of-range walk (walk, offset, leader);
- B3 and B4, the window sync (`csrc/dag_window_sync.cuh`): its parameter
  block filled as the C entry fills it, and its grid run CTA by CTA, every
  thread's copy then every thread's placements (the kernel's one barrier),
  held bit for bit against `sync_window_plain` and the JAX `roll_window`
  then `place_batch`, every output byte checked written;
- B2, the packed-bit walk: the bit packing (every byte value at every
  position), the row reads at every bit offset, the walk of a warp
  (`column_table`, `walk_leader`: 32 threads for the 32 lanes) over the
  packed strings, and the wide walk (`wide_walk`, N > 64 or a window past
  shared memory: 32 * ceil(N / 32) threads for the CTA), held bit for bit
  against the JAX `chain_commit` and `chain_commit_plain` at chip_smoke's
  B2 shapes, at small W.

The kernels themselves run on the card in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from narwhal_tpu.tpu import dag_kernels as jd
from narwhal_tpu.tpu import ed25519 as jk
from narwhal_tpu_torch.gpu import dag_kernels as td
from narwhal_tpu_torch.gpu import ed25519 as tk

CSRC = Path(td.__file__).resolve().parent / "csrc"

LANES_HARNESS = r"""
#include <ucontext.h>

#include <cstdio>
#include <functional>
#include <vector>
#include "ed25519_lanes.cuh"
using namespace ed25519_lanes;

// The group's ten lanes as ten fibers of one thread (ucontext), switched in
// turn: a shuffle writes the lane's value and passes to the next lane; when
// the lane runs again every lane has written (all take the same shuffles,
// as a warp's lanes do), so it reads, and passes again before any lane
// writes anew. One thread: no lane waits on the OS scheduler, however
// loaded the machine.
struct Group {
  ucontext_t main, ctx[kLanes];
  std::vector<char> stack[kLanes];
  int cur = 0, left = kLanes;
  i64 slot[kLanes];
  std::function<void(int)> body;
  void pass() {
    const int q = cur;
    cur = (cur + 1) % kLanes;
    swapcontext(&ctx[q], &ctx[cur]);
  }
};
Group* g_group;

void lane_entry(int q) {
  g_group->body(q);
  if (--g_group->left > 0) {
    for (;;) g_group->pass();  // finished: pass until the last lane is done
  }
  swapcontext(&g_group->ctx[q], &g_group->main);
}

// Run body(q) for the ten lanes q of `g`, to the end of every lane.
void run_lanes(Group& g, std::function<void(int)> body) {
  g_group = &g;
  g.body = std::move(body);
  g.cur = 0;
  g.left = kLanes;
  for (int q = 0; q < kLanes; q++) {
    g.stack[q].assign(1 << 20, 0);
    getcontext(&g.ctx[q]);
    g.ctx[q].uc_stack.ss_sp = g.stack[q].data();
    g.ctx[q].uc_stack.ss_size = g.stack[q].size();
    g.ctx[q].uc_link = nullptr;
    makecontext(&g.ctx[q], (void (*)())lane_entry, 1, q);
  }
  swapcontext(&g.main, &g.ctx[0]);
}

struct FiberShfl {
  int q;
  Group* g;
  i64 x(i64 v, int src) const {
    g->slot[q] = v;
    g->pass();
    const i64 r = g->slot[src];
    g->pass();
    return r;
  }
  i32 shfl(i32 v, int src) const { return (i32)x(v, src); }
  i64 shfl(i64 v, int src) const { return x(v, src); }
};

template <class T>
bool read(FILE* in, std::vector<T>& v, size_t n) {
  v.resize(n);
  return std::fread(v.data(), sizeof(T), n, in) == n;
}
"""

LANES_MAIN = LANES_HARNESS + r"""
// in: B, y int16 [B, 20], sign int8 [B], consts int32 [3, 20]
// out: points int32 [4, 20, B], valid uint8 [B]; every row held limb for
// limb to the one-thread `decompress`.
int main(int argc, char** argv) {
  FILE* in = std::fopen(argv[1], "rb");
  int B = 0;
  if (std::fread(&B, 4, 1, in) != 1) return 2;
  std::vector<int16_t> y((size_t)B * 20);
  std::vector<int8_t> sign(B);
  std::vector<int32_t> c13(60);
  if (std::fread(y.data(), 2, y.size(), in) != y.size() ||
      std::fread(sign.data(), 1, sign.size(), in) != sign.size() ||
      std::fread(c13.data(), 4, 60, in) != 60) return 2;
  std::fclose(in);
  Consts k;
  for (int t = 0; t < 3; t++) load_consts(t, c13.data(), k);
  std::vector<int32_t> pts((size_t)4 * 20 * B, -1);
  bool* valid = new bool[B];
  Group grp;
  run_lanes(grp, [&](int q) {
    for (int b = 0; b < B; b++) {
      decompress_lanes_row(y.data(), sign.data(), k, pts.data(), valid, B, b, lane_of(q),
                           FiberShfl{q, &grp});
    }
  });
  for (int b = 0; b < B; b++) {
    fe yf;
    fe_from13(yf, y.data() + (size_t)b * 20);
    ge P;
    const bool v = decompress(P, yf, (i32)sign[b], k);
    std::vector<int32_t> one(80);
    pt_store13(P, one.data(), 1, 0);
    for (int i = 0; i < 80; i++) {
      if (one[i] != pts[(size_t)i * B + b]) return 3;
    }
    if (v != valid[b]) return 4;
  }
  std::FILE* out = std::fopen(argv[2], "wb");
  std::fwrite(pts.data(), 4, pts.size(), out);
  for (int b = 0; b < B; b++) std::fputc(valid[b] ? 1 : 0, out);
  std::fclose(out);
  delete[] valid;
  return 0;
}
"""

VERDICT_MAIN = LANES_HARNESS + r"""
// in: B, acc and R int32 [4, 20, B] (the stage layout), r_y int16 [B, 20],
// r_sign int8 [B], a_valid and r_valid uint8 [B], consts int32 [3, 20], n,
// z int32 [n, 20] (radix-2^13 limbs)
// out: strict and cofactored uint8 [B] from verdict_lanes_row, a group of
// ten lanes a row; exits 3 when linvert of a z differs mod p from the
// one-thread fe_invert.
int main(int argc, char** argv) {
  FILE* in = std::fopen(argv[1], "rb");
  int B = 0, n = 0;
  std::vector<int32_t> acc, r, c13, z;
  std::vector<int16_t> ry;
  std::vector<int8_t> rs;
  std::vector<uint8_t> av, rv;
  if (std::fread(&B, 4, 1, in) != 1 || !read(in, acc, (size_t)80 * B) ||
      !read(in, r, (size_t)80 * B) || !read(in, ry, (size_t)20 * B) || !read(in, rs, B) ||
      !read(in, av, B) || !read(in, rv, B) || !read(in, c13, 60) ||
      std::fread(&n, 4, 1, in) != 1 || !read(in, z, (size_t)20 * n)) return 2;
  std::fclose(in);
  Consts k;
  for (int t = 0; t < 3; t++) load_consts(t, c13.data(), k);
  bool* a_valid = new bool[B];
  bool* r_valid = new bool[B];
  bool* strict = new bool[B];
  bool* cof = new bool[B];
  for (int b = 0; b < B; b++) {
    a_valid[b] = av[b] != 0;
    r_valid[b] = rv[b] != 0;
  }
  std::vector<int32_t> inv((size_t)10 * n);
  Group grp;
  run_lanes(grp, [&](int q) {
    const Lane l = lane_of(q);
    const FiberShfl x{q, &grp};
    for (int b = 0; b < B; b++) {
      verdict_lanes_row(acc.data(), r.data(), ry.data(), rs.data(), a_valid, r_valid,
                        limb(k.d2, q), strict, cof, B, b, l, x);
    }
    for (int i = 0; i < n; i++) {
      fe zi;
      fe_from13(zi, z.data() + (size_t)20 * i);
      inv[(size_t)10 * i + q] = linvert(limb(zi, q), l, x);
    }
  });
  for (int i = 0; i < n; i++) {
    fe zi, want, got;
    fe_from13(zi, z.data() + (size_t)20 * i);
    fe_invert(want, zi);
    for (int q = 0; q < kLanes; q++) got.v[q] = inv[(size_t)10 * i + q];
    if (!fe_eq(got, want)) return 3;
  }
  std::FILE* out = std::fopen(argv[2], "wb");
  for (int b = 0; b < B; b++) std::fputc(strict[b] ? 1 : 0, out);
  for (int b = 0; b < B; b++) std::fputc(cof[b] ? 1 : 0, out);
  std::fclose(out);
  return 0;
}
"""

WALK_MAIN = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdio>
#include <string>
#include <thread>
#include <vector>
#include "dag_walk_bits.cuh"
using namespace walk_bits;

// The warp's collectives over 32 threads, one a lane.
struct Shared {
  std::barrier<> bar{32};
  uint32_t slot[32];
};
struct ThreadLanes {
  int lane;
  Shared* sh;
  uint32_t ballot(bool b) const {
    sh->slot[lane] = b ? 1u : 0u;
    sh->bar.arrive_and_wait();
    uint32_t r = 0;
    for (int l = 0; l < 32; l++) r |= sh->slot[l] << l;
    sh->bar.arrive_and_wait();
    return r;
  }
  uint32_t shfl_xor(uint32_t v, int m) const {
    sh->slot[lane] = v;
    sh->bar.arrive_and_wait();
    const uint32_t r = sh->slot[lane ^ m];
    sh->bar.arrive_and_wait();
    return r;
  }
  void sync() const { sh->bar.arrive_and_wait(); }
};

// The CTA's collectives over nt threads, a Shared per warp for the ballots.
struct Cta {
  explicit Cta(int n) : bar(n), slot(n), warps(n / 32) {}
  std::barrier<> bar;
  std::vector<uint32_t> slot;
  std::vector<Shared> warps;
};
struct ThreadCta {
  int tid, nt;
  Cta* c;
  uint32_t ballot(bool b) const { return ThreadLanes{tid & 31, &c->warps[tid >> 5]}.ballot(b); }
  void sync() const { c->bar.arrive_and_wait(); }
  bool sync_or(bool b) const {
    c->slot[tid] = b ? 1u : 0u;
    sync();
    bool r = false;
    for (int i = 0; i < nt; i++) r = r || c->slot[i] != 0;
    sync();
    return r;
  }
  void atomic_max(int* a, int v) const {
    std::atomic_ref<int> r(*a);
    int cur = r.load();
    while (v > cur && !r.compare_exchange_weak(cur, v)) {}
  }
};

template <class T> bool get(std::FILE* f, std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), f) == v.size();
}

// The packed kernels' prologue from `top` on: the strings of parent rows
// 1..top (from byte par_lo) and present rows 0..top, two zero words of
// slack each.
void pack_window(const std::vector<uint8_t>& parent, const std::vector<uint8_t>& present, int N,
                 int top, long long par_lo, std::vector<uint32_t>& par, std::vector<uint32_t>& pre) {
  const long long phi = top >= 1 ? (long long)(top + 1) * N * N : par_lo;
  const long long qhi = (long long)(top + 1) * N;
  par.assign((phi - par_lo + 31) / 32 + 2, 0);
  pre.assign((qhi + 31) / 32 + 2, 0);
  for (size_t i = 0; i + 2 < par.size(); i++) par[i] = pack_word(parent.data(), par_lo, phi, i);
  for (size_t i = 0; i + 2 < pre.size(); i++) pre[i] = pack_word(present.data(), 0, qhi, i);
}

// B6, as reach_many_kernel (mode "reach": a CTA of `nwarps` warps per group
// of nwarps reads, one column table a group, warp i walking read i) or
// reach_many_wide_kernel ("reachwide": a CTA of 32 * ceil(N / 32) threads a
// read). in: W N K nwarps, parent,
// uncommitted, offs int32 [K], onehots [K, N]; out: masks uint8 [K, W, N],
// every byte written (exit 5 otherwise).
int reach(bool wide, std::FILE* in, std::FILE* out) {
  int hdr[4];
  if (std::fread(hdr, 4, 4, in) != 4) return 2;
  const int W = hdr[0], N = hdr[1], K = hdr[2], nwarps = hdr[3];
  std::vector<uint8_t> parent((size_t)W * N * N), unc((size_t)W * N), onehots((size_t)K * N);
  std::vector<int32_t> offs(K);
  if (!get(in, parent) || !get(in, unc) || !get(in, offs) || !get(in, onehots)) return 2;
  std::vector<uint8_t> masks((size_t)K * W * N, 0xAA);
  bool* mb = reinterpret_cast<bool*>(masks.data());
  if (wide) {
    const int NW = (N + 31) / 32, nt = 32 * NW;
    for (int b = 0; b < K; b++) {
      std::vector<uint32_t> sm((size_t)2 * NW, 0xFFFFFFFFu);
      int cand[2] = {0, 0};
      Cta cta(nt);
      std::vector<std::thread> threads;
      for (int p = 0; p < nt; p++) {
        threads.emplace_back([&, p, b] {
          wide_walk(ThreadCta{p, nt, &cta}, parent.data(), unc.data(), nullptr, offs.data() + b,
                    onehots.data() + (size_t)b * N, mb + (size_t)b * W * N, W, N, 1, 0, kSentinel,
                    sm.data(), cand);
        });
      }
      for (auto& th : threads) th.join();
    }
  } else {
    const long long par_lo = ((long long)N * N) & ~31LL;
    for (int k0 = 0; k0 < K; k0 += nwarps) {
      const int kn = std::min(nwarps, K - k0);
      int top = -1;
      for (int k = k0; k < k0 + kn; k++) {
        for (int p = 0; p < N; p++) {
          if (onehots[(size_t)k * N + p] && offs[k] >= 0 && offs[k] < W) top = std::max(top, offs[k]);
        }
      }
      std::vector<uint32_t> par, pre;
      pack_window(parent, unc, N, top, par_lo, par, pre);
      std::vector<uint32_t> ct((size_t)W * N * 2, 0xFFFFFFFFu), prw((size_t)W * 2, 0xFFFFFFFFu);
      std::vector<uint32_t> keep((size_t)nwarps * W * 2, 0xFFFFFFFFu);
      const Tables t{ct.data(), prw.data(), N};
      std::vector<Shared> warps(nwarps);
      std::barrier<> cta(32 * nwarps);
      std::vector<std::thread> threads;
      for (int i = 0; i < 32 * nwarps; i++) {
        threads.emplace_back([&, i] {
          const int warp = i / 32;
          const ThreadLanes x{i % 32, &warps[warp]};
          column_table(x, par.data(), (int)par_lo, pre.data(), N, top, ct.data(), prw.data(), warp,
                       nwarps);
          cta.arrive_and_wait();
          if (warp < kn) {
            const int k = k0 + warp;
            reach_read(x, t, offs[k], onehots.data() + (size_t)k * N, mb + (size_t)k * W * N, W,
                       keep.data() + (size_t)warp * W * 2);
          }
        });
      }
      for (auto& th : threads) th.join();
    }
  }
  for (uint8_t b : masks) {
    if (b > 1) return 5;
  }
  std::fwrite(masks.data(), 1, masks.size(), out);
  return 0;
}

// mode "walk": in W N K gc lcr, parent, present, lc int32 [N], offs int32 [K],
// onehots [K, N]; out masks uint8 [K, W, N] (as chain_commit_kernel).
// mode "wide": the same, as chain_commit_wide_kernel.
// mode "pack": in n, bytes [n]; out the string of the bytes, then for every
// bit offset o < 32 n - 64 and width 64 the two words row_bits reads.
// modes "reach" and "reachwide": B6 (see reach).
int main(int argc, char** argv) {
  std::FILE* in = std::fopen(argv[2], "rb");
  std::FILE* out = std::fopen(argv[3], "wb");
  if (std::string(argv[1]).rfind("reach", 0) == 0) return reach(std::string(argv[1]) == "reachwide", in, out);
  if (std::string(argv[1]) == "pack") {
    long long n = 0;
    if (std::fread(&n, 8, 1, in) != 1) return 2;
    std::vector<uint8_t> bytes(n);
    if (!get(in, bytes)) return 2;
    const long long nw = (n + 31) / 32;
    std::vector<uint32_t> s(nw + 2, 0);
    for (long long i = 0; i < nw; i++) s[i] = pack_word(bytes.data(), 0, n, i);
    std::fwrite(s.data(), 4, nw, out);
    for (long long o = 0; o + 64 <= 32 * nw; o++) {
      uint32_t w[2];
      row_bits(s.data(), o, 64, w[0], w[1]);
      std::fwrite(w, 4, 2, out);
    }
    return 0;
  }
  int hdr[5];
  if (std::fread(hdr, 4, 5, in) != 5) return 2;
  const int W = hdr[0], N = hdr[1], K = hdr[2], gc = hdr[3], lcr0 = hdr[4];
  std::vector<uint8_t> parent((size_t)W * N * N), present((size_t)W * N), onehots((size_t)K * N);
  std::vector<int32_t> lc_in(N), offs(K);
  if (!get(in, parent) || !get(in, present) || !get(in, lc_in) || !get(in, offs) || !get(in, onehots)) return 2;
  if (std::string(argv[1]) == "wide") {
    const int NW = (N + 31) / 32, nt = 32 * NW;
    std::vector<uint32_t> sm((size_t)2 * NW, 0xFFFFFFFFu);
    int cand[2] = {0, 0};
    bool* masks = new bool[(size_t)K * W * N];
    Cta cta(nt);
    std::vector<std::thread> threads;
    for (int p = 0; p < nt; p++) {
      threads.emplace_back([&, p] {
        wide_walk(ThreadCta{p, nt, &cta}, parent.data(), present.data(), lc_in.data(),
                  offs.data(), onehots.data(), masks, W, N, K, gc, lcr0, sm.data(), cand);
      });
    }
    for (auto& th : threads) th.join();
    for (size_t i = 0; i < (size_t)K * W * N; i++) std::fputc(masks[i] ? 1 : 0, out);
    delete[] masks;
    return 0;
  }
  // the kernel's prologue: top, then the strings of parent rows 1..top and
  // present rows 0..top, two zero words of slack each, then (on the lanes)
  // the column table
  int top = -1;
  for (int k = 0; k < K; k++) {
    for (int p = 0; p < N; p++) {
      if (onehots[(size_t)k * N + p]) top = std::max(top, std::min(offs[k], W - 1));
    }
  }
  const long long par_lo = ((long long)N * N) & ~31LL;
  std::vector<uint32_t> par, pre;
  pack_window(parent, present, N, top, par_lo, par, pre);
  std::vector<uint32_t> ct((size_t)W * N * 2, 0), prw((size_t)W * 2, 0);
  const Tables t{ct.data(), prw.data(), N};
  std::vector<int> lc(64, 0);
  for (int p = 0; p < N; p++) lc[p] = lc_in[p];
  std::vector<uint32_t> keep((size_t)K * W * 2, 0xFFFFFFFFu);
  Shared sh;
  std::vector<std::thread> lanes;
  for (int l = 0; l < 32; l++) {
    lanes.emplace_back([&, l] {
      const ThreadLanes x{l, &sh};
      column_table(x, par.data(), (int)par_lo, pre.data(), N, top, ct.data(), prw.data(), 0, 1);
      x.sync();
      int lcr = lcr0;
      for (int k = 0; k < K; k++) {
        walk_leader<true>(x, t, onehots.data() + (size_t)k * N, offs[k], W, gc,
                    lc.data(), lcr, keep.data() + (size_t)k * W * 2);
      }
    });
  }
  for (auto& th : lanes) th.join();
  std::vector<uint8_t> masks((size_t)K * W * N);
  for (int k = 0; k < K; k++) {
    for (int i = 0; i < W * N; i++) {
      const int w = i / N, p = i - w * N;
      masks[(size_t)k * W * N + i] = (keep[((size_t)k * W + w) * 2 + (p >> 5)] >> (p & 31)) & 1u;
    }
  }
  std::fwrite(masks.data(), 1, masks.size(), out);
  return 0;
}
"""


SYNC_MAIN = r"""
#include <cstdio>
#include <string>
#include <vector>
#include "dag_window_sync.cuh"
using namespace window_sync;

// argv[1] "layout": in W, N (int32); out capacity(W, N), slot_bits(W, N).
// argv[1] "pack": in W, N, shift, rolls, T (int32), offs [T], idxs [T]
// (int32), rows [T, (N + 7) / 8] (packed bits); out, per launch of
// for_each_block, its shift and slot count, then each slot as the kernel
// reads it (slot_at): offset, index (int32) and its N row bytes.
// argv[1] "sync": in W, N, shift, in_place, T, chunk, threads, the slots
// as for "pack", then parent [W, N, N] and present [W, N]; out the launch
// count (int32) and the outputs after dag_window_window_sync's launches,
// each run as window_sync_kernel's grid, a CTA a loop over its threads.
template <typename X>
static bool get(FILE* in, X* x, size_t n) { return std::fread(x, sizeof(X), n, in) == n; }

int main(int argc, char** argv) {
  const std::string mode = argv[1];
  FILE* in = std::fopen(argv[2], "rb");
  FILE* out = std::fopen(argv[3], "wb");
  int h[7];
  if (mode == "layout") {
    if (!get(in, h, 2)) return 2;
    const int r[2] = {capacity(h[0], h[1]), slot_bits(h[0], h[1])};
    std::fwrite(r, 4, 2, out);
    return 0;
  }
  const int nh = mode == "pack" ? 5 : 7;
  if (!get(in, h, nh)) return 2;
  const int W = h[0], N = h[1], shift = h[2], T = h[4], rb = (N + 7) / 8;
  const bool rolls = mode == "pack" ? h[3] != 0 : h[3] == 0;
  std::vector<int32_t> offs(T), idxs(T);
  std::vector<uint8_t> rows((size_t)T * rb);
  if (!get(in, offs.data(), T) || !get(in, idxs.data(), T) ||
      !get(in, rows.data(), rows.size())) return 2;
  int launches = 0;
  if (mode == "pack") {
    for_each_block(offs.data(), idxs.data(), rows.data(), T, W, N, shift, rolls, launches,
                   [&](const Slots& s, int sh) {
                     const int head[2] = {sh, s.T};
                     std::fwrite(head, 4, 2, out);
                     for (int i = 0; i < s.T; i++) {
                       int cell[2];
                       const long long r = slot_at(s, i, W, N, cell[0], cell[1]);
                       std::fwrite(cell, 4, 2, out);
                       for (int c = 0; c < N; c++) {
                         const uint8_t b = (uint8_t)bits_at(s.w, r + c, 1);
                         std::fwrite(&b, 1, 1, out);
                       }
                     }
                     return 0;
                   });
    return 0;
  }
  std::vector<uint8_t> parent((size_t)W * N * N), present((size_t)W * N);
  if (!get(in, parent.data(), parent.size()) || !get(in, present.data(), present.size()))
    return 2;
  std::vector<uint8_t> op(parent.size(), 0xAB), oq(present.size(), 0xAB);  // unwritten bytes show
  uint8_t* out_p = rolls ? op.data() : parent.data();
  uint8_t* out_q = rolls ? oq.data() : present.data();
  const long long chunk = chunk_bytes(h[5], (long long)N * N);
  const int nt = h[6] > 0 ? h[6] : 256;
  const long long chunks = ((long long)N * N + chunk - 1) / chunk;
  const uint8_t* src_p = parent.data();
  const uint8_t* src_q = present.data();
  for_each_block(offs.data(), idxs.data(), rows.data(), T, W, N, shift, rolls, launches,
                 [&](const Slots& s, int sh) {
                   for (int w = 0; w < W; w++) {
                     for (int y = 0; y < chunks; y++) {
                       if (src_p != out_p) {
                         for (int t = 0; t < nt; t++) {
                           cta_copy(t, nt, w, y, chunk, src_p, src_q, out_p, out_q, W, N, sh);
                         }
                       }
                       for (int t = 0; t < nt; t++) {
                         cta_place(t, nt, w, y, chunk, s, out_p, out_q, W, N);
                       }
                     }
                   }
                   src_p = out_p;
                   src_q = out_q;
                   return 0;
                 });
  std::fwrite(&launches, 4, 1, out);
  std::fwrite(out_p, 1, parent.size(), out);
  std::fwrite(out_q, 1, present.size(), out);
  return 0;
}
"""


COMMIT_MAIN = r"""
#include <cstdio>
#include <vector>
#include "dag_commit.cuh"
using namespace commit_mask;

template <class T>
bool read(FILE* in, std::vector<T>& v, size_t n) {
  v.resize(n);
  return std::fread(v.data(), sizeof(T), n, in) == n;
}

// in: B, W, M, S, the byte offsets of masks and committed past a 16-byte
// boundary, masks uint8 [B, W, M], support int32 [B], stakes int32 [S],
// last int32 [M]
// out: the CTAs C, committed uint8 [B, W, M], new_last int32 [M]. The
// launch as consensus_commit_kernel runs it, phase by phase: each CTA's
// table and stake sum, every thread's stream, CTA 0's fold. Exits 3 when a
// committed byte was not written.
int main(int argc, char** argv) {
  FILE* in = std::fopen(argv[1], "rb");
  int h[6];
  if (std::fread(h, 4, 6, in) != 6) return 2;
  const int B = h[0], W = h[1], M = h[2], S = h[3];
  const int n = B * W * M;
  std::vector<uint8_t> m;
  std::vector<int32_t> support, stakes, last;
  if (!read(in, m, n) || !read(in, support, B) || !read(in, stakes, S) || !read(in, last, M))
    return 2;
  std::fclose(in);
  std::vector<uint8_t> mbuf(n + 32), cbuf(n + 32, 0xAB);
  auto at = [](std::vector<uint8_t>& v, int off) {
    return v.data() + ((16 - ((uintptr_t)v.data() & 15)) & 15) + off;
  };
  uint8_t* masks = at(mbuf, h[4]);
  uint8_t* committed = at(cbuf, h[5]);
  std::copy(m.begin(), m.end(), masks);
  const int C = ctas_for(n), G = C * kThreads;
  std::vector<std::vector<int>> best(C, std::vector<int>(M));
  for (int c = 0; c < C; c++)
    for (int t = 0; t < kThreads; t++) init_best(best[c].data(), M, B, W, t, kThreads);
  uint32_t total = 0;  // every CTA's sum alike
  for (int t = 0; t < kThreads; t++) total += stake_part(stakes.data(), S, t, kThreads);
  const Dims d{W * M, W, M, quorum_of(total)};
  const Span sp = span_of(masks, committed, n, G);
  auto mx = [](int* a, int w) { if (w > *a) *a = w; };
  for (int g = 0; g < G; g++) {
    Batch x;
    load_first(masks, support.data(), W * M, sp, g, G, x);
    commit_stream(masks, committed, support.data(), d, sp, best[g / kThreads].data(), g, G, x,
                  mx);
  }
  std::vector<int32_t> new_last(M, -7);
  for (int t = 0; t < kThreads; t++)
    fold(t < M ? last[t] : 0, last.data(), new_last.data(), M, C,
         [&](int c) { return best[c].data(); }, t, kThreads);
  for (int i = 0; i < n; i++)
    if (committed[i] > 1) return 3;
  std::FILE* out = std::fopen(argv[2], "wb");
  std::fwrite(&C, 4, 1, out);
  std::fwrite(committed, 1, n, out);
  std::fwrite(new_last.data(), 4, M, out);
  std::fclose(out);
  return 0;
}
"""


SUPPORT_MAIN = r"""
#include <cstdio>
#include <vector>
#include "dag_support.cuh"
using namespace support;

template <class T>
bool read(FILE* in, std::vector<T>& v, size_t n) {
  v.resize(n);
  return std::fread(v.data(), sizeof(T), n, in) == n;
}

// in: W, N, M, B, parent uint8 [W, N, M], present uint8 [W, N], stakes
// int32 [N], offs int32 [B], leaders int32 [B]
// out: kWarps, kNoWalk, the CTAs C, out int32 [B], err int32 [C, 3]. The
// launch as leader_support_kernel runs it: a warp a walk, its 32 lanes'
// parts summed as __reduce_add_sync sums them (wrapping), each CTA's error
// word its lowest out-of-range walk.
int main(int argc, char** argv) {
  FILE* in = std::fopen(argv[1], "rb");
  int h[4];
  if (std::fread(h, 4, 4, in) != 4) return 2;
  const int W = h[0], N = h[1], M = h[2], B = h[3];
  std::vector<uint8_t> parent, present;
  std::vector<int32_t> stakes, offs, leaders;
  if (!read(in, parent, (size_t)W * N * M) || !read(in, present, (size_t)W * N) ||
      !read(in, stakes, N) || !read(in, offs, B) || !read(in, leaders, B))
    return 2;
  std::fclose(in);
  const int C = ctas_for(B);
  std::vector<int32_t> out(B, -7), err(3 * C, -7);
  for (int c = 0; c < C; c++) {
    int bad = kNoWalk;
    std::vector<int32_t> off_of(kWarps), leader_of(kWarps);
    for (int i = 0; i < kWarps; i++) {
      const int b = c * kWarps + i;
      if (b >= B) continue;
      uint32_t sum = 0;
      bool ok = true;
      for (int lane = 0; lane < 32; lane++) {
        int32_t off, leader;
        bool lane_ok;
        sum += lane_part(parent.data(), present.data(), stakes.data(), offs.data(),
                         leaders.data(), b, W, N, M, lane, &off, &leader, &lane_ok);
        if (lane > 0 && lane_ok != ok) return 3;  // the test is warp-uniform
        ok = lane_ok;
        off_of[i] = off;
        leader_of[i] = leader;
      }
      out[b] = (int32_t)sum;
      if (!ok && b < bad) bad = b;
    }
    if (bad == kNoWalk) {
      err[3 * c] = kNoWalk;
      err[3 * c + 1] = err[3 * c + 2] = 0;
    } else {
      err[3 * c] = bad;
      err[3 * c + 1] = off_of[bad - c * kWarps];
      err[3 * c + 2] = leader_of[bad - c * kWarps];
    }
  }
  std::FILE* o = std::fopen(argv[2], "wb");
  const int32_t head[3] = {kWarps, kNoWalk, C};
  std::fwrite(head, 4, 3, o);
  std::fwrite(out.data(), 4, B, o);
  std::fwrite(err.data(), 4, 3 * C, o);
  std::fclose(o);
  return 0;
}
"""


def _build(tmp_path_factory, name: str, source: str, std: str, defines=()) -> Path:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernels' code needs it")
    d = tmp_path_factory.mktemp(name)
    src = d / f"{name}.cpp"
    src.write_text(source)
    exe = d / name
    subprocess.run([gxx, f"-std={std}", "-O2", "-pthread", "-Wno-unknown-pragmas",
                    *(f"-D{m}" for m in defines), "-I", str(CSRC), "-o", str(exe), str(src)],
                   check=True, timeout=300)
    return exe


@pytest.fixture(scope="module")
def lanes_exe(tmp_path_factory):
    return _build(tmp_path_factory, "lanes_main", LANES_MAIN, "c++20")


@pytest.fixture(scope="module")
def verdict_exe(tmp_path_factory):
    return _build(tmp_path_factory, "verdict_main", VERDICT_MAIN, "c++20")


@pytest.fixture(scope="module")
def walk_exe(tmp_path_factory):
    return _build(tmp_path_factory, "walk_main", WALK_MAIN, "c++20")


@pytest.fixture(scope="module")
def commit_exe(tmp_path_factory):
    return _build(tmp_path_factory, "commit_main", COMMIT_MAIN, "c++17")


@pytest.fixture(scope="module")
def support_exe(tmp_path_factory):
    return _build(tmp_path_factory, "support_main", SUPPORT_MAIN, "c++17")


@pytest.fixture(scope="module")
def sync_exe(tmp_path_factory):
    return _build(tmp_path_factory, "sync_main", SYNC_MAIN, "c++17")


def _run(exe: Path, args, payload: bytes, tmp_path: Path) -> bytes:
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(payload)
    proc = subprocess.run([str(exe), *args, str(src), str(dst)], timeout=300)
    assert proc.returncode == 0, f"{exe.name} exited {proc.returncode}"
    return dst.read_bytes()


# -- A3: the ten-lane decompression --------------------------------------------


def _decompress(exe: Path, rows, signs, tmp_path: Path):
    B = rows.shape[0]
    payload = (np.int32(B).tobytes() + rows.astype(np.int16).tobytes()
               + signs.astype(np.int8).tobytes()
               + np.ascontiguousarray(tk._KERNEL_CONSTS, np.int32).tobytes())
    out = _run(exe, [], payload, tmp_path)
    pts = np.frombuffer(out[: 4 * 20 * B * 4], np.int32).reshape(4, 20, B)
    valid = np.frombuffer(out[4 * 20 * B * 4:], np.uint8).astype(bool)
    return pts, valid


@pytest.mark.parametrize("seed,b", [(1, 7), (2, 36), (5, 12), (6, 24)])
def test_lanes_decompress_matches_plain(lanes_exe, tmp_path, seed, b):
    """The ten-lane form (the kernel's): ten fibers for the ten lanes of a
    group, on chip_smoke's A3 rows (the edge encodings, multiples of the
    base point with either sign, random y); held mod p against the plain
    version and limb for limb against the one-thread decompress (in the
    harness)."""
    rows, signs = chip_smoke.decompress_rows(np.random.default_rng(seed), b)
    pts, valid = _decompress(lanes_exe, rows, signs, tmp_path)
    p_pts, p_valid = tk.verify_decompress_plain(torch.from_numpy(rows), torch.from_numpy(signs))
    assert valid.tolist() == p_valid.tolist()
    assert chip_smoke._mod_p(pts) == chip_smoke._mod_p(p_pts.numpy())
    assert b < 24 or 0 < int(valid.sum()) < len(valid)  # both outcomes present
    assert (pts >= 0).all() and (pts < 2**13).all()  # every lane's limbs stored, canonical


def test_lanes_decompress_matches_jax_eager(lanes_exe, tmp_path):
    """The ten-lane form against the JAX stage run op by op
    (`jax.disable_jit()`, as tests/test_torch_staged.py runs it) on the edge
    rows and two random."""
    rows, signs = chip_smoke.decompress_rows(np.random.default_rng(8), 14)
    with jax.disable_jit():
        jpts, jvalid = jk.verify_decompress_kernel(jnp.asarray(rows), jnp.asarray(signs))
    pts, valid = _decompress(lanes_exe, rows, signs, tmp_path)
    assert np.asarray(jvalid).tolist() == valid.tolist()
    assert chip_smoke._mod_p(pts) == chip_smoke._mod_p(np.asarray(jpts))


# -- A5: the ten-lane verdict -------------------------------------------------


@pytest.fixture(scope="module")
def verdict_rows():
    """A5's inputs, B = 13: chip_smoke.verify_rows' eight rows through the
    plain A3 and A4 (rows 0-7: a torsion-defect item, corrupt R, corrupt
    S, a wrong message, a zero row, a random-limb row, a valid signature,
    padding; the plain stages' loose limbs), then the valid row with A
    marked invalid (8) and with R marked invalid (9), the torsion row with
    R marked invalid (10), and two rows of random radix-2^13 limbs for acc
    and R, canonical (11) and loose up to 9500 (12)."""
    a_y, a_sign, r_y, r_sign, kd, sd = (torch.from_numpy(a)
                                        for a in chip_smoke.verify_rows(7, 16, 8))
    a_pt, a_valid = tk.verify_decompress_plain(a_y, a_sign)
    r_pt, r_valid = tk.verify_decompress_plain(r_y, r_sign)
    acc = tk.verify_straus_plain(a_pt, kd, sd).numpy()
    r_pt, r_y, r_sign = r_pt.numpy(), r_y.numpy(), r_sign.numpy()
    av, rv = a_valid.numpy().copy(), r_valid.numpy().copy()
    pick = [6, 6, 0]
    rng = np.random.default_rng(12)
    rnd = [rng.integers(0, top, (4, 20, 1), dtype=np.int32) for top in (2**13, 9501)]
    rnd_r = [rng.integers(0, top, (4, 20, 1), dtype=np.int32) for top in (2**13, 9501)]
    acc = np.concatenate([acc, acc[..., pick], *rnd], axis=2)
    r_pt = np.concatenate([r_pt, r_pt[..., pick], *rnd_r], axis=2)
    r_y = np.concatenate([r_y, r_y[pick], rng.integers(0, 2**13, (2, 20)).astype(np.int16)])
    r_sign = np.concatenate([r_sign, r_sign[pick], np.array([0, 1], np.int8)])
    av = np.concatenate([av, [False, True, True, True, True]])
    rv = np.concatenate([rv, [True, False, False, True, True]])
    return [np.ascontiguousarray(a) for a in (acc, r_pt, r_y, r_sign, av, rv)]


@pytest.fixture(scope="module")
def verdict_jax(verdict_rows):
    """The JAX `verify_verdict_kernel` on verdict_rows, run op by op
    (`jax.disable_jit()`, as tests/test_torch_staged.py runs it; ~13 s)."""
    with jax.disable_jit():
        js, jc = jk.verify_verdict_kernel(*(jnp.asarray(a) for a in verdict_rows))
    return np.asarray(js).tolist(), np.asarray(jc).tolist()


def _verdict(exe: Path, rows, z, tmp_path: Path):
    acc, r_pt, r_y, r_sign, av, rv = rows
    B = acc.shape[2]
    payload = (np.int32(B).tobytes() + acc.astype(np.int32).tobytes()
               + r_pt.astype(np.int32).tobytes() + r_y.astype(np.int16).tobytes()
               + r_sign.astype(np.int8).tobytes() + av.astype(np.uint8).tobytes()
               + rv.astype(np.uint8).tobytes()
               + np.ascontiguousarray(tk._KERNEL_CONSTS, np.int32).tobytes()
               + np.int32(len(z)).tobytes() + np.asarray(z, np.int32).tobytes())
    out = np.frombuffer(_run(exe, [], payload, tmp_path), np.uint8).astype(bool)
    return out[:B], out[B:]


def test_lanes_verdict_matches_plain_and_jax(verdict_exe, verdict_rows, verdict_jax, tmp_path):
    """The ten-lane A5 (`verdict_lanes_row`, ten fibers a group) on
    verdict_rows, bit for bit against `verify_verdict_plain` and the JAX
    `verify_verdict_kernel` run eagerly; in the same run `linvert` mod p
    against the one-thread `fe_invert` (in the harness) on 0, 1, p - 1 and
    two random elements."""
    p1 = tk.int_to_limbs(2**255 - 20).reshape(-1)
    rng = np.random.default_rng(3)
    z = [np.zeros(20, np.int32), tk.int_to_limbs(1).reshape(-1), p1,
         *rng.integers(0, 2**13, (2, 20), dtype=np.int32)]
    strict, cof = _verdict(verdict_exe, verdict_rows, z, tmp_path)
    p_strict, p_cof = tk.verify_verdict_plain(*(torch.from_numpy(a) for a in verdict_rows))
    assert strict.tolist() == p_strict.tolist() and cof.tolist() == p_cof.tolist()
    assert verdict_jax == (strict.tolist(), cof.tolist())
    # torsion: cofactored only; valid: both; A invalid: neither; R invalid:
    # strict only; the torsion row with R invalid: neither
    assert [(strict[i], cof[i]) for i in (0, 6, 8, 9, 10)] == [
        (False, True), (True, True), (False, False), (True, False), (False, False)]


# -- B2: the packed-bit walk ---------------------------------------------------


def test_pack_and_row_bits(walk_exe, tmp_path):
    """Every byte value at every position of a word packs to its nonzero
    bit; the row read at every bit offset equals the bits of the bytes."""
    rng = np.random.default_rng(7)
    vals = np.arange(256, dtype=np.uint8)
    body = np.concatenate([np.roll(vals, s) for s in range(32)] +
                          [(rng.random(333) < 0.5) * rng.integers(1, 256, 333)]).astype(np.uint8)
    n = body.size
    out = _run(walk_exe, ["pack"], np.int64(n).tobytes() + body.tobytes(), tmp_path)
    nw = (n + 31) // 32
    words = np.frombuffer(out[: 4 * nw], np.uint32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    assert np.array_equal(bits[:n], (body != 0).astype(np.uint8))
    assert not bits[n:].any()
    reads = np.frombuffer(out[4 * nw:], np.uint32).reshape(-1, 2)
    got = np.unpackbits(reads.view(np.uint8), bitorder="little").reshape(len(reads), 64)
    for o in range(len(reads)):
        assert np.array_equal(got[o], bits[o:o + 64]), o


def _walk(exe: Path, parent, present, gc, lc, lcr, offs, onehots, tmp_path, mode="walk"):
    W, N = present.shape
    K = offs.shape[0]
    payload = (np.asarray([W, N, K, gc, lcr], np.int32).tobytes() + parent.tobytes()
               + present.tobytes() + lc.astype(np.int32).tobytes()
               + offs.astype(np.int32).tobytes() + onehots.tobytes())
    out = _run(exe, [mode], payload, tmp_path)
    return np.frombuffer(out, np.uint8).reshape(K, W, N).astype(bool)


def _references(parent, present, gc, lc, lcr, offs, onehots):
    want = np.asarray(jd.chain_commit(parent, present, np.int32(gc), lc, np.int32(lcr),
                                      offs, onehots))
    t = [torch.from_numpy(a) for a in (parent, present, lc, offs, onehots)]
    plain = td.chain_commit_plain(t[0], t[1], gc, t[2], lcr, t[3], t[4]).numpy()
    assert np.array_equal(plain, want)
    return want


# chip_smoke's B2 shapes at small W (the leader rows scaled into the window)
# and the healed-partition chains of the main path.
def _small_cases():
    cases = []
    for w, n, gc, rows in chip_smoke.CHAIN_SHAPES:
        ws = min(w, 16)

        def scaled(r):  # row 1 and the top row stay where they are
            if r is None or r <= 1:
                return r
            return ws - 1 if r == w - 1 else min(max(r * ws // w, 2), ws - 2)

        cases.append((ws, n, min(gc, 6), tuple(scaled(r) for r in rows)))
    cases += [(16, 32, 6, (9, 15)), (16, 7, 6, (3, 15))]
    return cases


@pytest.mark.parametrize("w,n,gc,rows", [c for c in _small_cases() if c[1] <= 64])
def test_warp_walk_matches_jax(walk_exe, tmp_path, w, n, gc, rows):
    """The warp form (N <= 64): pack, walk, expand, bit for bit."""
    host = chip_smoke.chain_inputs(np.random.default_rng(w * 1000 + n), w, n, rows)
    parent, present, lc, lcr, offs, onehots = host
    want = _references(parent, present, gc, lc, lcr, offs, onehots)
    got = _walk(walk_exe, parent, present, gc, lc, lcr, offs, onehots, tmp_path)
    assert np.array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("K,live", [(1, 1), (2, 2), (4, 3)])
def test_warp_walk_healed_chain_matches_jax(walk_exe, tmp_path, K, live):
    """The main path's shape (W 64, N 50, gc 50) on the healed-partition
    chains, where the gc filter drops certificates and the newest leader's
    filter depends on the lcr its earlier leaders advanced."""
    host = chip_smoke.healed_partition_chain(np.random.default_rng(50 + K), 64, 50,
                                             chip_smoke.GC_DEPTH, K, live)
    parent, present, lc, lcr, offs, onehots = host
    want = _references(parent, present, chip_smoke.GC_DEPTH, lc, lcr, offs, onehots)
    got = _walk(walk_exe, parent, present, chip_smoke.GC_DEPTH, lc, lcr, offs, onehots, tmp_path)
    assert np.array_equal(got, want) and want[:live].any()


# the list at density 0.7, and sparse links, where a reached column's first
# parent often lies past the first batch of the frontier's set bits
WIDE_CASES = ([(*c, 0.7) for c in _small_cases()]
              + [(16, 65, 6, (9, None, 15), 0.05), (16, 200, 6, (9, None, 15), 0.02),
                 (16, 200, 6, (9, None, 15), 0.3)])


@pytest.mark.parametrize("w,n,gc,rows,density", WIDE_CASES)
def test_wide_walk_matches_jax(walk_exe, tmp_path, w, n, gc, rows, density):
    """The wide walk (`wide_walk`, a CTA of 32 * ceil(N / 32) threads) at
    every shape of the list: it serves N > 64, and N <= 64 when the
    window's strings outgrow shared memory."""
    host = chip_smoke.chain_inputs(np.random.default_rng(w * 1000 + n + int(100 * density)),
                                   w, n, rows, density)
    parent, present, lc, lcr, offs, onehots = host
    want = _references(parent, present, gc, lc, lcr, offs, onehots)
    got = _walk(walk_exe, parent, present, gc, lc, lcr, offs, onehots, tmp_path, mode="wide")
    assert np.array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("w,n,K,live", [(16, 50, 2, 2), (64, 50, 4, 3), (16, 200, 1, 1),
                                        (16, 200, 4, 3), (16, 1024, 2, 2)])
def test_wide_walk_healed_chain_matches_jax(walk_exe, tmp_path, w, n, K, live):
    """The wide walk on the healed-partition chains: the earlier leaders
    reach one half of the committee only, so the other half's present,
    uncommitted columns scan the whole frontier, batch after batch, and
    find no parent."""
    gc = min(chip_smoke.GC_DEPTH, w // 2)
    host = chip_smoke.healed_partition_chain(np.random.default_rng(70 + K + n), w, n, gc, K, live)
    parent, present, lc, lcr, offs, onehots = host
    want = _references(parent, present, gc, lc, lcr, offs, onehots)
    got = _walk(walk_exe, parent, present, gc, lc, lcr, offs, onehots, tmp_path, mode="wide")
    assert np.array_equal(got, want) and want[:live].any()



# -- B6: the batched reach walk --------------------------------------------------


def _read_inputs(rng: np.random.Generator, w: int, n: int, k: int, density: float):
    """K read slots on a random window: links at `density`, present at 90 %,
    and an uncommitted mask that is not `present` (each column committed up
    to a random row, as the consensus step passes it). The live reads come
    first (one at the top row, one at row 0, the rest at random rows, each
    start uncommitted but one), then padding: zero one-hots, and one slot
    with a one-hot but an offset past the window (it reaches nothing). In
    groups of 4 reads (the harness's CTA of four warps), K = 7 puts two
    padding reads in a group with a live one, and at K = 16 half the slots
    are padding, so the last two groups pack nothing."""
    parent = (rng.random((w, n, n)) < density).astype(np.uint8)
    present = (rng.random((w, n)) < 0.9).astype(np.uint8)
    lc = rng.integers(-1, w // 3, n)
    unc = (present & (np.arange(w)[:, None] > lc[None, :])).astype(np.uint8)
    live = {1: 1, 7: 5}.get(k, k // 2)
    offs = np.zeros(k, np.int32)
    onehots = np.zeros((k, n), np.uint8)
    offs[:live] = rng.integers(0, w, live)
    offs[0], offs[min(1, live - 1)] = w - 1, 0 if live > 1 else w - 1
    cols = rng.integers(0, n, live)
    onehots[np.arange(live), cols] = 1
    unc[offs[:live], cols] = 1
    if live > 2:
        unc[offs[2], cols[2]] = 0  # a start the mask excludes: an all-zero read
    if k > live + 1:
        offs[k - 1] = w
        onehots[k - 1, int(rng.integers(0, n))] = 1
    assert not np.array_equal(unc, present)
    return parent, unc, offs, onehots, live


_REACH_K = jax.jit(jax.vmap(jd.reach_mask, in_axes=(None, None, 0, 0)))


# (W, N, K, link density): W 16, 64 and one 128; N 10, 50 and 65 (past a
# warp's two words: the wide route only); K 1, 7 (with padding) and 16;
# sparse (2 / N) and dense (0.7) links
REACH_CASES = [(16, 10, 1, 0.2), (16, 10, 7, 0.7), (16, 50, 16, 0.04), (16, 50, 7, 0.7),
               (64, 50, 16, 0.04), (64, 50, 7, 0.7), (64, 10, 16, 0.7), (128, 50, 7, 0.04),
               (16, 65, 7, 0.03), (16, 65, 16, 0.7), (64, 65, 1, 0.7)]


@pytest.mark.parametrize("w,n,K,density", REACH_CASES)
def test_reach_reads_match_jax(walk_exe, tmp_path, w, n, K, density):
    """B6 bit for bit against the JAX `_reach_k` (`jax.vmap(reach_mask)`)
    and `reach_many_plain`: the packed route (N <= 64) as reach_many_kernel
    runs it, a warp a read (a CTA of four warps walking a group of 4 reads
    over one column table), and the wide route, a CTA of threads a read; every mask
    byte written, the padding reads empty."""
    parent, unc, offs, onehots, live = _read_inputs(
        np.random.default_rng(w * 100 + n + K), w, n, K, density)
    want = np.asarray(_REACH_K(parent, unc, offs, onehots))
    plain = td.reach_many_plain(*(torch.from_numpy(a) for a in (parent, unc, offs, onehots)))
    assert np.array_equal(plain.numpy(), want)
    assert want[:live].any() and not want[live:].any()
    head = np.asarray([w, n, K, 4], np.int32).tobytes()
    payload = head + b"".join(a.tobytes() for a in (parent, unc, offs, onehots))
    for mode in (("reach", "reachwide") if n <= 64 else ("reachwide",)):
        got = np.frombuffer(_run(walk_exe, [mode], payload, tmp_path), np.uint8)
        assert np.array_equal(got.reshape(K, w, n).astype(bool), want), mode


# -- B3 and B4: the window sync ------------------------------------------------


def _slots_payload(offs, idxs, rows) -> bytes:
    """The slots as the C entry point takes them: offs, idxs, then the rows
    packed to bits as `dag_kernels._window_sync` packs them."""
    return (np.ascontiguousarray(offs, np.int32).tobytes()
            + np.ascontiguousarray(idxs, np.int32).tobytes()
            + np.packbits(rows, axis=1, bitorder="little").tobytes())


def _layout(exe: Path, w: int, n: int, tmp_path: Path) -> tuple[int, int]:
    """(slots a parameter block, bits a slot) from the header's own rule."""
    out = _run(exe, ["layout"], np.asarray([w, n], np.int32).tobytes(), tmp_path)
    cap, bits = np.frombuffer(out, np.int32)
    return int(cap), int(bits)


def _sync_host(exe: Path, parent, present, shift, offs, idxs, rows, tmp_path: Path,
               chunk: int = 0, threads: int = 0):
    """sync_window's launches on the host build, as the C entry point makes
    them (`for_each_block`: slots outside the window dropped, the first
    launch out of place when it rolls, the rest in place): (launches,
    parent, present)."""
    w, n = present.shape
    head = np.asarray([w, n, min(shift, w), int(shift == 0), offs.shape[0], chunk, threads],
                      np.int32).tobytes()
    out = _run(exe, ["sync"], head + _slots_payload(offs, idxs, rows) + parent.tobytes()
               + present.tobytes(), tmp_path)
    launches = int(np.frombuffer(out[:4], np.int32)[0])
    parent = np.frombuffer(out[4:4 + w * n * n], np.uint8).reshape(w, n, n)
    present = np.frombuffer(out[4 + w * n * n:], np.uint8).reshape(w, n)
    return launches, parent, present


# (W, N, T): N 1, 49 and 50 (4-byte and byte copies), 64 (16-byte copies),
# 65 and 200 (a row of three 16 KB chunks); T 0 (a roll alone), 1, 64 with
# four duplicates and two slots below the window, and past a block.
SYNC_CASES = [(8, 1, 5), (8, 49, 64), (16, 50, 0), (16, 50, 1), (16, 50, 64), (8, 64, 64),
              (8, 65, 64), (4, 200, 9), (32, 50, "past"), (4, 200, "past")]


@pytest.mark.parametrize("w,n,T", SYNC_CASES)
def test_window_sync_cta_matches_plain_and_jax(sync_exe, tmp_path, w, n, T):
    """window_sync's CTA body, parameter blocks and launches on the host,
    at shifts 0 (in place), 1, W - 1, W and W + 5, with the default grid
    and with rows split into 48-byte chunks of 64 threads, bit for bit
    against sync_window_plain and the JAX roll_window then place_batch;
    one launch a block of live slots (one when it only rolls)."""
    rng = np.random.default_rng(w * 1000 + n)
    parent = (rng.random((w, n, n)) < 0.6).astype(np.uint8)
    present = (rng.random((w, n)) < 0.85).astype(np.uint8)
    cap, _bits = _layout(sync_exe, w, n, tmp_path)
    size = 2 * cap + 5 if T == "past" else T
    assert size <= w * n  # distinct cells, then the duplicates
    offs, idxs, rows = chip_smoke.sync_slots(rng, w, n, size, n_below=2 if size >= 8 else 0)
    live = offs >= 0
    for shift in (0, 1, w - 1, w, w + 5):
        plain = td.sync_window_plain(torch.from_numpy(parent), torch.from_numpy(present),
                                     shift, offs, idxs, rows)
        wp, wq = jd.roll_window(parent.copy(), present.copy(), np.int32(shift))
        if live.any():
            wp, wq = jd.place_batch(wp, wq, offs[live], idxs[live], rows[live],
                                    np.ones(int(live.sum()), np.uint8))
        blocks = -(-int(live.sum()) // cap)
        for chunk, threads in ((0, 0), (48, 64)):
            launches, *got = _sync_host(sync_exe, parent, present, shift, offs, idxs, rows,
                                        tmp_path, chunk, threads)
            assert launches == (max(blocks, 1) if shift else blocks), (shift, chunk)
            for g, p_, j in zip(got, plain, (wp, wq)):
                assert np.array_equal(g, p_.numpy()) and np.array_equal(g, np.asarray(j)), (
                    shift, chunk)


@pytest.mark.parametrize("n", [1, 49, 50, 64, 65, 200])
def test_slot_bits_round_trip_and_split_past_capacity(sync_exe, tmp_path, n):
    """Slot rows packed to bits (numpy's packbits, then the C entry point's
    pack_block) read back by the kernel's own reader, at N 1, 49, 50, 64, 65
    and 200: a batch past a block's capacity splits into full blocks, the
    first carrying the shift, the rest shift 0, slots outside the window
    dropped; the capacity is the most slots whose bits fit the block."""
    w = 64
    cap, bits = _layout(sync_exe, w, n, tmp_path)
    assert bits == 6 + max(n - 1, 0).bit_length() + n
    assert cap * bits <= 999 * 32 < (cap + 1) * bits  # kWords - 1 words of bits
    rng = np.random.default_rng(n)
    T = 2 * cap + 7
    offs = rng.integers(0, w, T).astype(np.int32)
    idxs = rng.integers(0, n, T).astype(np.int32)
    rows = (rng.random((T, n)) < 0.5).astype(np.uint8)
    offs[[5, 9]], idxs[11] = (-1, w), n  # outside the window: dropped
    keep = (offs >= 0) & (offs < w) & (idxs < n)

    def blocks(shift, rolls, k):
        head = np.asarray([w, n, shift, rolls, k], np.int32).tobytes()
        out = _run(sync_exe, ["pack"], head + _slots_payload(offs[:k], idxs[:k], rows[:k]),
                   tmp_path)
        got, pos = [], 0
        while pos < len(out):
            sh, t = np.frombuffer(out[pos:pos + 8], np.int32)
            pos += 8
            rec = np.frombuffer(out[pos:pos + t * (8 + n)], np.uint8).reshape(t, 8 + n)
            pos += t * (8 + n)
            cells = rec[:, :8].copy().view(np.int32)
            got.append((int(sh), cells[:, 0], cells[:, 1], rec[:, 8:]))
        return got

    got = blocks(3, 1, T)
    assert [(sh, len(o)) for sh, o, _i, _r in got] == [(3, cap), (0, cap), (0, 4)]
    assert np.array_equal(np.concatenate([o for _s, o, _i, _r in got]), offs[keep])
    assert np.array_equal(np.concatenate([i for _s, _o, i, _r in got]), idxs[keep])
    assert np.array_equal(np.concatenate([r for _s, _o, _i, r in got]), rows[keep])
    assert [(sh, len(o)) for sh, o, _i, _r in blocks(2, 1, 0)] == [(2, 0)]  # a roll alone
    assert blocks(0, 0, 0) == []  # in place with no slot: no launch


# -- B7: the commit mask -------------------------------------------------------

# (B, W, M, S, masks' and committed's offsets past a 16-byte boundary, the
# stakes): the consensus step's shape (8 CTAs, two batches of words a
# thread), the dry run's (one CTA, a byte a thread, its own table), the
# same 1 byte past a boundary, a shard block of the 2 x 2 mesh (M = 25 of
# S = 50), 2 and 3 CTAs, N = 200 and 1024 (M past a CTA's threads), one
# walk, a slab of W * M = 91 bytes 3 bytes past a boundary (walks straddle
# words; head and tail bytes) on one CTA and on eight, the same with
# committed on another alignment (every byte alone), one byte, 256 bytes
# (a byte a thread) and 257 (words and a tail byte), no walk, no row, and
# a stake sum that wraps int32.
COMMIT_CASES = [
    (64, 64, 50, 50, 0, 0, "small"),
    (2, 8, 4, 8, 0, 0, "small"),
    (2, 8, 4, 8, 1, 1, "small"),
    (32, 64, 25, 50, 0, 0, "small"),
    (5, 64, 25, 50, 0, 0, "small"),
    (3, 64, 50, 50, 0, 0, "small"),
    (8, 64, 200, 200, 0, 0, "small"),
    (2, 16, 1024, 1024, 0, 0, "small"),
    (1, 64, 50, 50, 0, 0, "small"),
    (9, 7, 13, 13, 3, 3, "small"),
    (400, 7, 13, 13, 3, 3, "small"),
    (9, 7, 13, 13, 5, 0, "small"),
    (400, 7, 13, 13, 5, 0, "small"),
    (1, 1, 1, 1, 0, 0, "small"),
    (1, 16, 16, 16, 0, 0, "small"),
    (1, 1, 257, 257, 0, 0, "small"),
    (0, 64, 50, 50, 0, 0, "small"),
    (4, 0, 50, 50, 0, 0, "small"),
    (64, 64, 50, 50, 7, 7, "wrap"),
]


@pytest.mark.parametrize("B,W,M,S,moff,coff,stakes", COMMIT_CASES)
def test_commit_cta_matches_plain(commit_exe, tmp_path, B, W, M, S, moff, coff, stakes):
    """consensus_commit_kernel's launch (dag_commit.cuh's pieces, run phase
    by phase over its CTAs and threads) against
    `consensus_commit_plain`:
    committed and new_last bit for bit, support exactly at quorum and one
    below, `last` with negative entries, every committed byte written."""
    rng = np.random.default_rng(B * 7 + M + moff)
    masks = rng.random((B, W, M)) < 0.3
    top = 2**31 - 1 if stakes == "wrap" else 5
    st = rng.integers(top // 2 if stakes == "wrap" else 1, top, S).astype(np.int32)
    total = int(st.astype(np.int64).sum())
    quorum = td._wrap32(total) // 3 + 1
    assert stakes != "wrap" or total >= 2**31  # the sum wraps
    support = (quorum + rng.integers(-2, 2, B)).astype(np.int32)
    support[:2] = (quorum, quorum - 1)[:B]
    last = rng.integers(-5, max(W, 1), M).astype(np.int32)
    payload = (np.asarray([B, W, M, S, moff, coff], np.int32).tobytes()
               + masks.astype(np.uint8).tobytes() + support.tobytes() + st.tobytes()
               + last.tobytes())
    out = _run(commit_exe, [], payload, tmp_path)
    C = int(np.frombuffer(out[:4], np.int32)[0])
    n = B * W * M
    committed = np.frombuffer(out[4:4 + n], np.uint8).reshape(B, W, M).astype(bool)
    new_last = np.frombuffer(out[4 + n:], np.int32)
    pc, pl = td.consensus_commit_plain(*(torch.from_numpy(a) for a in (masks, support, st, last)))
    assert np.array_equal(committed, pc.numpy()) and np.array_equal(new_last, pl.numpy())
    assert C == min(8, max(1, -(-n // 4096)))
    if B > 1 and W > 0:
        assert committed[0].any() and not committed[1].any()  # at quorum; one below
        assert (new_last != last).any()


# -- B5: the leader support ----------------------------------------------------


def _bad_walks(rng, B: int, W: int, M: int, count: int) -> dict:
    """`count` distinct walks of B, each with an offset outside [0, W) or a
    leader outside [0, M) (both, now and then): walk -> (offset, leader),
    None where the walk keeps its own."""
    kinds = [(W, None), (-1, None), (2**31 - 1, None), (None, M), (None, -2),
             (None, -(2**31)), (W + 3, M + 5)]
    walks = rng.choice(B, size=count, replace=False)
    return {int(b): kinds[int(rng.integers(len(kinds)))] for b in walks}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("B,M,n_bad", [(1, 50, 0), (1, 50, 1), (1, 25, 1), (64, 50, 0),
                                       (64, 50, 3), (64, 25, 5), (200, 50, 4)])
def test_support_cta_matches_plain(support_exe, tmp_path, seed, B, M, n_bad):
    """leader_support_kernel's launch (dag_support.cuh's lane body, a warp a
    walk, each CTA's error word) at the consensus step's window (W 64, N
    50), on the whole link axis (M = N) and on a shard's block (M = 25),
    stakes whose sums wrap int32 now and then, out-of-range walks among
    the in-range ones: each in-range walk's support bit-equal to
    `leader_support_plain`, each out-of-range one 0, and the words read as
    the wrapper reads them (`support_error`) name the lowest out-of-range
    walk with its offset and leader."""
    rng = np.random.default_rng(1000 * seed + 10 * B + M + n_bad)
    W, N = 64, 50
    parent = (rng.random((W, N, M)) < 0.3).astype(np.uint8)
    present = (rng.random((W, N)) < 0.9).astype(np.uint8)
    top = 2**30 if seed == 2 else 5
    stakes = rng.integers(1, top, N).astype(np.int32)
    offs = rng.integers(0, W, B).astype(np.int32)
    leaders = rng.integers(0, M, B).astype(np.int32)
    offs[:2] = (W - 1, 0)[:B]
    bad = _bad_walks(rng, B, W, M, n_bad)
    for b, (o, l) in bad.items():
        offs[b] = offs[b] if o is None else o
        leaders[b] = leaders[b] if l is None else l
    payload = (np.asarray([W, N, M, B], np.int32).tobytes() + parent.tobytes()
               + present.tobytes() + stakes.tobytes() + offs.tobytes() + leaders.tobytes())
    out = _run(support_exe, [], payload, tmp_path)
    warps, none, C = np.frombuffer(out[:12], np.int32).tolist()
    got = np.frombuffer(out[12:12 + 4 * B], np.int32)
    words = np.frombuffer(out[12 + 4 * B:], np.int32).tolist()
    assert warps == 16 and none == 2**31 - 1 and C == -(-B // warps) and len(words) == 3 * C
    good = np.array([b not in bad for b in range(B)])
    if good.any():
        idx = np.nonzero(good)[0]
        t = [torch.from_numpy(a) for a in (parent, present, stakes, offs[idx], leaders[idx])]
        want = td.leader_support_plain(*t).numpy()
        assert np.array_equal(got[idx], want) and (want > 0).any()
    assert not got[~good].any()
    first = min(bad) if bad else None
    expect = None if first is None else (first, int(offs[first]), int(leaders[first]))
    assert td.support_error(words, none) == expect
    if expect is not None:  # the CPU wrapper names the same walk
        with pytest.raises(ValueError, match=f"walk {first} has offset {expect[1]} and "
                                             f"leader index {expect[2]}"):
            td.leader_support(*(torch.from_numpy(a) for a in (parent, present, stakes, offs,
                                                               leaders)))
