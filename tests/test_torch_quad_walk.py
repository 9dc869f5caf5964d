"""The quad form of the ed25519 point layer and of A1's and A4's walk,
compiled for the host.

`csrc/ed25519_quad.cuh` runs one point operation on four threads (thread l
holds coordinate l), the exchange behind `x.shfl_xor(v, m)`;
`csrc/ed25519_straus.cuh` builds the Straus walk of A4 (`straus_quad_row`)
and A1's whole check (`verify_quad_row`) on it. g++ builds the same HD code
for the CPU and runs it on four threads a quad, a `std::barrier` for the
exchange (each test skips only when g++ is missing):

- the quad doubling (with and without T), the cached, affine cached and
  complete adds and the cache, equal mod p to the one-thread `pt_double`,
  `pt_add_cached`, `pt_add_cached_z1`, `pt_add` and `pt_cache` (in the
  harness, which also checks every output limb tight) and to the plain
  PyTorch versions, on random field elements and on curve points;
- A4's quad walk at B = 8 on the A set of `chip_smoke.signature_bucket`'s
  rows and on random points and digits: equal mod p (so as affine points)
  to `verify_straus_plain` over 64 windows, and to the JAX
  `verify_straus_kernel` run eagerly over 2 (the JAX stage scans as many
  windows as its digits have; 2 keep the eager run short);
- A1 on the quad at B = 8: the verdict bits of `chip_smoke.verify_rows`
  (torsion, forged, zero and random-limb rows) equal `verify_batch_plain`'s;
- A6', the shard reduce (`quad_shard_sum` of `csrc/ed25519_msm.cu`, a quad
  a lane), over k = 2 and 4 lane sets of 64 and of 32 lanes, curve points
  and off-curve lanes mixed: equal mod p to `msm_shard_reduce_plain` and
  to the one-thread fold in shard order (in the harness).

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
from narwhal_tpu.tpu import ed25519 as jk
from narwhal_tpu_torch.gpu import ed25519 as tk
from narwhal_tpu_torch.gpu import ed25519_ref as ref

CSRC = Path(tk.__file__).resolve().parent / "csrc"

QUAD_MAIN = r"""
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <string>
#include <thread>
#include <vector>
#include "ed25519_straus.cuh"
#include "ed25519_msm.cu"
using namespace ed25519_straus;

// A quad's exchange over four threads, one a quad thread.
struct Quad {
  std::barrier<> bar{4};
  fe slot[4];
};
struct ThreadQuad {
  int l;
  Quad* q;
  fe shfl_xor(const fe& v, int m) const {
    q->slot[l] = v;
    q->bar.arrive_and_wait();
    const fe r = q->slot[l ^ m];
    q->bar.arrive_and_wait();
    return r;
  }
  i32 shfl_xor(i32 v, int m) const {
    fe t;
    fe_zero(t);
    t.v[0] = v;
    return shfl_xor(t, m).v[0];
  }
};

// f(j, l, x) on n quads at once, four threads each.
template <class F> void on_quads(int n, F f) {
  std::unique_ptr<Quad[]> quads(new Quad[n]);
  std::vector<std::thread> threads;
  for (int j = 0; j < n; j++)
    for (int l = 0; l < 4; l++)
      threads.emplace_back([&, j, l] { f(j, l, ThreadQuad{l, &quads[j]}); });
  for (auto& t : threads) t.join();
}

template <class T> void get(std::FILE* f, std::vector<T>& v) {
  if (std::fread(v.data(), sizeof(T), v.size(), f) != v.size()) std::exit(2);
}

// ed25519_field.cuh's tight bound: 1.1 * 2^25 (even limbs), 1.1 * 2^24 (odd).
bool tight(const fe& a) {
  for (int i = 0; i < 10; i++) {
    const long long b = (i & 1) ? 18454938LL : 36909876LL;
    if (a.v[i] > b || a.v[i] < -b) return false;
  }
  return true;
}

fe load(const std::vector<int32_t>& v, size_t off) {
  fe r;
  fe_from13_loose(r, v.data() + off, 1);
  return r;
}

int main(int argc, char** argv) {
  const std::string mode = argv[1];
  std::FILE* in = std::fopen(argv[2], "rb");
  std::FILE* out = std::fopen(argv[3], "wb");
  int hdr[2];
  if (std::fread(hdr, 4, 2, in) != 2) return 2;
  const int B = hdr[0], W = hdr[1];
  std::vector<int32_t> bt13(16 * 3 * 20), c13(60);
  get(in, bt13);
  get(in, c13);
  Consts k;
  ga bt[16];
  for (int t = 0; t < 19; t++) load_tables(t, bt13.data(), c13.data(), bt, k);
  std::vector<fe> tabs((size_t)B * kTabFields);

  if (mode == "ops") {
    // per case: P [4][20], Q [4][20] (cached, quad order Y-X, Y+X, Z, 2dT),
    // G [3][20] (cached affine, ga order Y+X, Y-X, 2dT), P2 [4][20]
    std::vector<int32_t> in13((size_t)B * 15 * 20);
    get(in, in13);
    std::vector<fe> res((size_t)B * 6 * 4);  // [case][op][coordinate]
    bool ok = true;
    on_quads(B, [&](int j, int l, const ThreadQuad& x) {
      const size_t base = (size_t)j * 15 * 20;
      const fe m = load(in13, base + l * 20);
      const fe q = load(in13, base + (4 + l) * 20);
      ga g;
      g.YpX = load(in13, base + 8 * 20);
      g.YmX = load(in13, base + 9 * 20);
      g.T2d = load(in13, base + 10 * 20);
      const fe qm = load(in13, base + (11 + l) * 20), qo = load(in13, base + (11 + (l ^ 1)) * 20);
      fe* r = &res[(size_t)j * 24];
      fe v = m;
      quad_double<true>(v, l, x);
      r[0 * 4 + l] = v;
      v = m;
      quad_double<false>(v, l, x);
      r[1 * 4 + l] = v;
      v = m;
      quad_add_cached(v, q, l, x);
      r[2 * 4 + l] = v;
      v = m;
      quad_add_cached_z1(v, quad_affine_field(g, l), l, x);
      r[3 * 4 + l] = v;
      v = m;
      quad_add(v, qm, qo, l, k, x);
      r[4 * 4 + l] = v;
      fe o;
      fe_shfl_xor(o, m, 1, x);
      quad_cache(v, m, o, l, k);
      r[5 * 4 + l] = v;
    });
    for (int j = 0; j < B; j++) {
      const size_t base = (size_t)j * 15 * 20;
      ge P, P2, want[6];
      fe* c[4] = {&P.X, &P.Y, &P.Z, &P.T};
      fe* c2[4] = {&P2.X, &P2.Y, &P2.Z, &P2.T};
      for (int i = 0; i < 4; i++) {
        *c[i] = load(in13, base + i * 20);
        *c2[i] = load(in13, base + (11 + i) * 20);
      }
      gc Q;
      Q.YmX = load(in13, base + 4 * 20);
      Q.YpX = load(in13, base + 5 * 20);
      Q.Z = load(in13, base + 6 * 20);
      Q.T2d = load(in13, base + 7 * 20);
      ga G;
      G.YpX = load(in13, base + 8 * 20);
      G.YmX = load(in13, base + 9 * 20);
      G.T2d = load(in13, base + 10 * 20);
      pt_double(want[0], P);
      want[1] = want[0];
      pt_add_cached(want[2], P, Q);
      pt_add_cached_z1(want[3], P, G);
      pt_add(want[4], P, P2, k);
      gc cp;
      pt_cache(cp, P, k);
      want[5].X = cp.YmX;
      want[5].Y = cp.YpX;
      want[5].Z = cp.Z;
      want[5].T = cp.T2d;
      for (int op = 0; op < 6; op++) {
        const fe* w[4] = {&want[op].X, &want[op].Y, &want[op].Z, &want[op].T};
        for (int i = 0; i < (op == 1 ? 3 : 4); i++) {
          const fe& g = res[((size_t)j * 6 + op) * 4 + i];
          if (!fe_eq(g, *w[i]) || !tight(g)) {
            std::fprintf(stderr, "case %d op %d coordinate %d differs or is loose\n", j, op, i);
            ok = false;
          }
        }
      }
    }
    for (const fe& v : res) {
      int32_t o13[20];
      fe_to13(v, o13, 1);
      std::fwrite(o13, 4, 20, out);
    }
    return ok ? 0 : 3;
  }
  if (mode == "reduce") {
    // B shards' lane sets int32 [B][4, 20, W] -> A6' of them [4, 20, W]: a
    // quad a lane (quad_shard_sum), held mod p to the one-thread fold (the
    // complete addition in shard order) here
    std::vector<int32_t> lanes((size_t)B * 80 * W), v((size_t)80 * W, -1);
    get(in, lanes);
    std::vector<const i32*> parts(B);
    for (int s = 0; s < B; s++) parts[s] = lanes.data() + (size_t)s * 80 * W;
    on_quads(W, [&](int j, int l, const ThreadQuad& x) {
      fe m;
      ed25519_msm::quad_shard_sum(m, parts.data(), B, W, j, l, k, x);
      fe_to13(m, v.data() + (size_t)l * 20 * W + j, W);
    });
    bool ok = true;
    for (int j = 0; j < W; j++) {
      ge acc, q, got;
      pt_load13(acc, parts[0], W, j);
      for (int s = 1; s < B; s++) {
        pt_load13(q, parts[s], W, j);
        pt_add(acc, acc, q, k);
      }
      pt_load13(got, v.data(), W, j);
      if (!fe_eq(got.X, acc.X) || !fe_eq(got.Y, acc.Y) || !fe_eq(got.Z, acc.Z) ||
          !fe_eq(got.T, acc.T)) {
        std::fprintf(stderr, "lane %d differs from the one-thread fold\n", j);
        ok = false;
      }
    }
    std::fwrite(v.data(), 4, v.size(), out);
    return ok ? 0 : 3;
  }
  if (mode == "walk") {
    // a_pt int32 [4, 20, B], k and s digits int8 [B, W] -> acc int32 [4, 20, B]
    std::vector<int32_t> pts((size_t)4 * 20 * B), acc((size_t)4 * 20 * B, -1);
    std::vector<int8_t> kd((size_t)B * W), sd((size_t)B * W);
    get(in, pts);
    get(in, kd);
    get(in, sd);
    on_quads(B, [&](int j, int l, const ThreadQuad& x) {
      straus_quad_row(pts.data(), kd.data(), sd.data(), W, bt, k, &tabs[(size_t)j * kTabFields],
                      acc.data(), B, j, l, x, true);
    });
    std::fwrite(acc.data(), 4, acc.size(), out);
    return 0;
  }
  // "verify": a_y, r_y int16 [B, 20], signs int8 [B], digits int8 [B, 64]
  std::vector<int16_t> a_y((size_t)B * 20), r_y((size_t)B * 20);
  std::vector<int8_t> a_s(B), r_s(B), kd((size_t)B * 64), sd((size_t)B * 64);
  get(in, a_y);
  get(in, a_s);
  get(in, r_y);
  get(in, r_s);
  get(in, kd);
  get(in, sd);
  std::unique_ptr<bool[]> strict(new bool[B]), cof(new bool[B]);
  on_quads(B, [&](int j, int l, const ThreadQuad& x) {
    verify_quad_row(a_y.data(), a_s.data(), r_y.data(), r_s.data(), kd.data(), sd.data(), bt, k,
                    &tabs[(size_t)j * kTabFields], strict.get(), cof.get(), j, l, x, true);
  });
  for (int b = 0; b < B; b++) std::fputc(strict[b] ? 1 : 0, out);
  for (int b = 0; b < B; b++) std::fputc(cof[b] ? 1 : 0, out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def quad_exe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernels' code needs it")
    d = tmp_path_factory.mktemp("quad_main")
    src = d / "quad_main.cpp"
    src.write_text(QUAD_MAIN)
    exe = d / "quad_main"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-Wno-unknown-pragmas",
                    "-I", str(CSRC), "-o", str(exe), str(src)], check=True, timeout=300)
    return exe


def _run(exe: Path, mode: str, B: int, W: int, arrays, tmp_path: Path) -> bytes:
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    head = np.asarray([B, W], np.int32).tobytes()
    tables = (np.ascontiguousarray(tk._BT, np.int32).tobytes()
              + np.ascontiguousarray(tk._KERNEL_CONSTS, np.int32).tobytes())
    src.write_bytes(head + tables + b"".join(np.ascontiguousarray(a).tobytes() for a in arrays))
    proc = subprocess.run([str(exe), mode, str(src), str(dst)], timeout=300)
    assert proc.returncode == 0, f"{exe.name} {mode} exited {proc.returncode}"
    return dst.read_bytes()


def _limbs(values) -> np.ndarray:
    """[n] ints -> radix-2^13 limbs [NLIMB, n]."""
    return np.stack([tk.int_to_limbs(v) for v in values], axis=1)


def _mod_p(limbs) -> list:
    """[..., NLIMB, n] limbs -> nested lists of values mod p."""
    a = np.asarray(limbs)
    if a.ndim == 2:
        return [tk.limbs_to_int(a[:, j]) % ref.P for j in range(a.shape[1])]
    return [_mod_p(x) for x in a]


# -- the quad point operations ----------------------------------------------


def _op_inputs(rng: np.random.Generator, n: int):
    """n cases of (P, Q cached in quad order, G cached affine, P2): curve
    points for even cases, random field elements (and 0, 1, p - 1) for odd
    ones. The formulas are identities of field values, so off-curve inputs
    are held to the one-thread form too."""
    def rnd():
        return int.from_bytes(rng.bytes(32), "little") % ref.P

    cases = []
    for j in range(n):
        if j % 2 == 0:
            pts = [ref.point_mul(int(rng.integers(1, 2**62)), ref.G) for _ in range(2)]
            (x1, y1, z1, t1), p2 = pts
            q = ref.point_mul(int(rng.integers(1, 2**62)), ref.G)
            qx, qy, qz, qt = q
            cached = [(qy - qx) % ref.P, (qy + qx) % ref.P, qz % ref.P, 2 * ref.D * qt % ref.P]
            ax, ay = ref.affine(ref.point_mul(int(rng.integers(1, 2**62)), ref.G))
            affine = [(ay + ax) % ref.P, (ay - ax) % ref.P, 2 * ref.D * ax * ay % ref.P]
            vals = [x1, y1, z1, t1] + cached + affine + list(p2)
        else:
            vals = [rnd() for _ in range(15)]
            vals[j % 15] = (0, 1, ref.P - 1)[j % 3]
        cases.append([v % ref.P for v in vals])
    return cases


@pytest.mark.parametrize("seed", [3, 4])
def test_quad_ops_match_one_thread_and_plain(quad_exe, tmp_path, seed):
    """Each quad operation on 8 cases: the harness holds it mod p to the
    one-thread operation (every output limb tight); here it is held to the
    plain PyTorch operation."""
    cases = _op_inputs(np.random.default_rng(seed), 8)
    flat = np.stack([_limbs(c).T for c in cases]).astype(np.int32)  # [8, 15, 20]
    out = _run(quad_exe, "ops", len(cases), 0, [flat], tmp_path)
    got = np.frombuffer(out, np.int32).reshape(len(cases), 6, 4, 20)

    col = [torch.from_numpy(_limbs([c[i] for c in cases]).astype(np.int32)) for i in range(15)]
    P, Q, G, P2 = tuple(col[0:4]), col[4:8], tuple(col[8:11]), tuple(col[11:15])
    cached = (Q[1], Q[0], Q[2], Q[3])  # the plain layout: (Y+X, Y-X, Z, 2dT)
    cp = tk.pt_cache(P)
    want = [tk.pt_double(P), tk.pt_double(P), tk.pt_add_cached(P, cached),
            tk.pt_add_cached_z1(P, G), tk.pt_add(P, P2), (cp[1], cp[0], cp[2], cp[3])]
    for op, w in enumerate(want):
        for c in range(3 if op == 1 else 4):
            assert _mod_p(got[:, op, c, :].T) == _mod_p(w[c].numpy()), (op, c)


# -- A4: the quad walk -----------------------------------------------------------


@pytest.fixture(scope="module")
def walk_rows():
    """B = 8: the A set of signature rows (torsion, forged, zero and
    random-limb rows among them) decompressed by the plain A3, with their
    digits; and 8 random curve points with random digits."""
    arrays = chip_smoke.verify_rows(5, 10, 8)
    a_pt, _ = tk.verify_decompress_plain(torch.from_numpy(arrays[0]), torch.from_numpy(arrays[1]))
    rng = np.random.default_rng(11)
    pts = [ref.point_mul(int(rng.integers(1, 2**62)), ref.G) for _ in range(8)]
    rnd_pt = np.stack([_limbs([p[c] % ref.P for p in pts]) for c in range(4)]).astype(np.int32)
    rnd_digits = [rng.integers(0, 16, (8, 64)).astype(np.int8) for _ in range(2)]
    return {"signatures": (a_pt.numpy(), arrays[4], arrays[5]),
            "random": (rnd_pt, *rnd_digits)}


@pytest.mark.parametrize("kind", ["signatures", "random"])
def test_quad_walk_matches_plain(quad_exe, tmp_path, walk_rows, kind):
    """A4's quad walk over all 64 windows against verify_straus_plain: every
    coordinate equal mod p, so the points are equal as affine points."""
    pts, kd, sd = walk_rows[kind]
    out = _run(quad_exe, "walk", 8, 64, [pts, kd, sd], tmp_path)
    acc = np.frombuffer(out, np.int32).reshape(4, 20, 8)
    want = tk.verify_straus_plain(torch.from_numpy(pts), torch.from_numpy(kd),
                                  torch.from_numpy(sd)).numpy()
    assert _mod_p(acc) == _mod_p(want)
    assert chip_smoke._affine_lanes(acc) == chip_smoke._affine_lanes(want)
    assert (acc >= 0).all() and (acc < 2**13).all()  # every thread stored, canonical


def test_quad_walk_matches_jax_eager(quad_exe, tmp_path, walk_rows):
    """The quad walk over the first 2 windows against the JAX stage run op
    by op, on the signature rows and the random points side by side."""
    parts = [walk_rows["signatures"], walk_rows["random"]]
    pts = np.concatenate([p[0] for p in parts], axis=2)
    kd = np.concatenate([p[1][:, :2] for p in parts])
    sd = np.concatenate([p[2][:, :2] for p in parts])
    out = _run(quad_exe, "walk", 16, 2, [pts, kd, sd], tmp_path)
    acc = np.frombuffer(out, np.int32).reshape(4, 20, 16)
    with jax.disable_jit():
        jacc = jk.verify_straus_kernel(jnp.asarray(pts), jnp.asarray(kd), jnp.asarray(sd))
    assert _mod_p(acc) == _mod_p(np.asarray(jacc))


# -- A1 on the quad ----------------------------------------------------------


@pytest.mark.parametrize("seed", [5, 7])
def test_quad_verify_matches_plain(quad_exe, tmp_path, seed):
    """A1's verdicts on the quad (decompression on threads 0 and 1, the walk,
    the verdict) bit for bit against verify_batch_plain on the rows of
    chip_smoke.verify_rows: a torsion-defect row (strict no, cofactored
    yes), corrupt R, corrupt S, a wrong message, a zero row, a random-limb
    row, a valid row and a padding row."""
    arrays = chip_smoke.verify_rows(seed, 10, 8)
    out = _run(quad_exe, "verify", 8, 64, arrays, tmp_path)
    strict = np.frombuffer(out[:8], np.uint8).astype(bool)
    cof = np.frombuffer(out[8:], np.uint8).astype(bool)
    p_strict, p_cof = tk.verify_batch_plain(*(torch.from_numpy(a) for a in arrays))
    assert strict.tolist() == p_strict.tolist() and cof.tolist() == p_cof.tolist()
    assert not strict[0] and cof[0]  # the torsion row
    assert strict[6] and cof[6]  # the valid row


# -- A6': the shard reduce on the quad ------------------------------------------


@pytest.fixture(scope="module")
def shard_sets():
    """Four shards' lane sets of 64 and of 32 lanes, canonical limbs: curve
    points (random multiples of the base point, projective with a random Z)
    in most lanes, random field elements (off the curve, as an A6 lane of
    an invalid row is) in every third lane of every shard."""
    rng = np.random.default_rng(21)

    def coords(lane):
        if lane % 3 == 1:
            return [int.from_bytes(rng.bytes(32), "little") % ref.P for _ in range(4)]
        r = int(rng.integers(1, 2**62))
        return [r * c % ref.P for c in ref.point_mul(int(rng.integers(1, 2**62)), ref.G)]

    sets = {}
    for width in (64, 32):
        shards = []
        for _ in range(4):
            pts = [coords(j) for j in range(width)]
            shards.append(np.stack([_limbs([p[c] for p in pts]) for c in range(4)]))
        sets[width] = np.stack(shards).astype(np.int32)  # [4 shards, 4, NLIMB, width]
    return sets


@pytest.mark.parametrize("k,width", [(2, 64), (4, 64), (2, 32), (4, 32)])
def test_quad_shard_sum_matches_plain(quad_exe, tmp_path, shard_sets, k, width):
    """A6' on the quad over k shards: the harness holds every lane to the
    one-thread fold mod p; here every coordinate equals the plain reduce's
    mod p (so the lanes are equal as points, off the curve too), and every
    quad thread stored canonical limbs."""
    lanes = shard_sets[width][:k]
    out = _run(quad_exe, "reduce", k, width, [lanes], tmp_path)
    got = np.frombuffer(out, np.int32).reshape(4, 20, width)
    want = tk.msm_shard_reduce_plain(torch.from_numpy(lanes)).numpy()
    assert _mod_p(got) == _mod_p(want)
    assert (got >= 0).all() and (got < 2**13).all()
