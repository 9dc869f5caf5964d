"""Driver entry points of the port: a single-device walk and a multi-device
dry run of the consensus step.

Counterpart of `__graft_entry__.py`. `entry()` exposes one reach walk over
the DAG window on the card; `dryrun_multichip()` runs the per-validator
consensus step over a `data x auth` device mesh (`gpu.mesh.DeviceMesh`):

  data  the walks of one step (independent reach walks, certificate
        verifies),
  auth  the committee axis of the DAG tensors (the link columns of the
        parent tensor, the uncommitted and last-committed vectors).

The JAX version's XLA cache handling and compile prewarming have no
counterpart: no XLA runs in the port, and the CUDA kernels build once per
process (`kernel_registry.build_walls()` reports their walls). Its sweep of
jax's live arrays becomes a check that every tensor a leg returns lies on
the mesh's devices.
"""

from __future__ import annotations

import json
import random
import time

import numpy as np
import torch

# The sharded-verifier leg builds and checks the staged verify kernels; its
# evidence (sharded verdicts equal the known batch) does not depend on the
# mesh size beyond "the data axis spans devices", so it runs once per
# process, as in the JAX driver.
_VERIFIER_LEG_RAN = False


def _window(W: int, N: int, seed: int = 0):
    """A random-but-valid dense DAG window: parent[w, a, p] links round w to
    w-1; every certificate keeps a quorum of links (fixtures.make_certificates
    shape, as tensors)."""
    rng = np.random.default_rng(seed)
    present = np.ones((W, N), np.uint8)
    parent = (rng.random((W, N, N)) < 0.8).astype(np.uint8)
    quorum = (2 * N) // 3 + 1
    for w in range(1, W):
        for a in range(N):
            if parent[w, a].sum() < quorum:
                parent[w, a, rng.permutation(N)[:quorum]] = 1
    parent[0] = 0  # genesis row has no parents in-window
    return present, parent


def entry(device=None):
    """One reach walk over the DAG window (the order_dag / linked core):
    returns `(fn, args)` with `fn` the batched walk `reach_many` and `args`
    its operands for one walk (K = 1) from authority 3 of the top row of a
    W = 64, N = 32 window, on the card (`device="cpu"` for the tests).
    `fn(*args)[0]` is the JAX `entry()`'s mask."""
    from .gpu import resolve_device
    from .gpu.dag_kernels import reach_many

    dev = resolve_device(device)
    W, N = 64, 32
    present, parent = _window(W, N)
    onehot = np.zeros((1, N), np.uint8)
    onehot[0, 3] = 1
    args = tuple(
        torch.from_numpy(a).to(dev)
        for a in (parent, present, np.array([W - 1], np.int32), onehot)
    )
    return reach_many, args


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the consensus step over an n-device mesh on tiny shapes, in three
    legs, each checked (a failed check raises):

    1. `consensus_step_sharded`: B7 (reach walks, leader support, quorum
       mask, last-committed advance), walks over `data` and the committee
       axis over `auth`, held to a host recomputation of the support;
    2. `GpuBullshark(mesh=...)`, the `--dag-shards` engine, on a lossy
       committee-7 DAG (padded to the auth axis), held to the host
       `Bullshark`'s sequence and last-committed rounds;
    3. the sharded verifier (`GpuVerifier(mesh=data_mesh(k, ...))`) in item
       and msm mode on 31 valid signatures and a forgery, when the data
       axis has more than one device and divides 32; once per process.

    The mesh is `auth = 2` when n_devices is even, else 1, and `data =
    n_devices / auth`, over `devices` (a device may repeat: `["cpu"] * n`
    in the tests, `[cuda:0] * n` on one card) or by default the first
    n_devices cards. Too few devices raise ConfigError; there is no CPU
    fallback. Prints a `[dryrun] leg=... wall=...` line per leg and a JSON
    line with the kernels' build walls and n_devices. Every device a leg's
    results lie on must be a device of the mesh."""
    from .gpu import kernel_registry
    from .gpu.mesh import auth_mesh

    auth = 2 if n_devices % 2 == 0 else 1
    mesh = auth_mesh(auth, devices=devices, data=n_devices // auth)
    allowed = {d for row in mesh.rows("auth") for d in row}
    t_leg = time.perf_counter()

    def leg_done(name: str, devices) -> None:
        nonlocal t_leg
        stray = sorted({str(d) for d in devices} - {str(d) for d in allowed})
        if stray:
            raise AssertionError(f"dry run leg {name} left tensors on {stray}")
        now = time.perf_counter()
        print(f"[dryrun] leg={name} wall={now - t_leg:.1f}s", flush=True)
        t_leg = now

    leg_done("sharded_consensus_step", _consensus_leg(mesh))
    leg_done("production_engine_equivalence", _engine_leg(mesh))
    global _VERIFIER_LEG_RAN
    k = mesh.shape["data"]
    if k > 1 and 32 % k == 0 and not _VERIFIER_LEG_RAN:
        flat = [d for row in mesh.rows("auth") for d in row]
        for mode in ("item", "msm"):
            leg_done(f"sharded_verifier[{mode}]", _verifier_leg(flat[:k], mode))
        _VERIFIER_LEG_RAN = True

    print(json.dumps({"multichip_build_walls_s": kernel_registry.build_walls(),
                      "n_devices": n_devices}), flush=True)


def _consensus_leg(mesh):
    from .gpu.dag_kernels import consensus_step_sharded

    W, N = 8, 8
    B = 2 * mesh.shape["data"]  # walks per step, split over 'data'
    present, parent = _window(W, N)
    uncommitted = present.copy()
    stakes = np.ones((N,), np.int32)
    offs = np.full((B,), W - 1, np.int32)
    leaders = np.arange(B, dtype=np.int32) % N
    onehots = np.zeros((B, N), np.uint8)
    onehots[np.arange(B), leaders] = 1
    last_committed = np.zeros((N,), np.int32)
    committed, support, new_last = consensus_step_sharded(
        mesh, parent, uncommitted, stakes, offs, onehots, leaders, last_committed)
    if tuple(committed.shape) != (B, W, N):
        raise AssertionError(f"committed has shape {tuple(committed.shape)}")
    # Host recomputation of leader support (the kernel's contract).
    sup_np = np.array(
        [(parent[W - 1, :, l].astype(bool) & uncommitted[W - 1].astype(bool)).sum()
         for l in leaders], np.int32)
    if not np.array_equal(support.cpu().numpy(), sup_np):
        raise AssertionError("sharded support != host")
    m = committed.cpu().numpy()
    quorum = stakes.sum() // 3 + 1
    for b in range(B):
        if sup_np[b] >= quorum and not m[b, W - 1, leaders[b]]:
            raise AssertionError("a committed walk must include its leader")
    if int(new_last.max()) < W - 1:
        raise AssertionError("the top-round walk must commit its leader")
    return [t.device for t in (committed, support, new_last)]


def _engine_leg(mesh):
    from .consensus import Bullshark, ConsensusState
    from .fixtures import CommitteeFixture, make_certificates
    from .gpu.dag_kernels import GpuBullshark
    from .stores import NodeStorage
    from .types import Certificate

    f = CommitteeFixture(size=7)
    genesis = {c.digest for c in Certificate.genesis(f.committee)}
    certs, _ = make_certificates(f.committee, 1, 14, genesis, failure_probability=0.1,
                                 rng=random.Random(0))
    host_state = ConsensusState(Certificate.genesis(f.committee))
    dev_state = ConsensusState(Certificate.genesis(f.committee))
    host = Bullshark(f.committee, NodeStorage(None).consensus_store, 50)
    dev = GpuBullshark(f.committee, NodeStorage(None).consensus_store, 50, mesh=mesh)
    devices = []  # where each commit event's masks were computed
    dispatch = dev._dispatch_commit

    def recorded(*a):
        res = dispatch(*a)
        if res is not None:
            devices.extend(res[0].devices)
        return res

    dev._dispatch_commit = recorded
    host_seq, dev_seq = [], []
    hi = di = 0
    for c in certs:
        hs = host.process_certificate(host_state, hi, c)
        ds = dev.process_certificate(dev_state, di, c)
        hi += len(hs)
        di += len(ds)
        host_seq.extend(o.certificate.digest for o in hs)
        dev_seq.extend(o.certificate.digest for o in ds)
    if host_seq != dev_seq:
        raise AssertionError("mesh-sharded engine diverged from host engine")
    if not dev_seq:
        raise AssertionError("dry run must exercise at least one commit")
    if host_state.last_committed != dev_state.last_committed:
        raise AssertionError("mesh-sharded engine's last_committed != host")
    if dev.win.N % mesh.shape["auth"]:
        raise AssertionError(f"window of {dev.win.N} does not divide the auth axis")
    return devices


def _verifier_leg(devices, mode: str):
    from .crypto import KeyPair
    from .gpu.verifier import GpuVerifier, data_mesh

    vmesh = data_mesh(len(devices), devices=devices)
    kp = KeyPair.generate()
    items = [(kp.public, b"m%d" % i, kp.sign(b"m%d" % i)) for i in range(31)]
    items.append((kp.public, b"forged", kp.sign(b"not-forged")))
    t0 = time.perf_counter()
    sharded = GpuVerifier(max_bucket=32, msm_min_bucket=16, mode=mode, mesh=vmesh)
    got = sharded(items)
    first_wall = time.perf_counter() - t0
    if got[:-1] != [True] * 31 or got[-1] is not False:
        raise AssertionError(f"sharded {mode} verdicts diverged from the known batch")
    t1 = time.perf_counter()
    again = sharded(items)
    steady = time.perf_counter() - t1
    if again != got:
        raise AssertionError(f"sharded {mode} verdicts are not stable")
    print(f"[dryrun] leg=sharded_verifier[{mode}] first_wall={first_wall:.1f}s "
          f"steady_dispatch={steady:.2f}s", flush=True)
    return vmesh.devices
