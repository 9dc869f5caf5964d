"""Parity of the PyTorch port's DAG kernels and engine with the JAX package.

The plain PyTorch versions of `reach_mask`, `roll_window`, `place_batch`
and `chain_commit` (narwhal_tpu_torch.gpu.dag_kernels) against the jitted
JAX kernels on the same numpy inputs, and `GpuBullshark(device="cpu")`
against the JAX host `Bullshark` and `TpuBullshark` on the same DAGs:
identical masks, identical commit sequences (digest and consensus_index).
The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import random

import numpy as np
import pytest
import torch

import chip_smoke
from narwhal_tpu.consensus import Bullshark, Tusk, ConsensusState as JState
from narwhal_tpu.fixtures import CommitteeFixture as JFixture
from narwhal_tpu.fixtures import make_certificates as j_make_certificates
from narwhal_tpu.stores import NodeStorage as JStorage
from narwhal_tpu.tpu import dag_kernels as jd
from narwhal_tpu.types import Certificate as JCert
from narwhal_tpu_torch.consensus import ConsensusState
from narwhal_tpu_torch.fixtures import CommitteeFixture, make_certificates
from narwhal_tpu_torch.gpu import dag_kernels as td
from narwhal_tpu_torch.stores import NodeStorage
from narwhal_tpu_torch.types import Certificate

GC = 50


def fixed_leader(committee, round, dag):
    """The reference pins the leader to the first authority in tests."""
    return dag.get(round, {}).get(committee.authority_keys()[0])


def _window(seed, w, n, density=0.6):
    rng = np.random.default_rng(seed)
    parent = (rng.random((w, n, n)) < density).astype(np.uint8)
    present = (rng.random((w, n)) < 0.85).astype(np.uint8)
    return rng, parent, present


# -- kernels: plain vs the jitted JAX programs ------------------------------


@pytest.mark.parametrize("w,n", [(16, 4), (64, 10)])
def test_reach_mask_matches_jax(w, n):
    rng, parent, present = _window(w * n, w, n)
    for start in (w - 1, w // 2, 0):
        onehot = np.zeros(n, np.uint8)
        onehot[rng.integers(0, n)] = 1
        got = td.reach_mask(torch.from_numpy(parent), torch.from_numpy(present), start,
                            torch.from_numpy(onehot))
        want = np.asarray(jd.reach_mask(parent, present, np.int32(start), onehot))
        assert np.array_equal(got.numpy(), want)


def test_reach_mask_simple_chain():
    # (2,0) -> (1,1) -> (0,0); (1,0) unlinked. A committed relay blocks.
    parent = np.zeros((3, 2, 2), np.uint8)
    present = np.ones((3, 2), np.uint8)
    parent[2, 0, 1] = 1
    parent[1, 1, 0] = 1
    onehot = torch.tensor([1, 0], dtype=torch.uint8)
    mask = td.reach_mask(torch.from_numpy(parent), torch.from_numpy(present), 2, onehot)
    assert mask.tolist() == [[True, False], [False, True], [True, False]]
    unc = present.copy()
    unc[1, 1] = 0
    mask2 = td.reach_mask(torch.from_numpy(parent), torch.from_numpy(unc), 2, onehot)
    assert mask2.tolist() == [[False, False], [False, False], [True, False]]


@pytest.mark.parametrize("shift", [0, 1, 15, 16, 20])
def test_roll_window_matches_jax(shift):
    _rng, parent, present = _window(5, 16, 6)
    gp, gq = td.roll_window(torch.from_numpy(parent), torch.from_numpy(present), shift)
    wp, wq = jd.roll_window(parent.copy(), present.copy(), np.int32(shift))
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    assert np.array_equal(gq.numpy(), np.asarray(wq))


def test_roll_window_rejects_negative_shift():
    _rng, parent, present = _window(5, 4, 3)
    with pytest.raises(ValueError):
        td.roll_window(torch.from_numpy(parent), torch.from_numpy(present), -1)


@pytest.mark.parametrize("T,live", [(8, 6), (1, 1), (4, 0)])
def test_place_batch_matches_jax_with_duplicates_and_padding(T, live):
    rng, parent, present = _window(7 + T, 32, 8)
    cells = rng.choice(32 * 8, T, replace=False)  # distinct, then a duplicate
    offs, idxs = (cells // 8).astype(np.int32), (cells % 8).astype(np.int32)
    rows = (rng.random((T, 8)) < 0.5).astype(np.uint8)
    valid = np.zeros(T, np.uint8)
    valid[:live] = 1
    if T >= 8:  # a duplicate slot carries the identical row
        offs[5], idxs[5], rows[5] = offs[1], idxs[1], rows[1]
    gp, gq = td.place_batch(
        torch.from_numpy(parent.copy()), torch.from_numpy(present.copy()),
        torch.from_numpy(offs), torch.from_numpy(idxs), torch.from_numpy(rows),
        torch.from_numpy(valid),
    )
    wp, wq = jd.place_batch(parent.copy(), present.copy(), offs, idxs, rows, valid)
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    assert np.array_equal(gq.numpy(), np.asarray(wq))


SYNC_W = 8


@pytest.mark.parametrize("T", [0, 1, 64])
@pytest.mark.parametrize("n", [49, 50, 65])
@pytest.mark.parametrize("shift", [0, 1, SYNC_W - 1, SYNC_W, SYNC_W + 5])
def test_sync_window_matches_jax_roll_then_place(shift, n, T):
    """sync_window on the CPU (the plain roll then place) bit-equal to the
    JAX roll_window then place_batch, as the JAX device_view runs them: T
    = 64 carries four duplicate slots and two offsets below the rolled
    window, which the JAX device_view drops before it places."""
    rng = np.random.default_rng(shift * 1000 + n * 10 + T)
    parent = (rng.random((SYNC_W, n, n)) < 0.6).astype(np.uint8)
    present = (rng.random((SYNC_W, n)) < 0.85).astype(np.uint8)
    offs, idxs, rows = chip_smoke.sync_slots(rng, SYNC_W, n, T, n_below=2 if T >= 8 else 0)
    gp, gq = td.sync_window(torch.from_numpy(parent), torch.from_numpy(present), shift,
                            offs, idxs, rows)
    wp, wq = jd.roll_window(parent.copy(), present.copy(), np.int32(shift))
    live = offs >= 0
    if live.any():
        wp, wq = jd.place_batch(wp, wq, offs[live], idxs[live], rows[live],
                                np.ones(int(live.sum()), np.uint8))
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    assert np.array_equal(gq.numpy(), np.asarray(wq))


def test_sync_window_rejects_negative_shift_and_slots_on_a_device():
    _rng, parent, present = _window(5, 4, 3)
    p, q = torch.from_numpy(parent), torch.from_numpy(present)
    no = np.zeros(0, np.int32)
    with pytest.raises(ValueError, match="shift"):
        td.sync_window(p, q, -1, no, no, np.zeros((0, 3), np.uint8))
    with pytest.raises(ValueError, match="rows"):
        td.sync_window(p, q, 0, no, no, np.zeros((0, 4), np.uint8))


@pytest.mark.parametrize("gap", [False, True], ids=["views", "gap"])
def test_device_view_matches_jax_window(monkeypatch, gap):
    """A seeded run of inserts, slides (explicit, and by inserts past the
    window) and one grow through the port's DagWindow(device="cpu") and the
    JAX DagWindow(device_resident=True): after each step both device
    views equal each other and the host mirror, bit for bit. With `gap`,
    no view is taken for 40 rounds while the window slides on, so the base
    moves by more than 2W between two views with entries pending. The JAX
    window's full upload copies here: on the CPU backend `jnp.asarray` can
    alias the host mirror, which `slide_to` then shifts in place under the
    device copy (the reference quirk of ROADMAP queue 3)."""
    import jax.numpy as jnp

    monkeypatch.setattr(jnp, "asarray", lambda a, *args, **kw: jnp.array(a, *args, copy=True,
                                                                         **kw))
    jf, f, jc, c = _streams(size=7, rounds=70 if gap else 40, failure=0.25, seed=5)
    jwin = jd.DagWindow(jf.committee, window=8, device_resident=True)
    win = td.DagWindow(f.committee, 8, device="cpu")
    rng = random.Random(7)
    by_round: dict[int, list] = {}
    for jcert, cert in zip(jc, c):
        by_round.setdefault(cert.round, []).append((jcert, cert))
    quiet = range(22, 63) if gap else range(0)
    views = rolls = jump = 0
    for r in sorted(by_round):
        keep_floor = 0 if 12 <= r < 20 else max(0, r - 5)  # no GC in 12..19: it grows
        for jcert, cert in by_round[r]:
            assert jwin.insert(jcert, keep_floor) == win.insert(cert, keep_floor)
        if rng.random() < 0.3:  # a GC step between views drops pending entries
            base = win.round_base + rng.randint(1, 2)
            jwin.slide_to(base)
            win.slide_to(base)
        if rng.random() < 0.6 and r not in quiet:
            rolls += win._dev is not None and win.round_base != win._dev_base
            if win._dev is not None:
                jump = max(jump, win.round_base - win._dev_base)
            jp, jq = (np.asarray(x) for x in jwin.device_view())
            gp, gq = (x.numpy() for x in win.device_view())
            assert np.array_equal(gp, jp) and np.array_equal(gq, jq)
            assert np.array_equal(gp, win.parent) and np.array_equal(gq, win.present)
            assert not win._dev_pending
            views += 1
    assert win.W == jwin.W == 16 and rolls >= 3 and views >= 15
    assert (jump > 2 * win.W) == gap


@pytest.mark.parametrize("K,live", [(1, 1), (2, 2), (4, 3)])
def test_chain_commit_matches_jax(K, live):
    w, n = 32, 7
    rng, parent, present = _window(30 + K, w, n, density=0.75)
    lc = rng.integers(-2, 6, n).astype(np.int32)
    offs = np.zeros(K, np.int32)
    onehots = np.zeros((K, n), np.uint8)
    for k in range(live):  # oldest first; the remaining slots are padding
        offs[k] = 12 + 6 * k
        onehots[k, rng.integers(0, n)] = 1
    lcr = int(lc.max())
    for gc in (50, 8):
        got = td.chain_commit(
            torch.from_numpy(parent), torch.from_numpy(present), gc,
            torch.from_numpy(lc), lcr, torch.from_numpy(offs), torch.from_numpy(onehots),
        )
        want = np.asarray(
            jd.chain_commit(parent, present, np.int32(gc), lc, np.int32(lcr), offs, onehots)
        )
        assert np.array_equal(got.numpy(), want)
    assert got[:live].any()


@pytest.mark.parametrize("K,live", [(1, 1), (2, 2), (4, 3)])
def test_chain_commit_gc_filter_matches_jax(K, live):
    """A chain after a healed partition (chip_smoke.healed_partition_chain)
    where the gc filter bites: it drops reached certificates, the newest
    leader's filter uses the lcr its earlier leaders advanced, and a
    leader's own round as lcr would drop more. Plain == JAX there."""
    w, n, gc = 32, 10, 8
    host = chip_smoke.healed_partition_chain(np.random.default_rng(40 + K), w, n, gc, K, live)
    parent, present, lc, lcr, offs, onehots = host
    t = [torch.from_numpy(a) for a in (parent, present, lc, offs, onehots)]
    counts, walked = chip_smoke.gc_filter_effects(t[0], t[1], gc, t[2], lcr, t[3], t[4])
    assert counts["dropped"] > 0 and counts["by_own_round"] > 0
    assert live == 1 or counts["by_advanced_lcr"] > 0
    got = td.chain_commit(t[0], t[1], gc, t[2], lcr, t[3], t[4])
    want = np.asarray(
        jd.chain_commit(parent, present, np.int32(gc), lc, np.int32(lcr), offs, onehots)
    )
    assert np.array_equal(got.numpy(), want) and np.array_equal(walked.numpy(), want)
    bare = td.chain_commit(t[0], t[1], 10**6, t[2], lcr, t[3], t[4])
    assert not torch.equal(got, bare)


# -- the engine: GpuBullshark(device="cpu") vs the JAX engines ---------------


def _streams(size, rounds, failure, seed):
    jf, f = JFixture(size=size), CommitteeFixture(size=size)
    jc, c = _committee_streams(jf.committee, f.committee, rounds, failure, seed)
    return jf, f, jc, c


def _committee_streams(jcommittee, committee, rounds, failure, seed):
    """One certificate stream from genesis, built in both packages from one
    seed for the same committee."""
    jg = {c.digest for c in JCert.genesis(jcommittee)}
    g = {c.digest for c in Certificate.genesis(committee)}
    jc, _ = j_make_certificates(jcommittee, 1, rounds, jg,
                                failure_probability=failure, rng=random.Random(seed))
    c, _ = make_certificates(committee, 1, rounds, g,
                             failure_probability=failure, rng=random.Random(seed))
    assert [x.digest for x in jc] == [x.digest for x in c]  # one stream, two packages
    return jc, c


def _run(engine, state, certs, batch=None):
    out, i = [], 0
    if batch is None:
        for c in certs:
            outs = engine.process_certificate(state, i, c)
            i += len(outs)
            out.extend(outs)
    else:
        for lo in range(0, len(certs), batch):
            outs = engine.process_batch(state, i, certs[lo:lo + batch])
            i += len(outs)
            out.extend(outs)
    return [(o.certificate.digest, o.consensus_index) for o in out]


# (JAX host engine, JAX device engine, port engine) per commit rule
ENGINES = {
    "bullshark": (Bullshark, jd.TpuBullshark, td.GpuBullshark),
    "tusk": (Tusk, jd.TpuTusk, td.GpuTusk),
}


def _run_against_jax(size, rounds, failure, seed, gc=GC, leader_fn=fixed_leader,
                     window=None, with_tpu=False, rule="bullshark"):
    host_cls, tpu_cls, gpu_cls = ENGINES[rule]
    jf, f, jc, c = _streams(size, rounds, failure, seed)
    host_state = JState(JCert.genesis(jf.committee))
    host = host_cls(jf.committee, JStorage(None).consensus_store, gc, leader_fn=leader_fn)
    want = _run(host, host_state, jc)
    state = ConsensusState(Certificate.genesis(f.committee))
    eng = gpu_cls(f.committee, NodeStorage(None).consensus_store, gc,
                  leader_fn=leader_fn, window=window, device="cpu")
    got = _run(eng, state, c)
    assert got == want
    assert {k.hex(): v for k, v in state.last_committed.items()} == {
        k.hex(): v for k, v in host_state.last_committed.items()
    }
    if with_tpu:
        tpu_state = JState(JCert.genesis(jf.committee))
        tpu = tpu_cls(jf.committee, None, gc, leader_fn=leader_fn, window=window,
                      prewarm=False)
        assert _run(tpu, tpu_state, jc) == want
    return got, eng


def test_engine_matches_jax_engines_optimal_dag():
    got, _ = _run_against_jax(size=4, rounds=12, failure=0.0, seed=0, with_tpu=True)
    assert len(got) > 30


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_matches_host_bullshark_lossy(seed):
    _run_against_jax(size=4, rounds=25, failure=0.3, seed=seed)


def test_engine_matches_jax_engines_lossy_larger_committee():
    _run_against_jax(size=10, rounds=15, failure=0.15, seed=3, with_tpu=True)


def test_engine_weighted_leader():
    _run_against_jax(size=7, rounds=20, failure=0.2, seed=1, leader_fn=None)


def test_engine_window_slides():
    got, eng = _run_against_jax(size=4, rounds=60, failure=0.0, seed=0, gc=10, window=24)
    assert len(got) > 200
    assert eng.win.round_base > 0 and eng.win.W == 24


@pytest.mark.parametrize(
    "size,rounds,failure,seed,leader_fn",
    [(4, 14, 0.0, 0, fixed_leader), (4, 25, 0.3, 0, fixed_leader),
     (4, 25, 0.3, 1, fixed_leader), (7, 20, 0.15, 2, None)],
    ids=["optimal", "lossy-0", "lossy-1", "weighted-leader"],
)
def test_tusk_engine_matches_jax_engines(size, rounds, failure, seed, leader_fn):
    """GpuTusk(device="cpu") commits exactly as the JAX host Tusk and
    TpuTusk: the leader two rounds below the wait round."""
    got, _ = _run_against_jax(size, rounds, failure, seed, leader_fn=leader_fn,
                              with_tpu=True, rule="tusk")
    assert len(got) > 20


@pytest.mark.parametrize("rule", ["bullshark", "tusk"])
def test_recover_continues_like_the_jax_engine(rule):
    """The JAX host engine and a port engine commit the first half of a
    lossy stream. A fresh port engine rebuilt with `recover` from its
    mid-stream ConsensusState holds the window that the JAX device engine's
    `recover` builds from the JAX state, and continues with the JAX host
    engine's sequence over the second half."""
    host_cls, tpu_cls, gpu_cls = ENGINES[rule]
    jf, f, jc, c = _streams(5, 50, 0.2, 9)
    half = len(c) // 2
    jstate = JState(JCert.genesis(jf.committee))
    jhost = host_cls(jf.committee, JStorage(None).consensus_store, 10, leader_fn=fixed_leader)
    first_j = _run(jhost, jstate, jc[:half])
    state = ConsensusState(Certificate.genesis(f.committee))
    first = _run(gpu_cls(f.committee, None, 10, leader_fn=fixed_leader, window=16,
                         device="cpu"), state, c[:half])
    assert first == first_j and first
    jeng = tpu_cls(jf.committee, None, 10, leader_fn=fixed_leader, window=16, prewarm=False)
    jeng.recover(jstate)
    eng = gpu_cls(f.committee, None, 10, leader_fn=fixed_leader, window=16, device="cpu")
    eng.recover(state)
    assert eng.win.round_base == jeng.win.round_base > 0 and eng.win.W == jeng.win.W
    assert np.array_equal(eng.win.present, jeng.win.present)
    assert np.array_equal(eng.win.parent, jeng.win.parent)

    def rest(engine, st, certs):
        out, i = [], first[-1][1] + 1
        for x in certs:
            outs = engine.process_certificate(st, i, x)
            i += len(outs)
            out.extend((o.certificate.digest, o.consensus_index) for o in outs)
        return out

    want = rest(jhost, jstate, jc[half:])
    assert rest(eng, state, c[half:]) == want and len(want) > 20


def test_update_committee_gives_a_fresh_window():
    """After an epoch change the engine holds the window that the JAX
    TpuTusk's `update_committee` builds (same W, the new committee's genesis
    only) on the same device, and commits the new committee's stream as the
    JAX host Tusk and the updated TpuTusk do."""
    _jf, f, jc, c = _streams(4, 20, 0.0, 0)
    jf = JFixture(size=4)
    eng = td.GpuTusk(f.committee, None, GC, leader_fn=fixed_leader, window=24,
                     device="cpu")
    jeng = jd.TpuTusk(jf.committee, None, GC, leader_fn=fixed_leader, window=24,
                      prewarm=False)
    first = _run(eng, ConsensusState(Certificate.genesis(f.committee)), c)
    assert first == _run(jeng, JState(JCert.genesis(jf.committee)), jc) and first
    jnew, new = JFixture(size=5).committee, CommitteeFixture(size=5).committee
    eng.update_committee(new)
    jeng.update_committee(jnew)
    assert eng.committee is new and eng.win.committee is new
    assert (eng.win.W, eng.win.N, eng.win.round_base) == (jeng.win.W, jeng.win.N,
                                                           jeng.win.round_base) == (24, 5, 0)
    assert np.array_equal(eng.win.present, jeng.win.present)
    assert np.array_equal(eng.win.parent, jeng.win.parent)
    assert int(eng.win.present.sum()) == 5 and eng.win.device.type == "cpu"
    jcerts, certs = _committee_streams(jnew, new, 16, 0.2, 4)
    jhost = Tusk(jnew, JStorage(None).consensus_store, GC, leader_fn=fixed_leader)
    want = _run(jhost, JState(JCert.genesis(jnew)), jcerts)
    assert _run(jeng, JState(JCert.genesis(jnew)), jcerts) == want and want
    assert _run(eng, ConsensusState(Certificate.genesis(new)), certs) == want


def test_engine_window_grows_when_no_commits():
    f = CommitteeFixture(size=4)
    genesis = {c.digest for c in Certificate.genesis(f.committee)}
    keys = f.committee.authority_keys()[1:]  # the fixed leader never shows
    certs, _ = make_certificates(f.committee, 1, 40, genesis, keys=keys)
    state = ConsensusState(Certificate.genesis(f.committee))
    eng = td.GpuBullshark(f.committee, None, gc_depth=10, leader_fn=fixed_leader,
                          window=16, device="cpu")
    for c in certs:
        assert eng.process_certificate(state, 0, c) == []
    assert eng.win.W >= 40


def _grow_stream(fixture, make, cert_cls):
    """Rounds 1-14 with every authority, 15-40 without the fixed leader
    (nothing commits: the window must grow), 41-50 with every authority
    again (commits resume)."""
    committee = fixture.committee
    keys = committee.authority_keys()
    genesis = {x.digest for x in cert_cls.genesis(committee)}
    a, pa = make(committee, 1, 14, genesis)
    b, pb = make(committee, 15, 40, pa, keys=keys[1:])
    c, _ = make(committee, 41, 50, pb)
    return a + b + c


def test_engine_grows_then_resumes_like_jax():
    jf, f = JFixture(size=4), CommitteeFixture(size=4)
    jc = _grow_stream(jf, j_make_certificates, JCert)
    c = _grow_stream(f, make_certificates, Certificate)
    host_state = JState(JCert.genesis(jf.committee))
    host = Bullshark(jf.committee, JStorage(None).consensus_store, 10, leader_fn=fixed_leader)
    state = ConsensusState(Certificate.genesis(f.committee))
    eng = td.GpuBullshark(f.committee, None, 10, leader_fn=fixed_leader, window=16,
                          device="cpu")
    got = _run(eng, state, c)
    assert got == _run(host, host_state, jc)
    assert eng.win.W > 16 and got[-1][1] > 60


def test_process_batch_and_async_match_sequential(run):
    _jf, f, _jc, certs = _streams(4, 25, 0.2, 4)
    seq_state = ConsensusState(Certificate.genesis(f.committee))
    seq = td.GpuBullshark(f.committee, None, GC, leader_fn=fixed_leader, device="cpu")
    want = _run(seq, seq_state, certs)
    bat_state = ConsensusState(Certificate.genesis(f.committee))
    bat = td.GpuBullshark(f.committee, None, GC, leader_fn=fixed_leader, device="cpu")
    assert _run(bat, bat_state, certs, batch=7) == want  # chunks unaligned with rounds
    assert bat_state.last_committed == seq_state.last_committed

    asy_state = ConsensusState(Certificate.genesis(f.committee))
    asy = td.GpuBullshark(f.committee, None, GC, leader_fn=fixed_leader, device="cpu")

    async def batched():
        return await asy.process_batch_async(asy_state, 0, list(certs))

    out = run(batched(), timeout=120.0)
    assert [(o.certificate.digest, o.consensus_index) for o in out] == want
    assert len(want) > 10


def test_window_from_numpy_continues_a_jax_engine():
    """A JAX TpuBullshark commits the first half of a lossy stream; its
    window arrays, last-committed rounds and certificates (as wire bytes)
    carry into the port, and both engines then commit the same remainder."""
    jf, f, jc, c = _streams(5, 60, 0.2, 6)
    half = len(jc) // 2
    jstate = JState(JCert.genesis(jf.committee))
    jeng = jd.TpuBullshark(jf.committee, None, 10, leader_fn=fixed_leader, window=12,
                           prewarm=False)
    first = _run(jeng, jstate, jc[:half])
    assert first and jeng.win.round_base > 0  # it committed and slid

    keys = jf.committee.authority_keys()
    arrays = {
        "parent": jeng.win.parent, "present": jeng.win.present,
        "stakes": jeng.win.stakes, "round_base": jeng.win.round_base,
        "last_committed": np.array([jstate.last_committed[k] for k in keys]),
    }
    certs = [Certificate.from_bytes(x.to_bytes()) for x in jeng.win.certs.values()]
    win, state = td.window_from_numpy(arrays, f.committee, device="cpu", certificates=certs)
    eng = td.GpuBullshark.from_window(win, None, 10, leader_fn=fixed_leader)

    start = first[-1][1] + 1
    want, got, ji, gi = [], [], start, start
    for a, b in zip(jc[half:], c[half:]):
        outs = jeng.process_certificate(jstate, ji, a)
        ji += len(outs)
        want.extend((o.certificate.digest, o.consensus_index) for o in outs)
        outs = eng.process_certificate(state, gi, b)
        gi += len(outs)
        got.extend((o.certificate.digest, o.consensus_index) for o in outs)
    assert got == want and len(got) > 20
    assert {k.hex(): v for k, v in state.last_committed.items()} == {
        k.hex(): v for k, v in jstate.last_committed.items()
    }


def test_window_from_numpy_rejects_inconsistent_arrays():
    f = CommitteeFixture(size=4)
    win = td.DagWindow(f.committee, 8, device="cpu")
    arrays = {"parent": win.parent, "present": win.present, "stakes": win.stakes,
              "round_base": 0, "last_committed": np.zeros(4, np.int64)}
    with pytest.raises(ValueError):  # present slots without certificates
        td.window_from_numpy(arrays, f.committee, device="cpu")
    bad = dict(arrays, stakes=np.array([1, 1, 1, 2]))
    with pytest.raises(ValueError):
        td.window_from_numpy(bad, f.committee, device="cpu",
                             certificates=Certificate.genesis(f.committee))
    win2, state = td.window_from_numpy(arrays, f.committee, device="cpu",
                                       certificates=Certificate.genesis(f.committee))
    assert len(win2.certs) == 4 and state.last_committed_round == 0
