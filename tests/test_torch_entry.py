"""Parity of the port's consensus step, committee-sharded walk and driver
entry points with the JAX package.

- B5: `leader_support_plain` against the JAX `leader_support` (one scalar
  call per walk);
- B7: `consensus_step(device="cpu")` against a JAX composition built here
  as `__graft_entry__.py:229-245` builds it (a closure there): `jax.vmap`
  of `reach_mask` and `leader_support`, the quorum mask and the
  last-committed max;
- `chain_commit_sharded`, `reach_many_sharded` and `consensus_step_sharded`
  over `["cpu"] * k` meshes against the unsharded plain versions;
- `GpuBullshark(mesh=...)` / `GpuTusk(mesh=...)` against the JAX host
  engines (and once against the JAX `TpuBullshark` on an `auth` mesh of
  conftest's virtual CPU devices), as tests/test_dag_kernels.py holds the
  JAX meshed engines;
- `entry()` and `dryrun_multichip()` on CPU devices.

Tolerance: exact everywhere (masks, int32 sums, commit sequences).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from narwhal_tpu.consensus import Bullshark, ConsensusState as JState, Tusk
from narwhal_tpu.fixtures import CommitteeFixture as JFixture
from narwhal_tpu.fixtures import make_certificates as j_make_certificates
from narwhal_tpu.stores import NodeStorage as JStorage
from narwhal_tpu.tpu import dag_kernels as jd
from narwhal_tpu.types import Certificate as JCert
from narwhal_tpu_torch import entry as tentry
from narwhal_tpu_torch.config import ConfigError
from narwhal_tpu_torch.consensus import ConsensusState
from narwhal_tpu_torch.fixtures import CommitteeFixture, make_certificates
from narwhal_tpu_torch.gpu import dag_kernels as td
from narwhal_tpu_torch.gpu.mesh import DeviceMesh, auth_mesh
from narwhal_tpu_torch.stores import NodeStorage
from narwhal_tpu_torch.types import Certificate


def fixed_leader(committee, round, dag):
    """The reference pins the leader to the first authority in tests."""
    return dag.get(round, {}).get(committee.authority_keys()[0])


def _window(seed, w, n, density=0.6):
    rng = np.random.default_rng(seed)
    parent = (rng.random((w, n, n)) < density).astype(np.uint8)
    present = (rng.random((w, n)) < 0.85).astype(np.uint8)
    return rng, parent, present


def _cpu_mesh(auth, data=1):
    return auth_mesh(auth, devices=["cpu"] * (auth * data), data=data)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- B5 leader_support --------------------------------------------------------


def test_leader_support_hand_case_matches_jax():
    """tests/test_dag_kernels.py's hand case: voters 0 and 2 link leader
    (0, 2), stakes 5 + 11."""
    parent = np.zeros((2, 3, 3), np.uint8)
    present = np.ones((2, 3), np.uint8)
    stakes = np.array([5, 7, 11], np.int32)
    parent[1, 0, 2] = 1
    parent[1, 2, 2] = 1
    want = int(jd.leader_support(parent, present, stakes, np.int32(1), np.int32(2)))
    got = td.leader_support(*_t(parent, present, stakes, np.array([1], np.int32),
                                np.array([2], np.int32)))
    assert want == 16 and got.tolist() == [16] and got.dtype == torch.int32


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("w,n", [(8, 8), (16, 7)])
def test_leader_support_matches_jax(B, w, n):
    rng, parent, present = _window(100 + B + n, w, n)
    stakes = rng.integers(-3, 2**30, n).astype(np.int32)  # the sum wraps like int32
    offs = rng.integers(0, w, B).astype(np.int32)
    offs[0] = w - 1
    leaders = rng.integers(0, n, B).astype(np.int32)
    want = [int(jd.leader_support(parent, present, stakes, np.int32(o), np.int32(l)))
            for o, l in zip(offs, leaders)]
    got = td.leader_support(*_t(parent, present, stakes, offs, leaders))
    assert got.tolist() == want
    assert got.tolist() == td.leader_support_plain(*_t(parent, present, stakes, offs,
                                                       leaders)).tolist()


def test_leader_support_rejects_out_of_range():
    """What the JAX kernel returns out of range: jnp.take fills a uint8 row or
    column past the end with 255, so every authority counts as a present
    voter (support 7), and a negative offset wraps to the last row (5). The
    port's wrapper raises instead."""
    parent = np.ones((4, 3, 3), np.uint8)
    present = np.ones((4, 3), np.uint8)
    present[3, 1] = 0
    stakes = np.array([1, 2, 4], np.int32)
    jax_says = [int(jd.leader_support(parent, present, stakes, np.int32(o), np.int32(l)))
                for o, l in ((9, 0), (1, 7), (-1, 0), (1, 0))]
    assert jax_says == [7, 7, 5, 7]
    for offs, leaders in (([4], [0]), ([-1], [0]), ([0], [3]), ([1, 2], [0, -1])):
        with pytest.raises(ValueError):
            td.leader_support(*_t(parent, present, stakes, np.array(offs, np.int32),
                                  np.array(leaders, np.int32)))


@pytest.mark.parametrize("offs,leaders,named", [
    ([1, 4, 2, 0], [0, 1, 5, 2], (1, 4, 1)),
    ([0, 1, 2, -1], [0, 9, 1, 2], (1, 1, 9)),
    ([0, 0, 0, 0], [0, 1, 2, 3], (3, 0, 3)),
])
def test_leader_support_names_the_lowest_bad_walk(offs, leaders, named):
    """The CPU check raises `support_range_error` for the lowest walk with
    an offset outside [0, W) or a leader outside [0, M), as the card's
    error words name it; the error words read back give the same walk."""
    parent = np.ones((4, 3, 3), np.uint8)
    present = np.ones((4, 3), np.uint8)
    stakes = np.array([1, 2, 4], np.int32)
    walk, off, leader = named
    with pytest.raises(ValueError) as err:
        td.leader_support(*_t(parent, present, stakes, np.array(offs, np.int32),
                              np.array(leaders, np.int32)))
    assert str(err.value) == str(td.support_range_error(4, 3, walk, off, leader))
    assert f"walk {walk} has offset {off} and leader index {leader}" in str(err.value)
    none = 2**31 - 1
    words = [none, 0, 0, walk + 16, 5, 5, walk, off, leader]
    assert td.support_error(words, none) == named
    assert td.support_error([none, 0, 0], none) is None


def test_consensus_step_raises_on_an_out_of_range_leader():
    """The consensus step, unmeshed and over a 2 x 2 mesh, raises on a
    leader outside the committee and on an offset outside the window,
    rather than fill or wrap as jnp.take would."""
    parent, unc, stakes, offs, onehots, leaders, last = _step_inputs(9, 16, 7, 8)
    for field, value in (("leaders", 7), ("leaders", -1), ("offs", 16), ("offs", -2)):
        o, l = offs.copy(), leaders.copy()
        (l if field == "leaders" else o)[5] = value
        with pytest.raises(ValueError):
            td.consensus_step(*_t(parent, unc, stakes, o, onehots, l, last))
        with pytest.raises(ValueError):
            td.consensus_step_sharded(_cpu_mesh(2, 2), parent, unc, stakes, o, onehots, l,
                                      last)


# -- B7 consensus_step ------------------------------------------------------


def _jax_consensus_step(parent, uncommitted, stakes, offs, onehots, leaders, last):
    """`__graft_entry__.py:229-245`, unsharded."""
    W = parent.shape[0]
    masks = jax.vmap(jd.reach_mask, in_axes=(None, None, 0, 0))(
        parent, uncommitted, offs, onehots)
    support = jax.vmap(jd.leader_support, in_axes=(None, None, None, 0, 0))(
        parent, uncommitted, stakes, offs, leaders)
    quorum = jnp.sum(stakes) // 3 + 1
    committed = masks & (support >= quorum)[:, None, None]
    rounds = jnp.arange(W, dtype=jnp.int32)[None, :, None]
    new_last = jnp.maximum(
        last, jnp.max(committed.astype(jnp.int32) * rounds, axis=(0, 1)))
    return committed, support, new_last


def _step_inputs(seed, w, n, b):
    rng, parent, present = _window(seed, w, n, density=0.45)
    stakes = rng.integers(1, 5, n).astype(np.int32)
    offs = rng.integers(w // 2, w, b).astype(np.int32)
    offs[0] = w - 1
    leaders = rng.integers(0, n, b).astype(np.int32)
    onehots = np.zeros((b, n), np.uint8)
    onehots[np.arange(b), leaders] = 1
    last = rng.integers(-2, w, n).astype(np.int32)
    return parent, present, stakes, offs, onehots, leaders, last


@pytest.mark.parametrize("w,n", [(8, 8), (16, 7)])
def test_consensus_step_matches_jax_composition(w, n):
    inputs = _step_inputs(w + n, w, n, 8)
    want = [np.asarray(x) for x in _jax_consensus_step(*inputs)]
    got = td.consensus_step(*_t(*inputs))
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), x)
    # Some walks commit, some fall short of the quorum.
    assert 0 < int((want[1] >= inputs[2].sum() // 3 + 1).sum()) < 8


def test_consensus_commit_straddles_the_quorum():
    masks = torch.ones((3, 4, 2), dtype=torch.bool)
    stakes = torch.tensor([3, 3], dtype=torch.int32)  # quorum 3
    support = torch.tensor([2, 3, 0], dtype=torch.int32)
    last = torch.tensor([-5, 7], dtype=torch.int32)
    committed, new_last = td.consensus_commit(masks, support, stakes, last)
    assert committed[:, 0, 0].tolist() == [False, True, False]
    assert new_last.tolist() == [3, 7]


# -- the committee-sharded walk ----------------------------------------------


@pytest.mark.parametrize("auth,n", [(1, 8), (2, 8), (4, 8), (2, 7)])
def test_reach_many_sharded_matches_plain(auth, n):
    w = 16
    rng, parent, present = _window(auth * 10 + n, w, n, density=0.4)
    offs = np.array([w - 1, w // 2, 3, 0, 0], np.int32)
    onehots = np.zeros((5, n), np.uint8)
    cols = rng.integers(0, n, 4)
    onehots[np.arange(4), cols] = 1  # the last slot pads
    present[offs[:4], cols] = 1  # a walk starts at a certificate
    want = td.reach_many_plain(*_t(parent, present, offs, onehots))
    got = td.reach_many_sharded(_cpu_mesh(auth), parent, present, offs, onehots)
    assert torch.equal(got, want) and int(want.sum()) > 8


@pytest.mark.parametrize("auth,n", [(1, 8), (2, 8), (4, 8), (2, 7)])
def test_chain_commit_sharded_matches_plain(auth, n):
    """The gc filter bites and lcr advances between leaders
    (chip_smoke.healed_partition_chain); a padding slot is a no-op."""
    import chip_smoke

    w, gc = 24, 8
    host = chip_smoke.healed_partition_chain(np.random.default_rng(auth + n), w, n, gc, 4, 3)
    parent, present, lc, lcr, offs, onehots = host
    for g in (gc, 50):
        want = td.chain_commit_plain(*_t(parent, present), g, *_t(lc), lcr,
                                     *_t(offs, onehots))
        got = td.chain_commit_sharded(_cpu_mesh(auth), parent, present, g, lc, lcr, offs,
                                      onehots)
        assert torch.equal(got, want) and want[:3].any()


def test_consensus_step_sharded_matches_unsharded():
    inputs = _step_inputs(5, 16, 7, 8)
    want = td.consensus_step(*_t(*inputs))
    for auth, data in ((2, 2), (1, 4), (4, 1)):
        got = td.consensus_step_sharded(_cpu_mesh(auth, data), *inputs)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    with pytest.raises(ValueError):  # 8 walks do not split over 3 data rows
        td.consensus_step_sharded(_cpu_mesh(1, 3), *inputs)


# -- the meshed engines against the JAX host engines -------------------------


def _jax_auth_mesh(auth):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices("cpu")[:auth]), ("auth",))


def _run(engine, state, certs):
    out, i = [], 0
    for c in certs:
        outs = engine.process_certificate(state, i, c)
        i += len(outs)
        out.extend((o.certificate.digest, o.consensus_index) for o in outs)
    return out


def _meshed_against_jax(size, rounds, failure, seed, mesh, gc=50, leader_fn=fixed_leader,
                        window=None, rule="bullshark", jax_mesh=None):
    jf, f = JFixture(size=size), CommitteeFixture(size=size)
    jc, _ = j_make_certificates(jf.committee, 1, rounds,
                                {c.digest for c in JCert.genesis(jf.committee)},
                                failure_probability=failure, rng=random.Random(seed))
    c, _ = make_certificates(f.committee, 1, rounds,
                             {x.digest for x in Certificate.genesis(f.committee)},
                             failure_probability=failure, rng=random.Random(seed))
    host_cls, tpu_cls, gpu_cls = {"bullshark": (Bullshark, jd.TpuBullshark, td.GpuBullshark),
                                  "tusk": (Tusk, jd.TpuTusk, td.GpuTusk)}[rule]
    jstate = JState(JCert.genesis(jf.committee))
    want = _run(host_cls(jf.committee, JStorage(None).consensus_store, gc,
                         leader_fn=leader_fn), jstate, jc)
    state = ConsensusState(Certificate.genesis(f.committee))
    eng = gpu_cls(f.committee, NodeStorage(None).consensus_store, gc, leader_fn=leader_fn,
                  window=window, mesh=mesh)
    assert _run(eng, state, c) == want and want
    assert {k.hex(): v for k, v in state.last_committed.items()} == {
        k.hex(): v for k, v in jstate.last_committed.items()}
    if jax_mesh is not None:
        tpu = tpu_cls(jf.committee, None, gc, leader_fn=leader_fn, window=window,
                      mesh=jax_mesh, prewarm=False)
        assert _run(tpu, JState(JCert.genesis(jf.committee)), jc) == want
        assert (eng.win.N, eng.win.W) == (tpu.win.N, tpu.win.W)
        assert np.array_equal(eng.win.parent, tpu.win.parent)
    return eng


@pytest.mark.parametrize(
    "size,rounds,failure,seed,auth,data,leader_fn,rule",
    [(4, 20, 0.2, 0, 4, 1, fixed_leader, "bullshark"),
     (7, 15, 0.15, 1, 2, 1, None, "bullshark"),
     (4, 20, 0.3, 3, 2, 2, fixed_leader, "bullshark"),
     (4, 20, 0.3, 2, 2, 1, fixed_leader, "tusk")],
    ids=["auth4", "padded-7-over-2", "data2-auth2", "tusk-auth2"],
)
def test_meshed_engine_matches_jax_host(size, rounds, failure, seed, auth, data,
                                        leader_fn, rule):
    eng = _meshed_against_jax(size, rounds, failure, seed, _cpu_mesh(auth, data),
                              leader_fn=leader_fn, rule=rule)
    assert eng.win.N % auth == 0 and eng.win.N == -(-size // auth) * auth
    assert eng.win.stakes[size:].sum() == 0 and eng.win.present[:, size:].sum() == 0
    assert eng.win._dev is None and not eng.win._dev_pending  # the host mirror only


def test_meshed_engine_matches_jax_meshed_engine():
    """The padded committee over two shards against the JAX TpuBullshark on
    an `auth` mesh of two virtual CPU devices: same sequence, same padded
    window."""
    _meshed_against_jax(7, 15, 0.15, 1, _cpu_mesh(2), leader_fn=None,
                        jax_mesh=_jax_auth_mesh(2))


def test_meshed_engine_window_slides_and_grows():
    eng = _meshed_against_jax(4, 60, 0.0, 0, _cpu_mesh(4), gc=10, window=24)
    assert eng.win.round_base > 0 and eng.win.W == 24

    def grow_stream(committee, make, cert_cls):
        """Rounds 15-40 lack the fixed leader: nothing commits, W grows."""
        keys = committee.authority_keys()
        a, pa = make(committee, 1, 14, {x.digest for x in cert_cls.genesis(committee)})
        b, pb = make(committee, 15, 40, pa, keys=keys[1:])
        c, _ = make(committee, 41, 50, pb)
        return a + b + c

    jf, f = JFixture(size=4), CommitteeFixture(size=4)
    host = _run(Bullshark(jf.committee, JStorage(None).consensus_store, 10,
                          leader_fn=fixed_leader),
                JState(JCert.genesis(jf.committee)),
                grow_stream(jf.committee, j_make_certificates, JCert))
    eng = td.GpuBullshark(f.committee, None, 10, leader_fn=fixed_leader, window=16,
                          mesh=_cpu_mesh(2))
    got = _run(eng, ConsensusState(Certificate.genesis(f.committee)),
               grow_stream(f.committee, make_certificates, Certificate))
    assert got == host and eng.win.W > 16 and host[-1][1] > 60


def test_mesh_growth_walks_the_grown_window(monkeypatch):
    """After _grow() doubles W, a meshed engine's commit still goes through
    the sharded walk over its mesh, at the new W, and never the unsharded
    chain_commit (the port's form of the JAX test that the dispatch is
    re-derived for the new shape)."""
    from narwhal_tpu_torch.fixtures import mock_certificate

    calls = []
    sharded = td.chain_commit_sharded

    def spy(mesh, parent, *rest):
        calls.append((mesh, np.asarray(parent).shape[0]))
        return sharded(mesh, parent, *rest)

    def refused(*a):
        raise AssertionError("the unsharded chain_commit ran on a meshed engine")

    monkeypatch.setattr(td, "chain_commit_sharded", spy)
    monkeypatch.setattr(td, "chain_commit", refused)
    mesh = _cpu_mesh(2)
    f = CommitteeFixture(size=4)
    keys = f.committee.authority_keys()
    certs, _ = make_certificates(f.committee, 1, 40, {c.digest for c in
                                                      Certificate.genesis(f.committee)},
                                 keys=keys[1:])
    state = ConsensusState(Certificate.genesis(f.committee))
    eng = td.GpuBullshark(f.committee, None, gc_depth=10, leader_fn=fixed_leader,
                          window=16, mesh=mesh)
    for c in certs:
        assert eng.process_certificate(state, 0, c) == []
    assert eng.win.W >= 40 and not calls
    lead = mock_certificate(f.committee, keys[0], 40, set())
    assert eng.process_certificate(state, 0, lead) == []
    outs = []
    for sup_key in keys[1:3]:  # f + 1 = 2 supporters
        outs = eng.process_certificate(
            state, 0, mock_certificate(f.committee, sup_key, 41, {lead.digest}))
        if outs:
            break
    assert outs and outs[-1].certificate.digest == lead.digest
    assert calls == [(mesh, eng.win.W)]


def test_meshed_engine_recovers_and_changes_committee():
    """`recover` rebuilds the padded host window, and `update_committee`
    pads the new committee anew: both keep committing like the host."""
    jf, f = JFixture(size=5), CommitteeFixture(size=5)
    jc, _ = j_make_certificates(jf.committee, 1, 50,
                                {c.digest for c in JCert.genesis(jf.committee)},
                                failure_probability=0.2, rng=random.Random(9))
    c, _ = make_certificates(f.committee, 1, 50,
                             {x.digest for x in Certificate.genesis(f.committee)},
                             failure_probability=0.2, rng=random.Random(9))
    half = len(c) // 2
    jstate = JState(JCert.genesis(jf.committee))
    jhost = Bullshark(jf.committee, JStorage(None).consensus_store, 10,
                      leader_fn=fixed_leader)
    first = _run(jhost, jstate, jc[:half])
    state = ConsensusState(Certificate.genesis(f.committee))
    mesh = _cpu_mesh(2)
    assert _run(td.GpuBullshark(f.committee, None, 10, leader_fn=fixed_leader, window=16,
                                mesh=mesh), state, c[:half]) == first
    eng = td.GpuBullshark(f.committee, None, 10, leader_fn=fixed_leader, window=16,
                          mesh=mesh)
    eng.recover(state)
    assert eng.win.N == 6 and eng.win.round_base > 0

    def rest(engine, st, certs):
        out, i = [], first[-1][1] + 1
        for x in certs:
            outs = engine.process_certificate(st, i, x)
            i += len(outs)
            out.extend((o.certificate.digest, o.consensus_index) for o in outs)
        return out

    want = rest(jhost, jstate, jc[half:])
    assert rest(eng, state, c[half:]) == want and want

    new = CommitteeFixture(size=7).committee
    eng.update_committee(new)
    assert (eng.win.N, eng.win.W, eng.win.round_base) == (8, 16, 0)
    assert int(eng.win.present.sum()) == 7 and eng.win.stakes[7] == 0
    jnew = JFixture(size=7).committee
    jcerts, _ = j_make_certificates(jnew, 1, 12, {x.digest for x in JCert.genesis(jnew)},
                                    failure_probability=0.1, rng=random.Random(2))
    certs, _ = make_certificates(new, 1, 12, {x.digest for x in Certificate.genesis(new)},
                                 failure_probability=0.1, rng=random.Random(2))
    want = _run(Bullshark(jnew, JStorage(None).consensus_store, 10, leader_fn=fixed_leader),
                JState(JCert.genesis(jnew)), jcerts)
    assert _run(eng, ConsensusState(Certificate.genesis(new)), certs) == want and want


# -- the mesh and the driver entry points --------------------------------------


def test_auth_mesh_layout_and_refusals():
    mesh = auth_mesh(2, devices=["cpu"] * 5, data=2)
    assert mesh.shape == {"data": 2, "auth": 2} and mesh.axes == ("data", "auth")
    assert mesh.devices == ((torch.device("cpu"),) * 2,) * 2
    assert len(mesh.rows("auth")) == 2 and len(mesh.rows("data")) == 2
    one = DeviceMesh(["cpu"] * 3, ("auth",))
    assert one.shape == {"auth": 3} and one.rows("auth") == [(torch.device("cpu"),) * 3]
    with pytest.raises(ConfigError):
        auth_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ConfigError):
        auth_mesh(0, devices=["cpu"])
    with pytest.raises(ConfigError):
        auth_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ConfigError):  # an engine needs the auth axis
        td.GpuBullshark(CommitteeFixture(size=4).committee, None, 10,
                        mesh=DeviceMesh(["cpu"] * 2, ("data",)))


def test_entry_matches_jax_entry():
    jfn, jargs = jentry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = tentry.entry(device="cpu")
    got = fn(*args)
    assert tuple(got.shape) == (1, 64, 32) and all(a.device.type == "cpu" for a in args)
    assert np.array_equal(got[0].numpy(), want) and want.sum() > 64


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_dryrun_multichip_on_cpu_devices(n, capsys):
    tentry.dryrun_multichip(n, devices=["cpu"] * n)
    out = capsys.readouterr().out
    assert "leg=sharded_consensus_step" in out
    assert "leg=production_engine_equivalence" in out
    assert f'"n_devices": {n}' in out


def test_dryrun_multichip_refuses_too_few_devices():
    with pytest.raises(ConfigError):
        tentry.dryrun_multichip(4, devices=["cpu"] * 3)
