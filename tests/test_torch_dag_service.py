"""Parity of the port's external-consensus Dag service with the JAX package.

`narwhal_tpu_torch.consensus.Dag(backend="cuda", device="cpu")` serves its
device-routed causal reads through `reach_many`'s plain version (the CUDA
kernel's CPU twin); it is held against the JAX package's
`Dag(backend="tpu")` and host `Dag` on the same certificates, built in both
packages from one seed: identical digest lists, in the canonical order,
from `read_causal` and `node_read_causal`. Also the service's coalescing,
metrics, cost model, shutdown, adaptive routing and failed-launch
behaviour, and `reach_many_plain` against the vmapped JAX `reach_mask`.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import asyncio
import random

import jax
import numpy as np
import pytest
import torch

from chip_smoke import DispatchLog
from narwhal_tpu.consensus import Dag as JDag
from narwhal_tpu.fixtures import CommitteeFixture as JFixture
from narwhal_tpu.fixtures import mock_certificate as j_mock_certificate
from narwhal_tpu.tpu import dag_kernels as jd
from narwhal_tpu.types import Certificate as JCert
from narwhal_tpu_torch.consensus import Dag, ValidatorDagError
from narwhal_tpu_torch.consensus.metrics import ConsensusMetrics
from narwhal_tpu_torch.fixtures import CommitteeFixture, mock_certificate
from narwhal_tpu_torch.gpu import dag_kernels as td
from narwhal_tpu_torch.metrics import Registry
from narwhal_tpu_torch.types import Certificate

W = 16


def _dag_rounds(fixture, mock, cert_cls, seed, rounds, payload_p=0.5, full=False):
    """Certificates of `rounds` rounds over a size-4 committee: each links a
    random quorum-or-more of the round below (all of it when `full`), about
    `payload_p` of them carry a payload (the rest are empty, so the DAG
    compresses them away as interiors)."""
    rng = random.Random(seed)
    committee = fixture.committee
    prev = [c.digest for c in cert_cls.genesis(committee)]
    certs = []
    for r in range(1, rounds + 1):
        cur = []
        for i, pk in enumerate(committee.authority_keys()):
            payload = {bytes([r % 256, i]) * 16: 0} if rng.random() < payload_p else {}
            parents = set(prev) if full else set(rng.sample(prev, k=max(3, len(prev) - 1)))
            cur.append(mock(committee, pk, r, parents, payload=payload))
        prev = [c.digest for c in cur]
        certs.extend(cur)
    return certs


def _both(seed, rounds, **kw):
    """The same certificates in both packages (asserted by digest)."""
    jf, f = JFixture(size=4), CommitteeFixture(size=4)
    jc = _dag_rounds(jf, j_mock_certificate, JCert, seed, rounds, **kw)
    c = _dag_rounds(f, mock_certificate, Certificate, seed, rounds, **kw)
    assert [x.digest for x in jc] == [x.digest for x in c]
    return jf, f, jc, c


def _port_dev(f):
    return Dag(f.committee, backend="cuda", window=W, policy="device", device="cpu")


# -- read parity with the JAX services ---------------------------------------


@pytest.mark.parametrize("trial", range(4))
def test_device_read_causal_matches_jax_services(run, trial):
    """Random DAGs with mixed payloads (compressible interiors) and a
    removal: the port's device service answers exactly as the JAX device
    service, the JAX host service and the port's host service."""
    jf, f, jc, c = _both(trial, 6)
    victim = random.Random(100 + trial).randrange(len(c) // 2)

    async def scenario():
        services = [
            JDag(jf.committee),
            JDag(jf.committee, backend="tpu", window=W, policy="device"),
            Dag(f.committee),
            _port_dev(f),
        ]
        for a, b in zip(jc, c):
            for s, cert in zip(services, (a, a, b, b)):
                await s.insert(cert)
        for s, certs in zip(services, (jc, jc, c, c)):
            await s.remove([certs[victim].digest])
        for a, b in zip(jc[-8:], c[-8:]):
            want = await services[0].read_causal(a.digest)
            assert want[0] == a.digest
            for s, cert in zip(services[1:], (a, b, b)):
                assert await s.read_causal(cert.digest) == want, (trial, cert.round)
            want_n = await services[0].node_read_causal(a.origin, a.round)
            for s, cert in zip(services[1:], (a, b, b)):
                assert await s.node_read_causal(cert.origin, cert.round) == want_n
        stats = services[3].routing_stats()
        assert stats["dev_calls"] == 16 and stats["host_calls"] == 0
        assert services[1].routing_stats()["dev_calls"] == 16

    run(scenario(), timeout=180.0)


@pytest.mark.parametrize("removals", [False, True], ids=["grows", "slides"])
def test_device_reads_across_window_growth_and_slides(run, removals):
    """40 rounds through a W = 16 window. Without removals the live floor
    stays at 0 and the window doubles; with removals below a horizon of 8
    rounds (and the sweep that `rounds` runs) it slides at W = 16. Every
    read over the live window equals the JAX host service's."""
    jf, f, jc, c = _both(7, 40, payload_p=0.6)

    async def scenario():
        jhost, host, dev = JDag(jf.committee), Dag(f.committee), _port_dev(f)
        disp = DispatchLog(dev)
        j_gen = [x.digest for x in JCert.genesis(jf.committee)]
        gen = [x.digest for x in Certificate.genesis(f.committee)]
        for r in range(1, 41):
            for a, b in zip(jc[4 * (r - 1):4 * r], c[4 * (r - 1):4 * r]):
                await jhost.insert(a)
                await host.insert(b)
                await dev.insert(b)
            if removals and r % 4 == 0 and r > 8:
                old_j = [x.digest for x in jc if x.round <= r - 8] + j_gen
                old = [x.digest for x in c if x.round <= r - 8] + gen
                await jhost.remove(old_j)
                await host.remove(old)
                await dev.remove(old)
                key = f.committee.authority_keys()[0]
                assert (await jhost.rounds(jf.committee.authority_keys()[0])) == (
                    await host.rounds(key)) == (await dev.rounds(key))
            if r % 8 == 0:
                for a, b in zip(jc[4 * (r - 6):4 * r:3], c[4 * (r - 6):4 * r:3]):
                    if not await jhost.contains(a.digest):  # swept interior
                        assert not await dev.contains(b.digest)
                        with pytest.raises(ValidatorDagError):
                            await dev.read_causal(b.digest)
                        continue
                    want = await jhost.read_causal(a.digest)
                    assert await dev.read_causal(b.digest) == want
                    assert await host.read_causal(b.digest) == want
                    assert await dev.node_read_causal(b.origin, b.round) == want
        return dev, disp

    dev, disp = run(scenario(), timeout=180.0)
    assert dev.routing_stats()["host_calls"] == 0
    assert dev.routing_stats()["dev_calls"] == sum(disp.sizes) > 0
    if removals:
        assert dev._win.W == W and dev._win.round_base > 16
    else:
        assert dev._win.W > W and dev._win.round_base == 0


def test_concurrent_reads_coalesce_into_one_dispatch(run):
    jf, f, jc, c = _both(3, 4, payload_p=1.0, full=True)

    async def scenario():
        jhost, dev = JDag(jf.committee), _port_dev(f)
        for a, b in zip(jc, c):
            await jhost.insert(a)
            await dev.insert(b)
        disp = DispatchLog(dev)
        results = await asyncio.gather(*(dev.read_causal(x.digest) for x in c[-4:]))
        assert disp.sizes == [4], "concurrent reads must share one dispatch"
        for a, got in zip(jc[-4:], results):
            assert got == await jhost.read_causal(a.digest)

    run(scenario(), timeout=60.0)


def test_coalesced_batch_equivalent_to_sequential_host_walks(run):
    """K = 8 concurrent reads with distinct starts across rounds 2..5 (some
    with empty payloads) fuse into one reach_many call whose answers equal
    8 sequential JAX host walks, byte for byte."""
    jf, f = JFixture(size=4), CommitteeFixture(size=4)

    def build(fixture, mock, cert_cls):
        keys = fixture.committee.authority_keys()
        prev = [x.digest for x in cert_cls.genesis(fixture.committee)]
        out = []
        for r in range(1, 6):
            cur = [mock(fixture.committee, pk, r, set(prev),
                        payload={bytes([r, i]) * 16: 0} if (r + i) % 3 else {})
                   for i, pk in enumerate(keys)]
            prev = [x.digest for x in cur]
            out.extend(cur)
        return out

    jc, c = build(jf, j_mock_certificate, JCert), build(f, mock_certificate, Certificate)

    async def scenario():
        jhost, dev = JDag(jf.committee), _port_dev(f)
        for a, b in zip(jc, c):
            await jhost.insert(a)
            await dev.insert(b)
        starts = [i for i, x in enumerate(c) if x.round >= 2][:8]
        disp = DispatchLog(dev)
        fused = await asyncio.gather(*(dev.read_causal(c[i].digest) for i in starts))
        assert disp.sizes == [8]
        assert dev.routing_stats()["last_coalesced_batch"] == 8
        for i, got in zip(starts, fused):
            assert got == await jhost.read_causal(jc[i].digest)
            assert all(isinstance(d, bytes) for d in got)

    run(scenario(), timeout=60.0)


def test_read_metrics_and_cost_model(run):
    """Per-route latency and EWMA metrics and the coalesced-batch gauge are
    recorded, and a device dispatch priced far below the host's per-vertex
    cost pulls adaptive traffic onto the device path."""
    _jf, f, _jc, c = _both(5, 4, payload_p=1.0, full=True)

    async def scenario():
        registry = Registry()
        dag = Dag(f.committee, backend="cuda", window=W, device="cpu",
                  metrics=ConsensusMetrics(registry))
        for b in c:
            await dag.insert(b)
        tip = c[-4]
        await dag.read_causal(tip.digest)  # first adaptive request: host
        await dag.read_causal(tip.digest)  # then the device is probed
        dag._host_pv = 0.010
        dag._dev_dispatch = 1e-6
        for _ in range(10):
            await dag.read_causal(tip.digest)
        stats = dag.routing_stats()
        assert stats["dev_calls"] >= 10 and stats["host_us_per_vertex"] is not None
        hist = "consensus_dag_read_causal_latency_seconds"
        assert registry.value(hist, "host") >= 1
        assert registry.value(hist, "device") >= 10
        assert registry.value("consensus_dag_read_route_ewma_ms", "host") > 0
        gauge = registry.get("consensus_dag_read_coalesced_batch_size")
        assert gauge.get() == 1
        burst = await asyncio.gather(*(dag.read_causal(tip.digest) for _ in range(4)))
        assert len(burst) == 4 and gauge.get() == 4

    run(scenario(), timeout=60.0)


def test_shutdown_fails_stranded_device_readers(run):
    async def scenario():
        dag = _port_dev(CommitteeFixture(size=4))
        fut = asyncio.get_running_loop().create_future()
        dag._dev_queue.append((b"\x00" * 32, fut))
        await dag.shutdown()
        with pytest.raises(ValidatorDagError, match="shut down"):
            await fut

    run(scenario(), timeout=30.0)


def test_adaptive_policy_routes_to_measured_faster_path(run):
    """With the device measured as catastrophically slow, the adaptive
    router serves the stream from the host (probes aside)."""
    _jf, f, _jc, c = _both(6, 4, payload_p=1.0, full=True)

    async def scenario():
        dag = Dag(f.committee, backend="cuda", window=W, device="cpu")
        for b in c:
            await dag.insert(b)
        dag._ewma["dev"] = 1.0
        dag._dev_warmed.add(1)
        for _ in range(20):
            await dag.read_causal(c[-4].digest)
        stats = dag.routing_stats()
        assert stats["host_calls"] >= 19 and stats["ewma_host_ms"] is not None

    run(scenario(), timeout=60.0)


def test_failed_launch_fails_every_waiter(run, monkeypatch):
    """A reach_many that raises reaches every reader of its coalesced batch
    as that exception: no host answer is served in its place. Once the
    kernel works again, the service answers as the host does."""
    _jf, f, _jc, c = _both(8, 4, payload_p=1.0, full=True)

    def failed_launch(*args):
        raise RuntimeError("reach_many: CUDA launch failed (700): an illegal memory access")

    async def scenario():
        dev, host = _port_dev(f), Dag(f.committee)
        for b in c:
            await dev.insert(b)
            await host.insert(b)
        monkeypatch.setattr(td, "reach_many", failed_launch)
        got = await asyncio.gather(*(dev.read_causal(x.digest) for x in c[-4:]),
                                   return_exceptions=True)
        assert all(isinstance(g, RuntimeError) and "launch failed" in str(g) for g in got)
        assert dev.routing_stats()["host_calls"] == 0
        monkeypatch.undo()
        assert await dev.read_causal(c[-1].digest) == await host.read_causal(c[-1].digest)

    run(scenario(), timeout=60.0)


@pytest.mark.parametrize("kw", [dict(backend="tpu"), dict(policy="fastest")],
                         ids=["backend", "policy"])
def test_unknown_backend_or_policy_is_refused(kw):
    with pytest.raises(ValueError):
        Dag(CommitteeFixture(size=4).committee, device="cpu", **kw)


# -- B6: reach_many's plain version against the vmapped JAX reach_mask -------


@pytest.mark.parametrize("K", [1, 3, 8])
def test_reach_many_plain_matches_jax_vmap(K):
    """K live starts padded to the next power of two above K (zero one-hot,
    offset 0 slots), as the service pads them: bit-equal to
    jax.vmap(reach_mask) over the same starts, padding rows all zero."""
    w, n = 32, 10
    rng = np.random.default_rng(K)
    parent = (rng.random((w, n, n)) < 0.45).astype(np.uint8)
    present = (rng.random((w, n)) < 0.85).astype(np.uint8)
    kpad = 1 << K.bit_length()
    offs = np.zeros(kpad, np.int32)
    onehots = np.zeros((kpad, n), np.uint8)
    offs[:K] = rng.choice(w, K, replace=False)
    offs[0] = w - 1
    onehots[np.arange(K), rng.integers(0, n, K)] = 1
    got = td.reach_many(*(torch.from_numpy(a) for a in (parent, present, offs, onehots)))
    want = np.asarray(
        jax.jit(jax.vmap(jd.reach_mask, in_axes=(None, None, 0, 0)))(
            parent, present, offs, onehots)
    )
    assert got.dtype == torch.bool and got.shape == (kpad, w, n)
    assert np.array_equal(got.numpy(), want)
    assert got[:K].any() and not got[K:].any()
