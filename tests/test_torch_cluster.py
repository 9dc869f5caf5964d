"""The port's node and in-process cluster against the JAX package's scenarios.

- The scenarios of `tests/test_node.py` and `tests/test_worker_shard.py`
  run against the port: each module's source with the package renamed
  (`port_scenarios`). The ones that name the JAX device backend are
  written out below under the same names, on the port's `cuda` backends
  with `device="cpu"` (the kernels' plain versions): the device DAG
  backend, the sharded DAG backend over a CPU `auth` mesh, the verify-shard
  wiring over a CPU `data` mesh, the shared card service and its loops.
- `test_environmental_valueerror_keeps_host_crypto_fallback` becomes
  `test_environmental_valueerror_ends_the_boot`: the port has no host
  fallback, so an error raised while building the card's service ends the
  boot under either verify rule.
"""

import asyncio
import re
from dataclasses import replace
from pathlib import Path

import pytest

from narwhal_tpu_torch.cluster import Cluster
from narwhal_tpu_torch.config import ConfigError
from narwhal_tpu_torch.fixtures import CommitteeFixture
from narwhal_tpu_torch.messages import SubmitTransactionStreamMsg
from narwhal_tpu_torch.network import NetworkClient
from narwhal_tpu_torch.node import NodeStorage, PrimaryNode
from test_torch_network import host_backends, port_scenarios  # noqa: F401 (a fixture)

# The renamed scenarios name no backend: the JAX node's host defaults.
pytestmark = pytest.mark.usefixtures("host_backends")

TESTS = Path(__file__).resolve().parent
FILES = ("test_node.py", "test_worker_shard.py")
# Written out below on the port's cuda backends with device="cpu", under
# the same names but one.
WRITTEN_OUT = frozenset({
    "test_cluster_with_tpu_dag_backend",
    "test_cluster_with_sharded_tpu_dag_backend",
    "test_verify_shards_validated_and_wired",
    "test_environmental_valueerror_keeps_host_crypto_fallback",
    "test_cluster_with_tpu_crypto_shared_service",
    "test_verify_service_merges_and_survives_loops",
})
RENAMED = {"test_environmental_valueerror_keeps_host_crypto_fallback":
           "test_environmental_valueerror_ends_the_boot"}

_SCENARIOS = {}
for _file in FILES:
    for _name, _fn in port_scenarios(_file, WRITTEN_OUT).items():
        assert _name not in _SCENARIOS and _name not in globals(), _name
        _SCENARIOS[_name] = _fn
globals().update(_SCENARIOS)


def test_all_reference_node_scenarios_collected():
    ref = set()
    for file in FILES:
        ref |= set(re.findall(r"^def (test_\w+)", (TESTS / file).read_text(), re.M))
    assert set(_SCENARIOS) | WRITTEN_OUT == ref and len(ref) == 18
    assert all(callable(globals()[RENAMED.get(name, name)]) for name in WRITTEN_OUT)


def _make_node(fx, **kw):
    return PrimaryNode(
        fx.authorities[0].keypair,
        fx.committee,
        fx.worker_cache,
        kw.pop("parameters", fx.parameters),
        NodeStorage(None),
        **kw,
    )


async def _executed(details, count):
    out = []
    while len(out) < count:
        _, tx = await asyncio.wait_for(details.primary.tx_execution_output.recv(), 30.0)
        out.append(tx)
    return out


def test_cluster_with_tpu_dag_backend(run, tmp_path):
    """--dag-backend cuda: consensus runs through GpuBullshark's window
    kernels (their plain versions on the CPU). All nodes execute client
    transactions in an identical order, and a restarted node rebuilds its
    window from the store (GpuBullshark.recover) and resumes committing."""

    async def scenario():
        cluster = Cluster(
            size=4, workers=1, store_base=str(tmp_path), dag_backend="cuda", device="cpu"
        )
        await cluster.start()
        client = NetworkClient()
        try:
            from narwhal_tpu_torch.gpu.dag_kernels import GpuBullshark

            assert isinstance(cluster.authorities[0].primary.consensus.protocol, GpuBullshark)
            target = cluster.authorities[0].worker_transactions_address(0)
            txs = tuple(bytes([7]) * 8 + bytes([i]) for i in range(32))
            await client.request(target, SubmitTransactionStreamMsg(txs))
            results = await asyncio.gather(*(_executed(a, 32) for a in cluster.authorities))
            assert all(len(r) == 32 for r in results)
            assert results[0] == results[1] == results[2] == results[3]
            assert set(results[0]) == set(txs)

            await cluster.restart_node(0)
            before = max(
                a.metric("consensus_last_committed_round")
                for a in cluster.authorities
                if a.primary is not None
            )
            rounds = await cluster.assert_progress(
                commit_threshold=int(before) + 2, timeout=30.0
            )
            assert rounds[cluster.authorities[0].name] >= int(before) + 2
        finally:
            client.close()
            await cluster.shutdown()

    run(scenario(), timeout=150.0)


def test_cluster_with_sharded_tpu_dag_backend(run, tmp_path):
    """--dag-backend cuda --dag-shards 2 with device="cpu": the node wires
    an auth mesh of the CPU twice into GpuBullshark, whose commit events
    run the sharded walk's plain version. The committee still commits and
    executes transactions identically on every node."""

    async def scenario():
        cluster = Cluster(
            size=4, workers=1, store_base=str(tmp_path),
            dag_backend="cuda", dag_shards=2, device="cpu",
        )
        await cluster.start()
        client = NetworkClient()
        try:
            proto = cluster.authorities[0].primary.consensus.protocol
            assert proto.mesh is not None and proto.mesh.shape["auth"] == 2
            target = cluster.authorities[0].worker_transactions_address(0)
            txs = tuple(bytes([9]) * 8 + bytes([i]) for i in range(16))
            await client.request(target, SubmitTransactionStreamMsg(txs))
            results = await asyncio.gather(*(_executed(a, 16) for a in cluster.authorities))
            assert all(r == results[0] for r in results)
        finally:
            client.close()
            await cluster.shutdown()

    run(scenario(), timeout=90.0)


def test_verify_shards_validated_and_wired():
    """--verify-shards: a node boots with the VerifyService's flushes
    sharded over a CPU 'data' mesh, a mis-sized shard count fails AT
    STARTUP with ConfigError, the flag requires the cuda backend, and
    parameters.cert_format is validated at startup."""
    from narwhal_tpu_torch.gpu.verifier import VerifyService

    fx = CommitteeFixture(size=4)
    with pytest.raises(ValueError, match="verify-shards"):
        _make_node(fx, crypto_backend="cpu", verify_shards=2)
    with pytest.raises(ConfigError, match="divide"):
        _make_node(fx, crypto_backend="cuda", verify_shards=3, device="cpu")
    with pytest.raises(ValueError, match="cert_format"):
        _make_node(fx, parameters=replace(fx.parameters, cert_format="compat"))

    node = _make_node(fx, crypto_backend="cuda", verify_shards=2, device="cpu")
    try:
        svc = node.crypto_pool
        assert isinstance(svc, VerifyService)
        assert svc.verifier.mesh is not None
        assert svc.verifier.mesh.shape["data"] == 2
        # Catch-up sync shares the same batched lane.
        assert node.block_synchronizer.crypto_pool is svc
    finally:
        if isinstance(node.crypto_pool, VerifyService):
            node.crypto_pool.shutdown()


def test_environmental_valueerror_ends_the_boot(monkeypatch):
    """The port's side of the JAX package's
    `test_environmental_valueerror_keeps_host_crypto_fallback`: a
    ValueError escaping the card service's construction for non-config
    reasons ends the boot under the strict rule as under the cofactored
    one, with the original error; the JAX node degrades the strict node to
    its host pool instead. No AsyncVerifierPool is built."""
    from narwhal_tpu_torch.gpu import verifier

    fx = CommitteeFixture(size=4)
    built = []

    def boom(mode, shards=1, **kw):
        raise ValueError("CUDA context initialization failed")  # environmental

    monkeypatch.setattr(verifier.VerifyService, "shared", boom)
    monkeypatch.setattr(verifier, "AsyncVerifierPool", lambda *a, **k: built.append(1))
    for rule in ("strict", "cofactored"):
        with pytest.raises(ValueError, match="CUDA context"):
            _make_node(fx, crypto_backend="cuda", device="cpu",
                       parameters=replace(fx.parameters, verify_rule=rule))
    assert built == []


def _small_service(mode: str):
    from narwhal_tpu_torch.gpu.verifier import GpuVerifier, VerifyService

    return VerifyService(
        GpuVerifier(max_bucket=32, msm_min_bucket=16, mode=mode, device="cpu"),
        max_batch=32,
        max_delay=0.002,
    )


@pytest.mark.slow  # the plain kernels on the CPU take seconds a flush
def test_cluster_with_tpu_crypto_shared_service(run):
    """crypto_backend="cuda": the whole committee shares ONE process-wide
    VerifyService (merged flushes, pipelined submit/collect threads);
    certificates verify through the kernels' plain versions and commits
    advance. The service is pre-seeded with a small-bucket verifier."""
    from narwhal_tpu_torch.gpu.verifier import VerifyService

    svc = _small_service("msm")
    VerifyService._shared["msm:1:cpu"] = svc

    async def scenario():
        cluster = Cluster(size=4, workers=1, crypto_backend="cuda", device="cpu")
        assert cluster.parameters.verify_rule == "cofactored"
        await cluster.start()
        try:
            rounds = await cluster.assert_progress(commit_threshold=2, timeout=240.0)
            assert all(r >= 2 for r in rounds.values())
            pools = {id(a.primary.crypto_pool) for a in cluster.authorities}
            assert len(pools) == 1
            assert cluster.authorities[0].primary.crypto_pool is svc
        finally:
            await cluster.shutdown()

    try:
        run(scenario(), timeout=300.0)
    finally:
        svc.shutdown()


@pytest.mark.slow  # same bill as the shared-service cluster test
def test_verify_service_merges_and_survives_loops():
    """VerifyService is loop-agnostic: requests from sequential event loops
    resolve correctly, bad signatures are rejected, and a failed submit
    propagates to the waiter (the port has no host fallback in any mode)."""
    from narwhal_tpu_torch.crypto import KeyPair

    kp = KeyPair.generate()
    good = (kp.public, b"m", kp.sign(b"m"))
    bad = (kp.public, b"x", kp.sign(b"m"))
    svc = _small_service("msm")
    try:
        async def burst():
            return await asyncio.gather(*(svc.verify(*good) for _ in range(20)), svc.verify(*bad))

        res1 = asyncio.run(burst())
        res2 = asyncio.run(burst())
        for res in (res1, res2):
            assert res[:-1] == [True] * 20 and res[-1] is False

        def boom(items):
            raise RuntimeError("device lost")

        svc.verifier.submit = boom

        async def failing():
            with pytest.raises(RuntimeError, match="device lost"):
                await svc.verify(*good)

        asyncio.run(failing())
    finally:
        svc.shutdown()


def test_failed_collect_fails_every_waiter_in_item_mode():
    """Item mode too: where the JAX service host-verifies the entries of a
    failed collect (`_finish_failed`), the port's fails every waiter with
    the collect's error."""
    from narwhal_tpu_torch.crypto import KeyPair

    kp = KeyPair.generate()
    good = (kp.public, b"m", kp.sign(b"m"))
    svc = _small_service("item")
    try:
        def lost(handle):
            raise RuntimeError("collect lost")

        svc.verifier.collect = lost

        async def waiters():
            return await asyncio.gather(*(svc.verify(*good) for _ in range(5)),
                                        return_exceptions=True)

        res = asyncio.run(waiters())
        assert len(res) == 5
        assert all(isinstance(r, RuntimeError) and "collect lost" in str(r) for r in res)
    finally:
        svc.shutdown()


def test_make_batch_verifier_has_no_host_fallback(monkeypatch):
    """`make_batch_verifier` builds a GpuVerifier (here on the CPU's plain
    versions), refuses `fallback_on_error=True`, raises where the verifier
    cannot be built (the JAX one returns None) and lets a failed launch's
    error through (the JAX one host-verifies)."""
    from narwhal_tpu_torch.crypto import KeyPair
    from narwhal_tpu_torch.gpu import verifier

    with pytest.raises(ConfigError, match="fallback"):
        verifier.make_batch_verifier(fallback_on_error=True, device="cpu")
    with pytest.raises(ConfigError):
        verifier.make_batch_verifier(mode="bogus", device="cpu")
    kp = KeyPair.generate()
    backend = verifier.make_batch_verifier(mode="item", device="cpu")
    assert backend([(kp.public, b"m", kp.sign(b"m")), (kp.public, b"x", kp.sign(b"m"))]) == [
        True, False]

    def lost(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(verifier.ed25519, "verify_batch", lost)
    with pytest.raises(RuntimeError, match="launch failed"):
        backend([(kp.public, b"m", kp.sign(b"m"))])


def test_shared_service_is_keyed_by_device_and_closes_as_a_no_op(run):
    """`VerifyService.shared` keys by mode, shard count and device;
    `close()` (what `PrimaryNode.shutdown` awaits) leaves the process-wide
    service running for the next node."""
    from narwhal_tpu_torch.gpu.verifier import VerifyService

    svc = VerifyService.shared("item", device="cpu")
    try:
        assert VerifyService.shared("item", device="cpu") is svc
        assert VerifyService._shared["item:1:cpu"] is svc
        run(svc.close())
        assert not svc._closed and svc._submit_thread.is_alive()
        assert VerifyService.shared("item", device="cpu") is svc
    finally:
        svc.shutdown()
    assert "item:1:cpu" not in VerifyService._shared


async def mixed_committee(tmpdir: str, txs_per_client: int = 24, timeout: float = 60.0) -> dict:
    """A committee of 4 whose authorities 0 and 1 are JAX `PrimaryNode`s
    and 2 and 3 port ones, each with one worker of its package, over
    authenticated loopback RPC (the fixtures' network keys; the packages'
    seeded fixtures agree on every key). Authority 3 runs
    `dag_backend="cuda", device="cpu"` (GpuBullshark on the plain
    versions), the others the host Bullshark. Two clients submit to the
    workers of authorities 0 (JAX) and 2 (port); runs until every node has
    executed every transaction. Returns each node's committed (digest,
    consensus_index) sequence and executed transactions."""
    import narwhal_tpu.config as j_config
    import narwhal_tpu.fixtures as j_fixtures
    import narwhal_tpu.messages as j_messages
    import narwhal_tpu.network as j_network
    import narwhal_tpu.node as j_node
    import narwhal_tpu.stores as j_stores
    import narwhal_tpu_torch.config as t_config
    import narwhal_tpu_torch.fixtures as t_fixtures
    import narwhal_tpu_torch.node as t_node
    import narwhal_tpu_torch.stores as t_stores

    pkgs = {"jax": (j_config, j_fixtures, j_node, j_stores),
            "port": (t_config, t_fixtures, t_node, t_stores)}
    which = ["jax", "jax", "port", "port"]
    fx = {k: v[1].CommitteeFixture(size=4) for k, v in pkgs.items()}
    names = [a.public for a in fx["jax"].authorities]
    assert names == [a.public for a in fx["port"].authorities]
    for i, pk in enumerate(names):
        # Each address from the allocator of the package whose server binds
        # it: a server binds through its own package's port placeholder.
        port = pkgs[which[i]][0].get_available_port
        primary, worker, txs = (f"127.0.0.1:{port()}" for _ in range(3))
        for k, (cfg, _f, _n, _s) in pkgs.items():
            old = fx[k].committee.authorities[pk]
            fx[k].committee.authorities[pk] = cfg.Authority(old.stake, primary, old.network_key)
            info = fx[k].worker_cache.workers[pk][0]
            fx[k].worker_cache.workers[pk][0] = cfg.WorkerInfo(
                name=info.name, transactions=txs, worker_address=worker)
    commits = {i: [] for i in range(4)}
    executed = {i: [] for i in range(4)}
    nodes, drains = [], []
    try:
        for i, k in enumerate(which):
            cfg, _f, node_m, stores_m = pkgs[k]
            f = fx[k]
            a = f.authorities[i]
            params = replace(f.parameters, max_header_delay=0.05, max_batch_delay=0.05)
            kw = {"dag_backend": "cuda", "device": "cpu"} if i == 3 else {}
            p = node_m.PrimaryNode(
                a.keypair, f.committee, f.worker_cache, params,
                stores_m.NodeStorage(f"{tmpdir}/node-{i}-primary"),
                network_keypair=a.network_keypair,
                commit_tap=lambda out, log=commits[i]: log.append(
                    (out.certificate.digest, out.consensus_index)),
                **kw)
            await p.spawn()
            w = node_m.WorkerNode(a.public, 0, f.committee, f.worker_cache, params,
                                  stores_m.NodeStorage(f"{tmpdir}/node-{i}-worker-0"),
                                  network_keypair=a.worker_keypairs[0])
            await w.spawn()
            nodes += [p, w]

            async def drain(ch=p.tx_execution_output, out=executed[i]):
                while True:
                    _, tx = await ch.recv()
                    out.append(tx)

            drains.append(asyncio.ensure_future(drain()))
        from narwhal_tpu_torch.gpu.dag_kernels import GpuBullshark

        assert isinstance(nodes[6].consensus.protocol, GpuBullshark)
        client = j_network.NetworkClient()
        sent = set()
        try:
            for c, i in enumerate((0, 2)):
                txs = tuple(bytes([c, j]) * 16 for j in range(txs_per_client))
                sent.update(txs)
                addr = fx["jax"].worker_cache.worker(names[i], 0).transactions
                await client.request(addr, j_messages.SubmitTransactionStreamMsg(txs))
        finally:
            client.close()
        deadline = asyncio.get_event_loop().time() + timeout
        while any(len(e) < len(sent) for e in executed.values()):
            assert asyncio.get_event_loop().time() < deadline, {
                i: len(e) for i, e in executed.items()}
            await asyncio.sleep(0.1)
    finally:
        for t in drains:
            t.cancel()
        for n in reversed(nodes):
            await n.shutdown()
    return {"commits": commits, "executed": executed, "sent": sent}


def test_mixed_jax_and_port_node_committee(run, tmp_path):
    """Two JAX and two port PrimaryNodes with workers (one port node on the
    cuda DAG backend over the CPU) commit one (digest, consensus_index)
    sequence and execute the same transactions in the same order."""
    out = run(mixed_committee(str(tmp_path)), timeout=120.0)
    logs = out["commits"]
    common = min(len(v) for v in logs.values())
    assert common >= 4
    for i in (1, 2, 3):
        assert logs[i][:common] == logs[0][:common]
    ex = out["executed"]
    assert all(len(v) == len(out["sent"]) for v in ex.values())
    assert set(ex[0]) == out["sent"]
    assert ex[1] == ex[0] and ex[2] == ex[0] and ex[3] == ex[0]
