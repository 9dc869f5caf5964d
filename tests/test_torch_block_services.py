"""The port's block services and consensus API against the JAX package's.

- The JAX package's block-service and block-waiter scenarios
  (`tests/test_block_services.py`, `tests/test_block_waiter.py`) run
  against the port: each module's source with the package name swapped.
- `ConsensusApi` in both packages, over a `Dag(backend="cpu")` fed one
  seeded certificate stream and block services over one mock worker: every
  request type gives the same response bytes, error replies included.
- `BlockSynchronizer._verify_certificate` on the port's `VerifyService`
  (the plain versions on the CPU) accepts and rejects the same fetched
  certificates as the JAX one on its `AsyncVerifierPool`, a tampered
  compact proof and a tampered header signature among them; a range
  catch-up through both packages' synchronizers fetches the same set.
"""

import asyncio
import re
import types
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

import narwhal_tpu.channels as j_channels
import narwhal_tpu.config as j_config
import narwhal_tpu.consensus.dag as j_dag
import narwhal_tpu.fixtures as j_fixtures
import narwhal_tpu.messages as j_messages
import narwhal_tpu.metrics as j_metrics
import narwhal_tpu.network as j_network
import narwhal_tpu.primary.api_server as j_api
import narwhal_tpu.primary.block_remover as j_remover
import narwhal_tpu.primary.block_synchronizer as j_sync
import narwhal_tpu.primary.block_waiter as j_waiter
import narwhal_tpu.stores as j_stores
import narwhal_tpu.tracing as j_tracing
import narwhal_tpu.types as j_types
import narwhal_tpu_torch.channels as t_channels
import narwhal_tpu_torch.config as t_config
import narwhal_tpu_torch.consensus.dag as t_dag
import narwhal_tpu_torch.fixtures as t_fixtures
import narwhal_tpu_torch.messages as t_messages
import narwhal_tpu_torch.metrics as t_metrics
import narwhal_tpu_torch.network as t_network
import narwhal_tpu_torch.primary.api_server as t_api
import narwhal_tpu_torch.primary.block_remover as t_remover
import narwhal_tpu_torch.primary.block_synchronizer as t_sync
import narwhal_tpu_torch.primary.block_waiter as t_waiter
import narwhal_tpu_torch.stores as t_stores
import narwhal_tpu_torch.tracing as t_tracing
import narwhal_tpu_torch.types as t_types
from test_torch_network import port_scenarios

TESTS = Path(__file__).resolve().parent
FILES = ("test_block_services.py", "test_block_waiter.py")

_SCENARIOS = {}
for _file in FILES:
    for _name, _fn in port_scenarios(_file).items():
        assert _name not in _SCENARIOS and _name not in globals(), _name
        _SCENARIOS[_name] = _fn
globals().update(_SCENARIOS)


def test_all_reference_block_service_scenarios_collected():
    ref = set()
    for file in FILES:
        ref |= set(re.findall(r"^def (test_\w+)", (TESTS / file).read_text(), re.M))
    assert set(_SCENARIOS) == ref and len(ref) == 17


PKGS = {
    "port": types.SimpleNamespace(
        channels=t_channels, config=t_config, dag=t_dag, fixtures=t_fixtures,
        messages=t_messages, metrics=t_metrics, network=t_network, api=t_api,
        remover=t_remover, sync=t_sync, waiter=t_waiter, stores=t_stores, tracing=t_tracing,
        types=t_types),
    "jax": types.SimpleNamespace(
        channels=j_channels, config=j_config, dag=j_dag, fixtures=j_fixtures,
        messages=j_messages, metrics=j_metrics, network=j_network, api=j_api,
        remover=j_remover, sync=j_sync, waiter=j_waiter, stores=j_stores, tracing=j_tracing,
        types=j_types),
}


def seeded_dag(m, rounds: int, seed: int):
    """A committee of 4 and `rounds` rounds of its certificates, each
    parented by the whole previous round, with seeded batches (about half
    the certificates empty). Signing is deterministic, so both packages
    build byte-equal objects."""
    f = m.fixtures.CommitteeFixture(size=4)
    rng = np.random.default_rng(seed)
    parents = {c.digest for c in m.types.Certificate.genesis(f.committee)}
    certs, batches = [], {}
    for r in range(1, rounds + 1):
        row = []
        for i in range(4):
            payload = {}
            for _ in range(int(rng.integers(0, 3)) if rng.random() < 0.5 else 0):
                b = m.types.Batch(tuple(rng.bytes(int(rng.integers(4, 24)))
                                        for _ in range(int(rng.integers(1, 4)))))
                batches[b.digest] = b
                payload[b.digest] = 0
            row.append(f.certificate(f.header(author=i, round=r, payload=payload,
                                              parents=parents)))
        certs += row
        parents = {c.digest for c in row}
    return f, certs, batches


async def mock_worker(m, f, batches: dict):
    """Worker 0 of authority 0, answering RequestBatchesMsg from `batches`
    and DeleteBatchesMsg by deleting."""
    srv = m.network.RpcServer()
    held = {d: b.to_bytes() for d, b in batches.items()}

    async def on_request(msg, peer):
        return m.messages.RequestedBatchesMsg(
            tuple((d, d in held, held.get(d, b"")) for d in msg.digests))

    async def on_delete(msg, peer):
        for d in msg.digests:
            held.pop(d, None)
        return m.messages.DeletedBatchesMsg(msg.digests)

    srv.route(m.messages.RequestBatchesMsg, on_request)
    srv.route(m.messages.DeleteBatchesMsg, on_delete)
    port = await srv.start("127.0.0.1", 0)
    pk = f.authorities[0].public
    info = f.worker_cache.workers[pk][0]
    f.worker_cache.workers[pk][0] = m.config.WorkerInfo(
        name=info.name, transactions=info.transactions, worker_address=f"127.0.0.1:{port}")
    return srv


async def api_answers(m) -> list:
    """Every request type against package `m`'s ConsensusApi over a host
    Dag fed the seeded stream and block services over the mock worker:
    each answer's message bytes, or an error reply's text."""
    f, certs, batches = seeded_dag(m, 6, seed=3)
    name = f.authorities[0].public
    storage = m.stores.NodeStorage(None)
    for c in certs:
        storage.certificate_store.write(c)
        storage.header_store.write(c.header)
    dag = m.dag.Dag(f.committee, backend="cpu")
    for c in certs:
        await dag.insert(c)
    worker = await mock_worker(m, f, batches)
    network = m.network.NetworkClient()
    sync = m.sync.BlockSynchronizer(name, f.committee, f.worker_cache,
                                    storage.certificate_store, storage.payload_store, network,
                                    f.parameters)
    waiter = m.waiter.BlockWaiter(name, f.worker_cache, storage.certificate_store, network, sync)
    remover = m.remover.BlockRemover(name, f.worker_cache, storage.certificate_store,
                                     storage.header_store, storage.payload_store, network,
                                     dag=dag)
    registry = m.metrics.Registry()
    registry.counter("node_things_total", "Things").inc(2)
    tracer = m.tracing.Tracer(node="n0", enabled=True)
    tracer.span("commit", certs[0].digest, 1.0, 2.5)
    api = m.api.ConsensusApi(name, f.committee, waiter, remover, dag=dag, registry=registry,
                             tracer=tracer)
    api.set_primary_address("127.0.0.1:4242")
    await api.spawn("127.0.0.1:0")
    msgs = m.messages
    keys = [a.public for a in f.authorities]
    full = [c for c in certs if c.header.payload]
    empty = [c for c in certs if not c.header.payload]
    unknown = b"\x5a" * 32
    requests = (
        [msgs.RoundsRequest(k) for k in keys] + [msgs.RoundsRequest(b"\x01" * 32)]
        + [msgs.ReadCausalRequest(c.digest) for c in certs[-5:] + full[:2] + empty[:1]]
        + [msgs.ReadCausalRequest(unknown)]
        + [msgs.NodeReadCausalRequest(keys[i], r) for i, r in ((0, 6), (1, 5), (2, 1), (3, 9))]
        + [msgs.GetCollectionsRequest(tuple(c.digest for c in full[:3] + empty[:1])),
           msgs.GetCollectionsRequest((unknown,)), msgs.GetCollectionsRequest(()),
           msgs.RemoveCollectionsRequest(tuple(c.digest for c in full[:2])),
           msgs.GetCollectionsRequest(tuple(c.digest for c in full[:2])),
           msgs.RemoveCollectionsRequest(()),
           msgs.NodeReadCausalRequest(full[0].origin, full[0].round),
           msgs.NewEpochRequest(1),
           msgs.NewNetworkInfoRequest(f.committee.epoch, tuple(
               (k, 1, f"127.0.0.1:{7000 + i}") for i, k in enumerate(keys))),
           msgs.NewNetworkInfoRequest(f.committee.epoch + 1, ()),
           msgs.NewNetworkInfoRequest(f.committee.epoch, ((b"\x01" * 32, 1, "x:1"),)),
           msgs.GetPrimaryAddressRequest(), msgs.TelemetryScrapeMsg(), msgs.FlightDumpMsg(),
           msgs.FlightDumpMsg(max_events=1)]
    )
    client = m.network.NetworkClient()
    out = []
    try:
        for req in requests:
            try:
                resp = await client.request(api.address, req, timeout=30.0)
                out.append(("ok", None if resp is None else msgs.encode_message(resp)))
            except m.network.RpcError as e:
                out.append(("error", str(e)))
    finally:
        client.close()
        network.close()
        await api.shutdown()
        await worker.stop()
    return out


def test_consensus_api_answers_match_jax(run):
    got = {name: run(api_answers(m), timeout=120.0) for name, m in PKGS.items()}
    assert got["port"] == got["jax"]
    kinds = [k for k, _ in got["port"]]
    assert kinds.count("error") >= 6 and kinds.count("ok") >= 20
    errors = [e for k, e in got["port"] if k == "error"]
    assert any("Not Implemented" in e for e in errors)
    assert any("unknown authority" in e for e in errors)


# -- catch-up verification -----------------------------------------------------


def catch_up_set(m):
    """Round-1 certificates of a committee of 4: two compact ones, a full
    one, a compact one whose header signature has byte 7 flipped, and a
    compact one with `agg_s` byte 0 flipped (`chip_smoke.tampered_messages`).
    Five certificates: the port's VerifyService on the CPU takes ~4 s a
    compact certificate."""
    import chip_smoke

    f = m.fixtures.CommitteeFixture(size=4)
    committee = f.committee
    compact = []
    for i in (1, 2, 3):
        header = f.header(author=i, round=1, payload={bytes([1, i]) * 16: 0})
        votes = sorted((committee.index_of(a.public),
                        m.types.Vote.for_header(header, a.public, a.keypair).signature)
                       for a in f.authorities[:3])
        compact.append(m.types.Certificate.compact_from_votes(
            header, tuple(i for i, _ in votes), tuple(s for _, s in votes)))
    full = f.certificate(f.header(author=0, round=1, payload={b"\x33" * 32: 0}))
    honest = compact.pop()
    sig = honest.header.signature
    bad_header = replace(honest.header, signature=sig[:7] + bytes([sig[7] ^ 1]) + sig[8:])
    bad_sig = m.types.Certificate(bad_header, honest.signers, honest.signatures, honest.agg_s)
    _vote, bad_proof = chip_smoke.tampered_messages(m, f)
    return f, compact + [full], [bad_sig, bad_proof]


async def catch_up_verdicts(m, pool):
    """A range catch-up of the set from three mock peers, through package
    `m`'s BlockSynchronizer over `pool`: the digests it wanted and the ones
    it collected (those `_verify_certificate` passed), in the set's order."""
    f, honest, bad = catch_up_set(m)
    served = {c.digest: c for c in honest + bad}
    servers = []
    for i in (1, 2, 3):
        srv = m.network.RpcServer()

        async def on_range(msg, peer):
            return m.messages.CertificatesRangeResponse(tuple(served))

        async def on_batch(msg, peer):
            return m.messages.CertificatesBatchResponse(
                tuple((d, served.get(d)) for d in msg.digests))

        srv.route(m.messages.CertificatesRangeRequest, on_range)
        srv.route(m.messages.CertificatesBatchRequest, on_batch)
        port = await srv.start("127.0.0.1", 0)
        pk = f.authorities[i].public
        auth = f.committee.authorities[pk]
        f.committee.authorities[pk] = m.config.Authority(auth.stake, f"127.0.0.1:{port}",
                                                         auth.network_key)
        servers.append(srv)
    storage = m.stores.NodeStorage(None)
    loopback = m.channels.Channel(100)
    network = m.network.NetworkClient()
    sync = m.sync.BlockSynchronizer(f.authorities[0].public, f.committee, f.worker_cache,
                                    storage.certificate_store, storage.payload_store, network,
                                    f.parameters, tx_loopback=loopback, crypto_pool=pool)
    try:
        wanted = await sync.synchronize_range(0, timeout=120.0)
    finally:
        network.close()
        for srv in servers:
            await srv.stop()
    collected = []
    while (c := loopback.try_recv()) is not None:
        collected.append(c.digest)
    return {"wanted": sorted(wanted), "collected": sorted(collected),
            "verdicts": [c.digest in collected for c in honest + bad]}


def test_catch_up_verification_matches_jax(run):
    from narwhal_tpu.tpu.verifier import AsyncVerifierPool
    from narwhal_tpu_torch.gpu.verifier import GpuVerifier, VerifyService

    svc = VerifyService(GpuVerifier(max_bucket=64, msm_min_bucket=16, mode="item",
                                    device="cpu"), max_batch=64)
    try:
        mine = run(catch_up_verdicts(PKGS["port"], svc), timeout=300.0)
    finally:
        svc.shutdown()
    pool = AsyncVerifierPool(max_delay=0.01)

    async def jax_side():
        try:
            return await catch_up_verdicts(PKGS["jax"], pool)
        finally:
            await pool.close()

    ref = run(jax_side(), timeout=120.0)
    assert mine == ref
    assert len(mine["wanted"]) == 5 and mine["verdicts"] == [True] * 3 + [False] * 2
