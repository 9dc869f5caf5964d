"""The `node` legs through `chip_smoke.primary_wire`, on the CPU.

A mixed committee of 4, two port authorities and two JAX authorities (both
orders), each with its worker, over authenticated loopback TCP; authority 0
runs a consensus runner feeding its package's `Executor`, authority 2 runs
without one, its certificates feeding its package's `Dag` (the port's with
the device window on CPU tensors, the plain `reach_many`) beside a host
`Dag`. Each package's `ConsensusApi` serves authorities 0 and 2:
Rounds, ReadCausal and NodeReadCausal equal to the host Dag's,
GetCollections byte-equal to the sealed batches, a TelemetryScrape read
with `parse_exposition`, RemoveCollections; then a range catch-up by a
fresh `BlockSynchronizer` (verifying through the JAX `AsyncVerifierPool`,
or the port's no-pool branch), a tampered compact proof rejected. The
N = 50 port committee, and an N = 4 one whose catch-up verifies through
the port's `VerifyService` on the CPU, are `-m slow`.
"""

import asyncio
import types

import pytest

import chip_smoke
import narwhal_tpu.channels as j_channels
import narwhal_tpu.config as j_config
import narwhal_tpu.consensus as j_consensus
import narwhal_tpu.crypto as j_crypto
import narwhal_tpu.executor as j_executor
import narwhal_tpu.fixtures as j_fixtures
import narwhal_tpu.messages as j_messages
import narwhal_tpu.metrics as j_metrics
import narwhal_tpu.network as j_network
import narwhal_tpu.node as j_node
import narwhal_tpu.pacing as j_pacing
import narwhal_tpu.primary as j_primary
import narwhal_tpu.primary.api_server  # noqa: F401  (m.primary.api_server)
import narwhal_tpu.primary.block_remover  # noqa: F401
import narwhal_tpu.primary.block_synchronizer  # noqa: F401
import narwhal_tpu.primary.block_waiter  # noqa: F401
import narwhal_tpu.stores as j_stores
import narwhal_tpu.types as j_types
import narwhal_tpu.worker as j_worker
import narwhal_tpu_torch.pacing as t_pacing

PORT = chip_smoke.primary_modules()
JAX = types.SimpleNamespace(channels=j_channels, config=j_config, consensus=j_consensus,
                            crypto=j_crypto, executor=j_executor, fixtures=j_fixtures,
                            messages=j_messages, metrics=j_metrics, network=j_network,
                            node=j_node, primary=j_primary, stores=j_stores, types=j_types,
                            worker=j_worker)


def dag_of(m, committee, rx):
    """The node's Dag: the port's device window on CPU tensors, the JAX
    package's host Dag."""
    if m is PORT:
        return m.consensus.Dag(committee, rx, backend="cuda", device="cpu")
    return m.consensus.Dag(committee, rx, backend="cpu")


class SyncPool:
    """The catch-up synchronizer's crypto pool in package `m`: the JAX
    package's host pool; none for the port, whose synchronizer then takes
    the reference's no-pool branch (`Certificate.verify`), since its
    `VerifyService` on the CPU runs the plain versions at seconds a flush
    (held on a few certificates in test_torch_block_services.py)."""

    def __init__(self, m):
        self.pool = None
        if m is JAX:
            from narwhal_tpu.tpu.verifier import AsyncVerifierPool

            self.pool = AsyncVerifierPool(max_delay=0.01)

    async def close(self):
        if self.pool is not None:
            await self.pool.close()


async def node_committee(mods, tmpdir, clients, txs, targets=None, engine0=None,
                         timeout=120.0):
    sync = SyncPool(mods[0])
    marks = []
    legs = chip_smoke.NodeLegs(dag_of, sync.pool, mark=lambda: marks.append(1),
                               sync_timeout=timeout)
    try:
        out = await chip_smoke.primary_wire(mods, tmpdir, clients, txs, targets=targets,
                                            engine0=engine0, timeout=timeout, node=legs)
    finally:
        await sync.close()
    assert marks == [1]
    return out


@pytest.mark.parametrize("first", ["port", "jax"])
def test_mixed_committee_runs_the_node_legs(run, tmp_path, first, monkeypatch):
    """Authorities 0 and 1 from one package, 2 and 3 from the other; with
    the port first, authority 0's runner drives GpuBullshark on the CPU.

    The committee's header delay is pinned at its ceiling (NARWHAL_PACING=0,
    read by both packages' primaries). Under adaptive pacing the rounds run
    at the 20 ms floor while payload is about, and on a loaded host the
    certificate of authority 3's round-2 header, which carries the second
    client's batch, formed after the other three: every round-3 header took
    parents 0, 1 and 2, so no leader's history holds that certificate, the
    reference proposer does not propose its batch again, and primary_wire's
    wait for every sealed batch to commit at authority 0 could not end
    (round 1,048-1,122 by its 120 s deadline)."""
    from narwhal_tpu_torch.gpu.dag_kernels import GpuBullshark

    monkeypatch.setenv("NARWHAL_PACING", "0")

    a, b = (PORT, JAX) if first == "port" else (JAX, PORT)

    def engine0(m, fx, storage):
        return GpuBullshark(fx.committee, storage.consensus_store, fx.parameters.gc_depth,
                            device="cpu")

    out = run(node_committee([a, a, b, b], str(tmp_path), 2, 40, targets=[0, 3],
                             engine0=engine0 if first == "port" else None), timeout=240.0)
    legs = out["node"]
    assert out["transactions"] == 80 and len(out["runner_lengths"]) == 3
    assert legs["executor"]["transactions"] == 80
    counters = legs["collections"]["counters"]
    assert counters["executor_executed_transactions"] == 80
    assert counters["executor_prefetch_hits"] + counters["executor_prefetch_misses"] >= \
        out["batches"]
    assert legs["collections"]["batches"] == out["batches"]
    assert set(legs["reads"]["bursts"]) == {1, 8, 64}
    routing = legs["reads"]["routing"]
    assert routing["host_calls"] + routing["dev_calls"] >= 73
    if b is PORT:
        assert routing["dev_calls"] > 0
    assert legs["removal"]["removed"] > 0
    assert legs["catch_up"]["fetched"] >= 4 * out["rounds"] - 4
    assert legs["commits_after_mark"] > 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_orphaned_batch_is_not_proposed_again(run, pkg):
    """The open fault that the pinned pacing above keeps out of the mixed
    committee (ROADMAP queue 3), held in both packages: a proposer under
    the default adaptive pacing proposes a batch digest once, in its
    round-1 header. When the round-1 parents it then receives leave that
    header's certificate out (as a quorum that formed without it does), its
    round-2 and round-3 headers carry neither the digest nor the
    certificate, so no leader's history can hold the batch and it is never
    committed. A repair that proposes such a digest again turns this test
    into the repair's own."""
    m, pacing_mod = (PORT, t_pacing) if pkg == "port" else (JAX, j_pacing)
    f = m.fixtures.CommitteeFixture(size=4)
    me = f.authorities[0]
    params = f.parameters

    async def scenario():
        rx_core, rx_workers, tx_core = (m.channels.Channel(10) for _ in range(3))
        pacing = pacing_mod.PacingController(
            ceiling=0.2, floor=params.header_delay_floor,
            low_occupancy=params.pacing_low_occupancy,
            high_occupancy=params.pacing_high_occupancy,
            ewma_alpha=params.pacing_ewma_alpha,
            sources=[rx_workers.occupancy, rx_core.occupancy])
        proposer = m.primary.proposer.Proposer(
            me.public, f.committee, me.signature_service(), header_size=32,
            max_header_delay=0.2, network_model=m.primary.NetworkModel.PARTIALLY_SYNCHRONOUS,
            rx_core=rx_core, rx_workers=rx_workers, tx_core=tx_core,
            rx_reconfigure=m.channels.Watch(m.types.ReconfigureNotification("boot")),
            pacing=pacing)
        digest = b"\7" * 32
        await rx_workers.send((digest, 0))
        task = proposer.spawn()
        try:
            own = await asyncio.wait_for(tx_core.recv(), 5.0)
            assert own.round == 1 and own.payload == {digest: 0}
            own_cert = f.certificate(own)
            headers = []
            parents = {c.digest for c in m.types.Certificate.genesis(f.committee)}
            for r in (1, 2):
                others = [m.fixtures.mock_certificate(f.committee, a.public, r, parents)
                          for a in f.authorities[1:]]
                await rx_core.send((others, r, f.committee.epoch))
                header = await asyncio.wait_for(tx_core.recv(), 5.0)
                assert header.round == r + 1
                headers.append(header)
                parents = {c.digest for c in others}
        finally:
            task.cancel()
        for header in headers:
            assert digest not in header.payload
            assert own_cert.digest not in header.parents

    run(scenario())


@pytest.mark.slow
def test_port_committee_of_50_runs_the_node_legs(run, tmp_path):
    out = run(node_committee([PORT] * 50, str(tmp_path), 10, 200, timeout=400.0),
              timeout=900.0)
    legs = out["node"]
    assert out["transactions"] == 2000 and legs["executor"]["transactions"] == 2000
    assert legs["reads"]["routing"]["dev_calls"] > 0 and legs["catch_up"]["fetched"] > 0


@pytest.mark.slow
def test_port_committee_catch_up_verifies_through_the_service(run, tmp_path):
    """The card path's shape on the CPU: the catch-up on a VerifyService of
    the plain versions (~4 s a compact certificate)."""
    from narwhal_tpu_torch.gpu.verifier import GpuVerifier, VerifyService

    svc = VerifyService(GpuVerifier(max_bucket=64, msm_min_bucket=16, mode="item",
                                    device="cpu"), max_batch=64)
    legs = chip_smoke.NodeLegs(dag_of, svc, sync_timeout=600.0)
    try:
        out = run(chip_smoke.primary_wire([PORT] * 4, str(tmp_path), 2, 40, node=legs,
                                          timeout=600.0), timeout=900.0)
    finally:
        svc.shutdown()
    cu = out["node"]["catch_up"]
    assert cu["flushes"]["group_flushes"] == cu["flushes"]["item_flushes"] == cu["fetched"]
