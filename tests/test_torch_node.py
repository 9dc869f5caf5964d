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
import narwhal_tpu.primary as j_primary
import narwhal_tpu.primary.api_server  # noqa: F401  (m.primary.api_server)
import narwhal_tpu.primary.block_remover  # noqa: F401
import narwhal_tpu.primary.block_synchronizer  # noqa: F401
import narwhal_tpu.primary.block_waiter  # noqa: F401
import narwhal_tpu.stores as j_stores
import narwhal_tpu.types as j_types
import narwhal_tpu.worker as j_worker

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
def test_mixed_committee_runs_the_node_legs(run, tmp_path, first):
    """Authorities 0 and 1 from one package, 2 and 3 from the other; with
    the port first, authority 0's runner drives GpuBullshark on the CPU."""
    from narwhal_tpu_torch.gpu.dag_kernels import GpuBullshark

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
