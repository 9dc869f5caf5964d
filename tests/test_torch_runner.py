"""The port's consensus runner against the JAX package's.

The JAX `Consensus` drives the JAX host `Bullshark` (or `Tusk`); the port's
`Consensus` drives `GpuBullshark(device="cpu")` (or `GpuTusk`), the card
engines through their plain versions. Each node runs on its own durable
`NodeStorage(tmp_path)` (the default backend: the native engine in the
port, whichever the JAX package loads), is fed one seeded lossy N = 4
stream by `chip_smoke.consensus_life` (each burst group-committed to the
certificate store, then sent at once), and is shut down through the Watch.
Both nodes must give equal `ConsensusOutput` sequences, equal `tx_primary`
streams, equal `ConsensusStore` records and equal consensus metrics:

- restart: stopped after round 15 and restarted from the same directory
  (recovery through `ConsensusState.new_from_store` and `recover`), the
  second life's first burst 80 certificates (drained 64, then 16);
- gap: stopped inside a stretch of rounds without an elected leader, where
  the port's window grew, and restarted;
- epoch: a new committee through the Watch after round 15, then stale
  certificates of the old epoch (dropped) and the new epoch's stream;
- lone: every certificate sent alone (`process_certificate_async` in the
  port), with a restart after round 10.
"""

import asyncio
from types import SimpleNamespace

import pytest

import chip_smoke
import narwhal_tpu.channels as j_channels
import narwhal_tpu.consensus as j_consensus
import narwhal_tpu.consensus.metrics as j_cmetrics
import narwhal_tpu.fixtures as j_fixtures
import narwhal_tpu.metrics as j_metrics
import narwhal_tpu.stores as j_stores
import narwhal_tpu.types as j_types
import narwhal_tpu_torch.fixtures as t_fixtures
from narwhal_tpu_torch.gpu import dag_kernels as td

JAX = SimpleNamespace(channels=j_channels, consensus=j_consensus, cmetrics=j_cmetrics,
                      metrics=j_metrics, stores=j_stores, types=j_types, fixtures=j_fixtures)
PORT = chip_smoke.port_modules()
PORT.fixtures = t_fixtures
GC = 10
METRICS = ("consensus_committed_certificates", "consensus_last_committed_round",
           "consensus_dag_size", "consensus_recovered_consensus_state")


def by_round(certs):
    out: dict[int, list] = {}
    for c in certs:
        out.setdefault(c.round, []).append(c)
    return out


def plan(scenario):
    """The port's certificates as lives: each a list of bursts and the
    notes sent before some of them ({burst index: ("new_epoch", fixture
    epoch)})."""
    f = PORT.fixtures.CommitteeFixture(size=4)
    if scenario == "gap":
        certs = chip_smoke.lossy_dag(f.committee, 34, 8, gap=range(6, 26), weak={28})
        r = by_round(certs)
        life1 = [sum((r[x] for x in range(1, 13)), []), sum((r[x] for x in range(13, 25)), [])]
        life2 = [sum((r[x] for x in range(25, 35)), [])]
        return [(life1, {}), (life2, {})], 24
    certs = chip_smoke.lossy_dag(f.committee, 35, 3, gap=range(0), weak={20})
    r = by_round(certs)
    if scenario == "restart":
        life1 = [sum((r[x] for x in range(1, 15)), [])] + [[c] for c in r[15]]
        life2 = [sum((r[x] for x in range(16, 36)), [])]
        return [(life1, {}), (life2, {})], 15
    if scenario == "lone":
        lone = [[c] for x in range(1, 21) for c in r[x]]
        return [(lone[:40], {}), (lone[40:], {})], 10
    # epoch: the new committee's stream, and old-epoch certificates after
    # the change (stale: the runner drops them).
    g = PORT.fixtures.CommitteeFixture(size=4, epoch=1)
    genesis = {c.digest for c in PORT.types.Certificate.genesis(g.committee)}
    new, _ = PORT.fixtures.make_certificates_with_epoch(g.committee, 1, 16, 1, genesis)
    nr = by_round(new)
    bursts = ([sum((r[x] for x in range(1, 11)), []), sum((r[x] for x in range(11, 16)), [])]
              + [r[16] + r[17]] + [sum((nr[x] for x in range(1, 9)), [])]
              + [[c] for c in nr[9]] + [sum((nr[x] for x in range(10, 17)), [])])
    return [(bursts, {2: 1})], None


def convert(m, certs):
    if m is PORT:
        return certs
    return [m.types.Certificate.from_bytes(c.to_bytes()) for c in certs]


def make_engine(m, rule, committee, storage):
    if m is PORT:
        return getattr(td, rule)(committee, storage.consensus_store, GC, device="cpu")
    host = {"GpuBullshark": "Bullshark", "GpuTusk": "Tusk"}[rule]
    return getattr(m.consensus, host)(committee, storage.consensus_store, GC)


def run_node(m, rule, scenario, path):
    lives, _stop = plan(scenario)
    committee = m.fixtures.CommitteeFixture(size=4).committee
    registry = m.metrics.Registry()
    metrics = m.cmetrics.ConsensusMetrics(registry)
    outs, prim, widths, lone_calls = [], [], [], [0]
    for bursts, notes in lives:
        storage = m.stores.NodeStorage(str(path))
        engine = make_engine(m, rule, committee, storage)
        if hasattr(engine, "process_certificate_async"):
            inner = engine.process_certificate_async

            async def counted(state, index, cert, inner=inner):
                lone_calls[0] += 1
                return await inner(state, index, cert)

            engine.process_certificate_async = counted
        if hasattr(engine, "win"):
            widths.append(engine.win.W)
        notes = {i: m.types.ReconfigureNotification(
            "new_epoch", m.fixtures.CommitteeFixture(size=4, epoch=e).committee)
            for i, e in notes.items()}
        o, p, runner, _engine_s = asyncio.run(chip_smoke.consensus_life(
            m, committee, engine, storage, [convert(m, b) for b in bursts], GC, metrics,
            notes, timeout=120.0))
        if hasattr(engine, "win"):
            widths.append(engine.win.W)
        outs += [(x.certificate.digest, x.consensus_index) for x in o]
        prim += [c.digest for c in p]
        record = chip_smoke.store_record(storage.consensus_store)
        storage.close()
    values = [registry.value(name) for name in METRICS]
    return outs, prim, record, values, runner.committee.epoch, widths, lone_calls[0]


@pytest.mark.parametrize("scenario", ["restart", "gap", "epoch", "lone"])
@pytest.mark.parametrize("rule", ["GpuBullshark", "GpuTusk"])
def test_port_runner_matches_the_jax_runner(tmp_path, rule, scenario):
    port = run_node(PORT, rule, scenario, tmp_path / "port")
    jax = run_node(JAX, rule, scenario, tmp_path / "jax")
    assert port[:5] == jax[:5]
    outs, prim, record, values, epoch, widths, lone = port
    assert prim == [d for d, _ in outs] and len(outs) > 20
    assert record[2][-1][1] == outs[-1][0]
    _lives, stop = plan(scenario)
    if stop is not None:
        assert values[3] == 1  # the second life recovered from the store
        assert any(r > stop for r in (c.round for c in _committed(outs, scenario)))
    if scenario == "epoch":
        assert epoch == 1 and outs[-1][1] < len(outs) - 1  # the index restarted
    if scenario == "gap":
        assert widths[1] > widths[0]  # the window grew before the stop
    if scenario in ("restart", "lone"):
        assert lone > 0


def _committed(outs, scenario):
    lives, _stop = plan(scenario)
    certs = {c.digest: c for bursts, _ in lives for b in bursts for c in b}
    return [certs[d] for d, _ in outs]


def test_shutdown_with_a_readback_in_flight():
    """Cancelling the runner while a commit's readback is awaited off-thread
    ends the run cleanly: the loop's executor joins the readback before
    asyncio.run returns, and nothing is emitted after the cancellation."""
    import threading

    f = PORT.fixtures.CommitteeFixture(size=4)
    certs = chip_smoke.lossy_dag(f.committee, 12, 5, gap=range(0), weak=set())
    storage = PORT.stores.NodeStorage(None)
    engine = td.GpuBullshark(f.committee, storage.consensus_store, GC, device="cpu")
    started, release = threading.Event(), threading.Event()
    dispatch = engine._dispatch_commit

    def slow_dispatch(*a):
        res = dispatch(*a)
        if res is None:
            return None
        readback, k = res

        class Slow:
            def result(self):
                started.set()
                release.wait(10)
                return readback.result()

        return Slow(), k

    engine._dispatch_commit = slow_dispatch

    async def scenario():
        rx, tx_primary, tx_output = (PORT.channels.Channel(1000) for _ in range(3))
        watch = PORT.channels.Watch(PORT.types.ReconfigureNotification("boot"))
        runner = PORT.consensus.Consensus(f.committee, engine, storage.consensus_store,
                                          storage.certificate_store, rx, tx_primary,
                                          tx_output, watch, GC)
        task = runner.spawn()
        await rx.send_many(certs)
        while not started.is_set():
            await asyncio.sleep(0.001)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        threading.Timer(0.05, release.set).start()
        return tx_output.qsize()

    assert asyncio.run(asyncio.wait_for(scenario(), 30)) == 0
    assert release.is_set()
