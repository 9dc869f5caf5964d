"""The port's copies of host-plane modules behave as the JAX package's.

`narwhal_tpu_torch.{dag, channels, metrics, pacing, tracing}`,
`narwhal_tpu_torch.consensus.metrics` and the host engines
`narwhal_tpu_torch.consensus.{Bullshark, Tusk}` are copies (the port imports
nothing of `narwhal_tpu`). Each case runs one scenario against both
packages' module and compares what it records: the same trace, value for
value. The host engines are the truth `chip_smoke.py` holds the card's
engines to, so they are held here to the JAX engines on lossy streams.
"""

import asyncio
import random
from dataclasses import dataclass, field
from types import SimpleNamespace

import pytest

import narwhal_tpu.channels as j_channels
import narwhal_tpu.consensus as j_consensus
import narwhal_tpu.consensus.metrics as j_cmetrics
import narwhal_tpu.dag as j_dag
import narwhal_tpu.fixtures as j_fixtures
import narwhal_tpu.metrics as j_metrics
import narwhal_tpu.pacing as j_pacing
import narwhal_tpu.stores as j_stores
import narwhal_tpu.tracing as j_tracing
import narwhal_tpu.types as j_types
import narwhal_tpu_torch.channels as t_channels
import narwhal_tpu_torch.consensus as t_consensus
import narwhal_tpu_torch.consensus.metrics as t_cmetrics
import narwhal_tpu_torch.dag as t_dag
import narwhal_tpu_torch.fixtures as t_fixtures
import narwhal_tpu_torch.metrics as t_metrics
import narwhal_tpu_torch.pacing as t_pacing
import narwhal_tpu_torch.stores as t_stores
import narwhal_tpu_torch.tracing as t_tracing
import narwhal_tpu_torch.types as t_types

JAX = SimpleNamespace(dag=j_dag, channels=j_channels, metrics=j_metrics, pacing=j_pacing,
                      cmetrics=j_cmetrics, consensus=j_consensus, fixtures=j_fixtures,
                      stores=j_stores, types=j_types, tracing=j_tracing)
PORT = SimpleNamespace(dag=t_dag, channels=t_channels, metrics=t_metrics, pacing=t_pacing,
                       cmetrics=t_cmetrics, consensus=t_consensus, fixtures=t_fixtures,
                       stores=t_stores, types=t_types, tracing=t_tracing)


@dataclass
class V:
    digest: str
    _parents: list = field(default_factory=list)
    _compressible: bool = False

    def parents(self):
        return list(self._parents)

    def compressible(self):
        return self._compressible


def nodedag_compression(m, seed=3):
    """Random DAGs: inserts with compressible vertices, a dropped parent on
    insert, GC marks and sweeps; record compressed parents, traversals,
    liveness and errors after each step."""
    rng = random.Random(seed)
    dag = m.dag.NodeDag()
    trace, names, layer = [], [], []
    for r in range(8):
        cur = []
        for i in range(4):
            name = f"{r}.{i}"
            parents = rng.sample(layer, k=min(len(layer), rng.randint(1, 3))) if layer else []
            dag.try_insert(V(name, parents, _compressible=rng.random() < 0.4))
            cur.append(name)
        names.extend(cur)
        layer = cur
        if r % 3 == 2:
            for d in rng.sample(names[:-4], 3):
                try:
                    trace.append(("mark", d, dag.make_compressible(d)))
                except (m.dag.DroppedDigest, m.dag.UnknownDigests) as e:
                    trace.append(("mark", d, type(e).__name__))
            trace.append(("sweep", dag.sweep()))
        for d in names:
            if dag.contains_live(d):
                trace.append(("parents", d, sorted(dag.parents(d))))
        trace.append(("heads", sorted(dag.head_digests())))
        trace.append(("bft", [v.digest for v in dag.bft(layer[0])]))
    trace.append(("live", dag.live_size(), dag.size()))
    for bad in ("nope", names[0]):
        try:
            dag.get(bad)
            trace.append(("get", bad, "ok"))
        except (m.dag.DroppedDigest, m.dag.UnknownDigests) as e:
            trace.append(("get", bad, type(e).__name__))
    try:
        dag.try_insert(V("orphan", ["missing-1", "missing-2"]))
    except m.dag.UnknownDigests as e:
        trace.append(("unknown", e.digests))
    return trace


def nodedag_tombstones(m):
    """The reference's compression example: an interior compressible vertex
    is bypassed, swept to a tombstone, and skipped by a later child."""
    dag = m.dag.NodeDag()
    dag.try_insert(V("a"))
    dag.try_insert(V("m", ["a"], _compressible=True))
    dag.try_insert(V("b", ["m"]))
    trace = [dag.parents("b"), [v.digest for v in dag.bft("b")], dag.sweep(),
             dag.contains("m"), dag.contains_live("m")]
    dag.try_insert(V("c", ["m", "b"]))
    trace += [dag.parents("c"), dag.has_head("c"), dag.has_head("b")]
    head = m.dag.NodeDag()
    head.try_insert(V("h", _compressible=True))
    return trace + [head.sweep(), head.contains_live("h")]


def channels(m):
    """Channel capacity, depth, occupancy, depth gauge, try/blocking sends
    and receives, and a burst send drained by a concurrent consumer."""

    async def scenario():
        reg = m.metrics.Registry()
        gauge = reg.gauge("primary_channel_certs_depth", "depth of the certs channel")
        ch = m.channels.Channel(3, gauge=gauge)
        trace = [ch.capacity, ch.try_send(1), ch.try_send(2), ch.depth(), ch.occupancy()]
        trace.append(reg.value("primary_channel_certs_depth"))
        await ch.send(3)
        trace += [ch.try_send(4), ch.qsize(), await ch.recv(), ch.try_recv(), ch.try_recv()]
        trace += [ch.try_recv(), ch.try_recv(), ch.empty()]
        consumer = asyncio.ensure_future(_drain(ch, 5))
        await ch.send_many(range(10, 15))
        trace.append(await consumer)
        trace.append(reg.value("primary_channel_certs_depth"))
        return trace

    return asyncio.run(scenario())


async def _drain(ch, n):
    return [await ch.recv() for _ in range(n)]


def watch_subscriber(m):
    """Watch versions and values, Subscribers that wait for a change or
    see one already sent, and a metered channel's depth gauge."""

    async def scenario():
        w = m.channels.Watch("boot")
        early, late = m.channels.Subscriber(w), None
        trace = [w.value, w.version, early.peek()]
        waiter = asyncio.ensure_future(early.changed())
        await asyncio.sleep(0)
        w.send("epoch-1")
        trace.append(await waiter)
        late = m.channels.Subscriber(w)
        w.send("epoch-2")
        w.send("shutdown")
        trace += [await early.changed(), await late.changed(), w.version,
                  await w.changed(1), late.peek()]
        reg = m.metrics.Registry()
        ch = m.channels.metered_channel(reg, "primary", "certs", 4)
        await ch.send(1)
        ch.try_send(2)
        trace += [ch.capacity, reg.value("primary_channel_certs_depth"), reg.render()]
        return trace

    return asyncio.run(scenario())


def bounded_futures(m):
    """BoundedFuturesOrdered pops in push order whatever finishes first and
    blocks a push when full; BoundedExecutor caps running tasks and refuses
    a try_spawn when full; cancel_all, CancelOnDrop and drain_cancelled end
    what is left."""

    async def scenario():
        trace = []
        pool = m.channels.BoundedFuturesOrdered(2)

        async def job(x, delay):
            await asyncio.sleep(delay)
            return x

        await pool.push(job("a", 0.03))
        await pool.push(job("b", 0.0))
        third = asyncio.ensure_future(pool.push(job("c", 0.01)))
        await asyncio.sleep(0.005)
        trace += [pool.qsize(), third.done()]
        trace += [await pool.next(), await pool.next()]
        await third
        trace.append(await pool.next())
        await pool.push(job("d", 10))
        pool.cancel_all()
        with pytest.raises(asyncio.CancelledError):
            await pool.next()

        ex = m.channels.BoundedExecutor(2)
        gate = asyncio.Event()

        async def held(x):
            await gate.wait()
            return x

        t1 = await ex.spawn(held(1))
        t2 = await ex.spawn(held(2))
        trace.append(ex.try_spawn(held(3)) is None)
        gate.set()
        trace += [await t1, await t2]
        t3 = ex.try_spawn(held(4))
        trace.append(await t3)
        slow = await ex.spawn(asyncio.sleep(10))
        await ex.shutdown()
        trace.append(slow.cancelled())

        handle = m.channels.CancelOnDrop(asyncio.ensure_future(asyncio.sleep(10)))
        handle.cancel()
        await m.channels.drain_cancelled([handle.task], timeout=1.0, who="test")
        trace.append(handle.task.cancelled())
        done = m.channels.CancelOnDrop(asyncio.ensure_future(job("e", 0)))
        trace.append(await done)
        return trace

    return asyncio.run(scenario())


def tracer_spans(m):
    """Two nodes' Tracers fed by StageTimers on one fixed clock, with the
    causal links a batch -> header -> certificate chain records; the
    waterfall and stage percentiles over their dumps, the digest sampling
    decisions, and the live dumps, archive and anomaly surface."""
    now = [0.0]

    def clock():
        now[0] += 0.25
        return now[0]

    m.tracing.new_generation()
    m.tracing.clear_archive()
    reg = m.metrics.Registry()
    hist = reg.histogram("primary_stage_seconds", "per stage", labels=("stage",))
    nodes = [m.tracing.Tracer(node=f"n{i}", enabled=True, sample=1.0, ring=64)
             for i in range(2)]
    half = m.tracing.Tracer(node="sampler", enabled=True, sample=0.5, ring=16)
    trace = [[half.sampled(bytes([b]) * 32) for b in range(0, 256, 17)]]
    rng = random.Random(2)
    for i, tracer in enumerate(nodes):
        timers = {s: m.pacing.StageTimer(hist, s, clock=clock, tracer=tracer)
                  for s in ("seal", "propose", "certify", "commit")}
        for k in range(3):
            batch, header, cert = (bytes([i, k, x]) * 11 for x in (1, 2, 3))
            timers["seal"].close(batch, clock())
            tracer.link("propose", batch, header)
            timers["propose"].start(header)
            timers["propose"].stop(header)
            tracer.link("certify", header, cert)
            timers["certify"].start(cert)
            for _ in range(rng.randrange(1, 4)):
                clock()
            timers["certify"].stop(cert)
            timers["commit"].start(cert)
            timers["commit"].stop(cert)
        tracer.link("self", b"x" * 32, b"x" * 32)
    dumps = m.tracing.live_dumps()
    trace += [[d["node"] for d in dumps], [d["events"] for d in dumps]]
    trace.append(m.tracing.waterfall(dumps))
    trace.append(m.tracing.stage_percentiles(dumps))
    nodes[0].archive()
    got = sorted(m.tracing.on_anomaly("stall"), key=lambda d: d["node"])
    trace += [[(d["node"], d["anomalies"]) for d in got],
              sorted((d["node"], d.get("anomaly", "")) for d in m.tracing.ARCHIVE),
              len(m.tracing.all_dumps())]
    m.tracing.clear_archive()
    return trace


def metrics(m):
    """Counters, gauges, labelled histograms; the rendered exposition and
    re-registration rules."""
    reg = m.metrics.Registry()
    c = reg.counter("node_things_total", "things seen")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("worker_queue_depth", "queue depth", labels=("queue",))
    g.labels("a").set(7)
    g.labels("b").inc(3)
    g.labels("b").dec()
    h = reg.histogram("primary_latency_seconds", "latency", labels=("stage",),
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.labels("commit").observe(v)
    trace = [reg.counter("node_things_total") is c, c.get(), reg.value("worker_queue_depth", "b"),
             reg.value("primary_latency_seconds", "commit"), reg.value("absent")]
    try:
        reg.gauge("node_things_total")
    except ValueError as e:
        trace.append(str(e))
    text = reg.render()
    return trace + [text]


def stage_timer(m):
    """StageTimer on a fake clock: first sighting wins, closed keys latch,
    the pending map evicts oldest-first, and the EWMA tracks closes."""
    now = [0.0]
    reg = m.metrics.Registry()
    hist = reg.histogram("consensus_stage_seconds", "per stage", labels=("stage",),
                         buckets=(0.5, 1.0, 2.0, 4.0))
    timer = m.pacing.StageTimer(hist, "commit", max_pending=3, clock=lambda: now[0],
                                max_closed=2)
    trace = []
    for step, (op, key) in enumerate([
        ("start", "a"), ("start", "b"), ("start", "a"), ("start", "c"), ("stop", "a"),
        ("start", "a"), ("start", "d"), ("start", "e"), ("stop", "b"), ("stop", "c"),
        ("stop", "d"), ("start", "a"), ("stop", "e"), ("stop", "zz"),
    ]):
        now[0] = 0.75 * step
        if op == "start":
            timer.start(key)
        else:
            trace.append((key, timer.stop(key)))
    timer.observe(3.0)
    trace.append(("close", timer.close("late", 1.0)))
    return trace + [timer.ewma, reg.render()]


def consensus_metrics(m):
    """ConsensusMetrics registers the same series, the dag_read_* ones
    included, and its commit timer feeds the stage histogram."""
    reg = m.metrics.Registry()
    cm = m.cmetrics.ConsensusMetrics(reg)
    cm.dag_read_latency.labels("device").observe(0.002)
    cm.dag_read_route_ewma_ms.labels("host").set(1.5)
    cm.dag_read_coalesced_batch.set(64)
    cm.commit_timer.observe(0.2)
    cm.committed_certificates.inc(3)
    return reg.render()


@pytest.mark.parametrize(
    "scenario",
    [nodedag_compression, nodedag_tombstones, channels, metrics, stage_timer,
     consensus_metrics, watch_subscriber, bounded_futures, tracer_spans],
    ids=lambda f: f.__name__,
)
def test_port_copy_matches_the_jax_module(scenario):
    want = scenario(JAX)
    assert want  # the scenario recorded something
    assert scenario(PORT) == want


def host_engine(m, rule, seed, leader):
    """One lossy stream (N = 5, 40 rounds, GC depth 10) through a host
    engine: its (digest, consensus_index) sequence with the certificate
    that triggered each commit, the rounds last
    committed per authority, the rounds the state still holds, and the
    consensus store's record."""
    f = m.fixtures.CommitteeFixture(size=5)
    committee = f.committee
    genesis = m.types.Certificate.genesis(committee)
    certs, _ = m.fixtures.make_certificates(
        committee, 1, 40, {c.digest for c in genesis}, failure_probability=0.25,
        rng=random.Random(seed))
    keys = committee.authority_keys()
    leader_fn = None
    if leader == "fixed":
        def leader_fn(committee, round, dag):
            return dag.get(round, {}).get(keys[0])
    store = m.stores.NodeStorage(None).consensus_store
    engine = getattr(m.consensus, rule)(committee, store, 10, leader_fn=leader_fn)
    state = m.consensus.ConsensusState(genesis)
    seq, index = [], 0
    for at, c in enumerate(certs):  # `at`: which certificate triggered each commit
        outs = engine.process_certificate(state, index, c)
        index += len(outs)
        seq.extend((at, o.certificate.digest, o.consensus_index) for o in outs)
    return (seq, [state.last_committed[k] for k in keys], sorted(state.dag),
            [store.read_last_committed().get(k) for k in keys], store.last_consensus_index())


@pytest.mark.parametrize("leader", ["fixed", "weighted"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rule", ["Bullshark", "Tusk"])
def test_port_host_engine_matches_the_jax_engine(rule, seed, leader):
    want = host_engine(JAX, rule, seed, leader)
    assert len(want[0]) > 40  # the stream commits
    assert host_engine(PORT, rule, seed, leader) == want
