"""Scenario runner: one seeded, virtual-clock simulation from boot to verdict.

Port copy of `narwhal_tpu/simnet/scenario.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

`run_scenario(...)` is a synchronous entry point that owns the whole
lifecycle: build a `SimLoop` (virtual clock), install a seeded `SimFabric`
behind the transport seam, boot a `SimCluster`, drive load and the
`FaultPlan`'s events at their virtual times, then tear everything down with
bounded (virtual-time, therefore instant) cleanup and return a
`ScenarioResult` the oracles consume.

Determinism contract: with the same arguments and `plan.seed`, two runs in
the same process produce bit-identical commit sequences AND a bit-identical
fabric event log (`ScenarioResult.event_log_digest`). Everything
time-driven runs on the virtual clock; the only RNG consumers are the
fabric's seeded jitter/drop stream and the globally seeded `random` module
(retry jitter, lucky broadcasts), both reset at scenario start. Across
*processes* the guarantee additionally requires a pinned PYTHONHASHSEED
(set-iteration order over byte keys follows the process hash seed).

Wall-clock cost is the scenario's CPU work only: every `asyncio.sleep`,
pacing deadline, retry backoff and cleanup grace elapses in simulated time.

The port's backends: `crypto_backend`, `dag_backend` and `device` go to the
port's `Cluster`, and None keeps its defaults, the card's (`cuda`, `cuda`,
the card itself: with no card the scenario raises before a node boots). On
`crypto_backend="cuda"` every node verifies through an `AsyncVerifierPool`
over one `GpuVerifier` (`SimCluster._crypto_pool`), whose launches run on
the loop's thread inside `SimLoop.run_in_executor`: a verdict costs no
virtual time, so a card run replays the host run's event log bit for bit.
The card has no host fallback: a pool whose backend raises hands the error
to every waiter, and the verifier stage drops the message under
`"backend"`. `ScenarioResult.stage_drops` carries every node's drops, so
a caller can fail a run that dropped one.
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import json
import random as _random
import time as _wall
from dataclasses import dataclass, field

from .. import types as _types
from ..network import NetworkClient, auth as _auth, transport
from ..network.rpc import WireStats
from ..messages import ReconfigureMsg, SubmitTransactionStreamMsg
from .byzantine import Equivocator
from .clock import SimLoop
from .cluster import SimCluster, node_id
from .fabric import SimFabric
from .plan import (
    Crash,
    Equivocate,
    FaultPlan,
    LinkFault,
    Partition,
    Reconfigure,
    WorkerLoss,
)


@dataclass
class ScenarioResult:
    nodes: int
    duration: float
    seed: int
    commits: list  # per node: [(epoch, round, digest-hex), ...]
    rounds: list  # per node: last committed round at scenario end
    round_marks: dict  # event label -> per-node committed rounds snapshot
    executed: list  # per node: executed tx count
    identical_execution_prefix: bool
    sent_txs: int
    shed_txs: int
    inject_errors: int
    latency_p50_ms: float
    latency_p95_ms: float
    latency_samples: int
    epochs: tuple
    equivocation: dict  # node index -> {"twins_sent": n, "rounds": [...]}
    wire_bytes_sent: int
    wire_frames_sent: int
    event_log_digest: str
    event_log_len: int
    wall_s: float
    byzantine: tuple = ()
    crashed: tuple = ()
    # Certificate wire forms accumulated in each alive node's store
    # ({"compact": n, "full": n} per node): scenario tests pin that a
    # compact-committee run really exercised the half-aggregated form.
    cert_forms: list = field(default_factory=list)
    log_entries: list = field(default_factory=list, repr=False)
    # Per-node flight-recorder dumps (tracing.Tracer.dump) captured before
    # teardown: span edges + occupancy instants on the VIRTUAL clock, so the
    # same seed reproduces a bit-identical traced event log (the trace
    # determinism test keys on this field).
    flight_dumps: list = field(default_factory=list, repr=False)
    # Per node, the verifier stage's drops by (message type, reason):
    # "signature", "malformed" or "backend" (the crypto pool raised), summed
    # over the node's incarnations; empty for a node without a stage.
    stage_drops: tuple = ()

    def honest(self) -> list[int]:
        return [i for i in range(self.nodes) if i not in self.byzantine]

    def backend_drops(self) -> int:
        """Messages any node dropped because its crypto backend raised."""
        return sum(
            n for drops in self.stage_drops
            for (_, reason), n in drops.items() if reason == "backend"
        )


def run_scenario(
    nodes: int = 4,
    workers: int = 1,
    duration: float = 5.0,
    plan: FaultPlan | None = None,
    load_rate: int = 0,
    tx_size: int = 64,
    auth: bool = True,
    max_header_delay: float = 0.05,
    max_batch_delay: float = 0.05,
    parameters=None,
    drain_tail: float = 1.0,
    keep_log: bool = False,
    crypto_backend: str | None = None,
    dag_backend: str | None = None,
    device=None,
) -> ScenarioResult:
    plan = plan or FaultPlan()
    loop = SimLoop()
    asyncio.set_event_loop(loop)
    fabric = SimFabric(seed=plan.seed, default_link=plan.default_link)
    transport.install(fabric)
    # Retry jitter / lucky broadcasts draw from the global random module:
    # pin it to the plan's seed so their draws replay too.
    _random.seed(plan.seed)
    # Handshake nonces/ephemerals come from the auth entropy seam: a seeded
    # hash stream makes every wire transcript — and thus the whole event
    # log — replay bit-identically.
    entropy_state = [b"simnet" + plan.seed.to_bytes(8, "big")]

    def seeded_entropy(n: int) -> bytes:
        out = b""
        while len(out) < n:
            entropy_state[0] = hashlib.sha256(entropy_state[0]).digest()
            out += entropy_state[0]
        return out[:n]

    prev_entropy = _auth.set_entropy(seeded_entropy)
    # Same contract for the batch verifier's outer combination weights
    # (types.host_batch_verify_aggregates): seeded weights keep the group
    # arithmetic of a replayed run bit-identical too.
    prev_weights = _types.set_weight_entropy(seeded_entropy)
    # The port Cluster's defaults (the card) stand for every backend
    # keyword left as None.
    backends = {
        k: v for k, v in (
            ("crypto_backend", crypto_backend),
            ("dag_backend", dag_backend),
            ("device", device),
        ) if v is not None
    }
    t_wall = _wall.monotonic()
    try:
        result = loop.run_until_complete(
            _drive(
                fabric, plan, nodes, workers, duration, load_rate, tx_size,
                auth, max_header_delay, max_batch_delay, parameters,
                drain_tail, keep_log, backends,
            )
        )
        result.wall_s = round(_wall.monotonic() - t_wall, 3)
        return result
    finally:
        _auth.set_entropy(prev_entropy)
        _types.set_weight_entropy(prev_weights)
        transport.uninstall()
        _cleanup(loop)


def _cleanup(loop: SimLoop) -> None:
    """Bounded straggler cleanup (mirrors tests/conftest.py, but the grace
    window elapses in virtual time, so it costs no wall clock)."""
    pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
    for t in pending:
        t.cancel()
    if pending:
        loop.run_until_complete(asyncio.wait(pending, timeout=15.0))
    loop.run_until_complete(loop.shutdown_asyncgens())
    asyncio.set_event_loop(None)
    loop.close()


async def _drive(
    fabric, plan, nodes, workers, duration, load_rate, tx_size, auth,
    max_header_delay, max_batch_delay, parameters, drain_tail, keep_log,
    backends,
) -> ScenarioResult:
    cluster = SimCluster(
        size=nodes,
        fabric=fabric,
        workers=workers,
        parameters=parameters,
        auth=auth,
        max_header_delay=max_header_delay,
        max_batch_delay=max_batch_delay,
        **backends,
    )
    wire0 = WireStats.snapshot()
    await cluster.start()

    byzantine = plan.byzantine_nodes()
    equivocators: dict[int, Equivocator] = {}

    def install_equivocator(i: int) -> None:
        if i not in equivocators and cluster.authorities[i].primary is not None:
            equivocators[i] = Equivocator(
                cluster.authorities[i],
                cluster.fixture.authorities[i],
                cluster.committee,
            )

    # Executed-output drains: per-node executed counts + order prefixes
    # (also keeps tx_execution_output from wedging full — the PR-6 lesson).
    executed = [0] * nodes
    exec_orders: list[list[bytes]] = [[] for _ in range(nodes)]
    latencies: list[float] = []
    sent_at: dict[int, float] = {}
    drains: dict[int, asyncio.Task] = {}

    def spawn_drain(i: int) -> None:
        async def drain() -> None:
            ch = cluster.authorities[i].primary.tx_execution_output
            while True:
                _, tx = await ch.recv()
                executed[i] += 1
                exec_orders[i].append(bytes(tx[:9]))
                if i == 0 and tx[:1] == b"\x00":
                    sid = int.from_bytes(tx[1:9], "big")
                    t0 = sent_at.pop(sid, None)
                    if t0 is not None:
                        latencies.append(asyncio.get_event_loop().time() - t0)

        old = drains.pop(i, None)
        if old is not None:
            old.cancel()
        drains[i] = asyncio.ensure_future(drain())

    for i in range(nodes):
        spawn_drain(i)

    # Verifier-stage drops, summed over each node's incarnations: a crash
    # folds the stopped node's counts in before its primary goes.
    stage_drops = [collections.Counter() for _ in range(nodes)]

    def harvest_drops(i: int) -> None:
        node = cluster.authorities[i].primary
        stage = node.primary.verifier_stage if node is not None else None
        if stage is not None:
            stage_drops[i].update(stage.drops)
    for event in plan.events:
        if isinstance(event, Equivocate) and event.start <= 0:
            install_equivocator(event.node)

    # -- load ---------------------------------------------------------------
    sent = {"txs": 0, "shed": 0, "errors": 0}
    stop_load = asyncio.Event()
    client = NetworkClient()
    injectors: list[asyncio.Task] = []
    if load_rate > 0:
        tx_size = max(tx_size, 10)
        lanes = [
            (i, cluster.worker_cache.worker(a.name, wid).transactions)
            for i, a in enumerate(cluster.authorities)
            for wid in range(workers)
        ]
        share = max(1, load_rate // len(lanes))
        sid_counter = [0]

        async def inject(owner: int, lane: str) -> None:
            loop = asyncio.get_event_loop()
            while not stop_load.is_set():
                tick = loop.time()
                txs = []
                for _ in range(share):
                    sid_counter[0] += 1
                    sid = sid_counter[0]
                    sent_at[sid] = loop.time()
                    txs.append(
                        b"\x00" + sid.to_bytes(8, "big")
                        + b"\x01" * (tx_size - 9)
                    )
                try:
                    await client.request(
                        lane, SubmitTransactionStreamMsg(tuple(txs)),
                        timeout=2.0,
                    )
                    sent["txs"] += len(txs)
                except Exception as e:
                    if "RESOURCE_EXHAUSTED" in str(e):
                        sent["shed"] += len(txs)
                    else:  # crashed/partitioned lane: drop this tick
                        sent["errors"] += 1
                    for tx in txs:
                        sent_at.pop(int.from_bytes(tx[1:9], "big"), None)
                await asyncio.sleep(max(0.0, 1.0 - (loop.time() - tick)))

        injectors = [
            asyncio.ensure_future(inject(i, lane)) for i, lane in lanes
        ]

    # -- the fault plan, applied at its virtual times -----------------------
    round_marks: dict[str, list[float]] = {}
    crashed: set[int] = set()
    epoch_counter = [cluster.committee.epoch]

    def mark(label: str) -> None:
        round_marks[label] = cluster.committed_rounds()

    async def apply(event) -> None:
        if isinstance(event, Partition):
            mark(f"partition@{event.at}")
            fabric.set_partition(
                tuple(tuple(node_id(i) for i in g) for g in event.groups)
            )
        elif isinstance(event, LinkFault):
            fabric.set_link(node_id(event.a), node_id(event.b), event.link)
        elif isinstance(event, Crash):
            mark(f"crash@{event.at}")
            crashed.add(event.node)
            drains.pop(event.node).cancel()
            eq = equivocators.pop(event.node, None)
            if eq is not None:
                eq.uninstall()
            harvest_drops(event.node)
            await cluster.crash_node(event.node)
        elif isinstance(event, WorkerLoss):
            mark(f"workerloss@{event.at}")
            await cluster.authorities[event.node].stop_worker(event.worker_id)
        elif isinstance(event, Reconfigure):
            mark(f"reconfigure@{event.at}")
            epoch_counter[0] += 1
            await _reconfigure(cluster, epoch_counter[0], auth)

    async def run_plan() -> None:
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        # Expand Partition into (at, apply) + (heal, heal), Crash into
        # (at, crash) + (restart_at, restart), keeping virtual order.
        schedule: list[tuple[float, int, object, str]] = []
        for seq, event in enumerate(plan.timed_events()):
            schedule.append((event.at, seq, event, "apply"))
            if isinstance(event, Partition):
                schedule.append((event.heal, seq, event, "heal"))
            if isinstance(event, Crash) and event.restart_at is not None:
                schedule.append((event.restart_at, seq, event, "restart"))
            if isinstance(event, LinkFault) and event.end is not None:
                schedule.append((event.end, seq, event, "clear"))
        for at, _, event, phase in sorted(schedule, key=lambda e: (e[0], e[1])):
            delay = t0 + at - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            if phase == "apply":
                await apply(event)
            elif phase == "heal":
                mark(f"heal@{event.heal}")
                fabric.set_partition(None)
            elif phase == "clear":
                fabric.set_link(node_id(event.a), node_id(event.b), None)
            elif phase == "restart":
                mark(f"restart@{event.restart_at}")
                crashed.discard(event.node)
                await cluster.restart_node(event.node)
                spawn_drain(event.node)
                if event.node in plan.byzantine_nodes():
                    install_equivocator(event.node)

    plan_task = asyncio.ensure_future(run_plan())
    late_tasks: list[asyncio.Task] = []
    for event in plan.events:
        if isinstance(event, Equivocate) and event.start > 0:
            async def late_install(e=event):
                await asyncio.sleep(e.start)
                install_equivocator(e.node)

            late_tasks.append(asyncio.ensure_future(late_install()))

    # -- run the window ------------------------------------------------------
    await asyncio.sleep(duration)
    stop_load.set()
    for t in injectors + late_tasks:
        t.cancel()
    await plan_task
    if drain_tail > 0:
        await asyncio.sleep(drain_tail)

    # -- capture BEFORE teardown (shutdown ordering is not part of the
    #    deterministic contract) -------------------------------------------
    mark("end")
    rounds = cluster.committed_rounds()
    # Flight recorders, captured while the nodes are alive: every timestamp
    # inside rides the virtual clock, so the dumps are part of the same-seed
    # determinism contract the event log carries.
    flight_dumps = []
    for i, a in enumerate(cluster.authorities):
        if a.primary is not None:
            flight_dumps.append(a.primary.tracer.dump())
        for wid in sorted(a.workers):
            flight_dumps.append(a.workers[wid].tracer.dump())
    cert_forms = []
    for a in cluster.authorities:
        forms = {"compact": 0, "full": 0}
        if a.primary is not None:
            for cert in a.primary.storage.certificate_store.after_round(1):
                forms["compact" if cert.is_compact else "full"] += 1
        cert_forms.append(forms)
    for i in range(nodes):
        harvest_drops(i)
    wire1 = WireStats.snapshot()
    log_digest = fabric.log.digest()
    log_len = len(fabric.log)
    lat = sorted(latencies)

    def pct(p: float) -> float:
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(p * len(lat)))]

    prefix_nodes = [
        exec_orders[i] for i in range(nodes) if i not in crashed
    ] or [[]]
    min_len = min(len(o) for o in prefix_nodes)
    identical = all(
        o[:min_len] == prefix_nodes[0][:min_len] for o in prefix_nodes
    )
    epochs = tuple(
        sorted({e for seq in cluster.commits for (e, _, _) in seq})
    )
    equivocation = {
        i: {"twins_sent": eq.twins_sent, "rounds": [r for r, _, _ in eq.twin_digests]}
        for i, eq in equivocators.items()
    }

    for eq in equivocators.values():
        eq.uninstall()
    for t in drains.values():
        t.cancel()
    client.close()
    await cluster.shutdown()

    return ScenarioResult(
        nodes=nodes,
        duration=duration,
        seed=plan.seed,
        commits=cluster.commits,
        rounds=rounds,
        round_marks=round_marks,
        executed=executed,
        identical_execution_prefix=identical,
        sent_txs=sent["txs"],
        shed_txs=sent["shed"],
        inject_errors=sent["errors"],
        latency_p50_ms=round(pct(0.50) * 1000, 2),
        latency_p95_ms=round(pct(0.95) * 1000, 2),
        latency_samples=len(lat),
        epochs=epochs,
        equivocation=equivocation,
        wire_bytes_sent=wire1["bytes_sent"] - wire0["bytes_sent"],
        wire_frames_sent=wire1["frames_sent"] - wire0["frames_sent"],
        event_log_digest=log_digest,
        event_log_len=log_len,
        wall_s=0.0,
        byzantine=tuple(sorted(byzantine)),
        crashed=tuple(sorted(crashed)),
        cert_forms=cert_forms,
        log_entries=list(fabric.log.entries) if keep_log else [],
        flight_dumps=flight_dumps,
        stage_drops=tuple(dict(d) for d in stage_drops),
    )


async def _reconfigure(cluster, epoch: int, auth: bool) -> None:
    """In-band epoch change under traffic: push a NewEpoch ReconfigureMsg
    (same committee, epoch bumped) through every primary's own-worker
    control plane, like the reference app drives state_handler.rs."""
    doc = json.loads(cluster.committee.to_json())
    doc["epoch"] = epoch
    msg = ReconfigureMsg("new_epoch", json.dumps(doc))
    clients = []
    try:
        for i, a in enumerate(cluster.authorities):
            if a.primary is None:
                continue
            if auth:
                from ..network import Credentials, committee_resolver

                client = NetworkClient(
                    credentials=Credentials(
                        cluster.fixture.authorities[i].worker_keypairs[0],
                        committee_resolver(
                            lambda: cluster.committee,
                            lambda: cluster.worker_cache,
                        ),
                    )
                )
            else:
                client = NetworkClient()
            clients.append(client)
            await client.unreliable_send(a.primary.address, msg, timeout=5.0)
    finally:
        for client in clients:
            client.close()
