"""The port's `executor/` and metrics exposition against the JAX package's.

- The JAX package's executor scenarios (`tests/test_executor_replay.py`,
  `tests/test_commit_pipeline.py`) run against the port: each module's
  source with the package name swapped.
- The same seeded `ConsensusOutput` stream, its batches served by a worker
  on loopback, goes through the JAX `Executor` and the port's: the
  (certificate digest, ExecutionIndices bytes, transaction) sequence that
  reaches the `ExecutionState`, the output stream, and
  `get_restored_consensus_output` after a crash mid-stream are equal.
- `parse_exposition` and `scrape_snapshot` give equal results in both
  packages for the same registry operations.
"""

import asyncio
import re
import types
from pathlib import Path

import numpy as np
import pytest

import narwhal_tpu.channels as j_channels
import narwhal_tpu.config as j_config
import narwhal_tpu.executor as j_executor
import narwhal_tpu.fixtures as j_fixtures
import narwhal_tpu.messages as j_messages
import narwhal_tpu.metrics as j_metrics
import narwhal_tpu.network as j_network
import narwhal_tpu.stores as j_stores
import narwhal_tpu.types as j_types
import narwhal_tpu_torch.channels as t_channels
import narwhal_tpu_torch.config as t_config
import narwhal_tpu_torch.executor as t_executor
import narwhal_tpu_torch.fixtures as t_fixtures
import narwhal_tpu_torch.messages as t_messages
import narwhal_tpu_torch.metrics as t_metrics
import narwhal_tpu_torch.network as t_network
import narwhal_tpu_torch.stores as t_stores
import narwhal_tpu_torch.types as t_types
from test_torch_network import port_scenarios

TESTS = Path(__file__).resolve().parent
FILES = ("test_executor_replay.py", "test_commit_pipeline.py")

_SCENARIOS = {}
for _file in FILES:
    for _name, _fn in port_scenarios(_file).items():
        assert _name not in _SCENARIOS and _name not in globals(), _name
        _SCENARIOS[_name] = _fn
globals().update(_SCENARIOS)


def test_all_reference_executor_scenarios_collected():
    ref = set()
    for file in FILES:
        ref |= set(re.findall(r"^def (test_\w+)", (TESTS / file).read_text(), re.M))
    assert set(_SCENARIOS) == ref and len(ref) == 11


PKGS = {
    name: types.SimpleNamespace(channels=ch, config=cfg, executor=ex, fixtures=fx, messages=ms,
                                metrics=mt, network=nw, stores=st, types=ty)
    for name, (ch, cfg, ex, fx, ms, mt, nw, st, ty) in {
        "port": (t_channels, t_config, t_executor, t_fixtures, t_messages, t_metrics,
                 t_network, t_stores, t_types),
        "jax": (j_channels, j_config, j_executor, j_fixtures, j_messages, j_metrics,
                j_network, j_stores, j_types),
    }.items()
}


# -- the executor, end to end ------------------------------------------------


class Crash(Exception):
    pass


def journal_state(m):
    """An ExecutionState recording (certificate digest, ExecutionIndices
    bytes, transaction) and persisting its cursor in memory, armed to crash
    before its `crash_at`-th call."""

    class Journal(m.executor.ExecutionState):
        def __init__(self):
            self.seen, self.crash_at, self.calls = [], None, 0
            self.indices = m.executor.ExecutionIndices()

        async def handle_consensus_transaction(self, output, indices, transaction):
            if self.crash_at is not None and self.calls >= self.crash_at:
                raise Crash()
            self.calls += 1
            self.seen.append((output.certificate.digest, indices.to_bytes(), bytes(transaction)))
            self.indices = indices
            return b"r" + bytes(transaction[:4])

        async def load_execution_indices(self):
            return self.indices

    return Journal()


def seeded_stream(m, seed: int):
    """A fixture committee, seeded batches and a stream of ordered
    certificates over them (some empty, authors and rounds spread), each
    batch in exactly one certificate."""
    f = m.fixtures.CommitteeFixture(size=4)
    rng = np.random.default_rng(seed)
    batches = [m.types.Batch(tuple(rng.bytes(int(rng.integers(4, 40)))
                                   for _ in range(int(rng.integers(1, 7)))))
               for _ in range(14)]
    outputs, k = [], 0
    for i in range(9):
        take = int(rng.integers(0, 4))
        payload = {b.digest: 0 for b in batches[k:k + take]}
        k += take
        cert = f.certificate(f.header(author=i % 4, round=1 + i // 4, payload=payload))
        outputs.append(m.types.ConsensusOutput(certificate=cert, consensus_index=i))
    rest = {b.digest: 0 for b in batches[k:]}
    cert = f.certificate(f.header(author=1, round=4, payload=rest))
    outputs.append(m.types.ConsensusOutput(certificate=cert, consensus_index=len(outputs)))
    return f, batches, outputs


async def executor_run(m, seed: int, crash_at: int | None):
    """The stream through package `m`'s Executor (prefetcher on an accepted
    tap fed every certificate first), its batches served by a worker stub on
    loopback; with `crash_at`, the execution state crashes before that
    transaction, and a new Executor over the same storage replays
    `get_restored_consensus_output`."""
    f, batches, outputs = seeded_stream(m, seed)
    by_digest = {b.digest: b.to_bytes() for b in batches}
    srv = m.network.RpcServer()

    async def on_request(msg, peer):
        return m.messages.RequestedBatchesMsg(
            tuple((d, d in by_digest, by_digest.get(d, b"")) for d in msg.digests))

    srv.route(m.messages.RequestBatchesMsg, on_request)
    port = await srv.start("127.0.0.1", 0)
    pk = f.authorities[0].public
    info = f.worker_cache.workers[pk][0]
    f.worker_cache.workers[pk][0] = m.config.WorkerInfo(
        name=info.name, transactions=info.transactions, worker_address=f"127.0.0.1:{port}")
    storage = m.stores.NodeStorage(None)
    for o in outputs:  # as the runner persists them before they go out
        storage.certificate_store.write(o.certificate)
        storage.consensus_store.write_consensus_state({}, o.consensus_index,
                                                      o.certificate.digest)
    state = journal_state(m)
    state.crash_at = crash_at
    total = sum(len(b.transactions) for b in batches)
    network = m.network.NetworkClient()
    emitted, restored = [], None

    async def life(feed):
        rx, tx_out, accepted = m.channels.Channel(100), m.channels.Channel(1000), \
            m.channels.Channel(100)
        ex = m.executor.Executor(pk, f.worker_cache, storage, state, network, rx, tx_out,
                                 registry=m.metrics.Registry(), rx_accepted=accepted)
        tasks = await ex.spawn(feed)
        try:
            if not feed:
                for o in outputs:
                    await accepted.send(o.certificate)
                for o in outputs:
                    await rx.send(o)
            while len(state.seen) < total and not ex.core._task.done():
                await asyncio.sleep(0.005)
        finally:
            ex.shutdown()
            await asyncio.gather(*tasks, return_exceptions=True)
        while (item := tx_out.try_recv()) is not None:
            emitted.append(item)

    try:
        await life([])
        if crash_at is not None:
            state.crash_at = None
            restored = await m.executor.get_restored_consensus_output(
                storage.consensus_store, storage.certificate_store, state)
            await life(restored)
    finally:
        network.close()
        await srv.stop()
    return {"seen": state.seen, "emitted": emitted, "total": total,
            "restored": None if restored is None else
            [(o.certificate.digest, o.consensus_index) for o in restored]}


@pytest.mark.parametrize("crash_at", [None, 0, 5, 13])
def test_executor_matches_jax_across_a_crash(run, crash_at):
    got = {name: run(executor_run(m, 11, crash_at), timeout=60.0) for name, m in PKGS.items()}
    assert got["port"] == got["jax"]
    seen = got["port"]["seen"]
    assert len(seen) == got["port"]["total"] and len({s[2] for s in seen}) == len(seen)
    assert [r for r, _tx in got["port"]["emitted"]] == [b"r" + s[2][:4] for s in seen]
    if crash_at is not None:
        assert got["port"]["restored"]


# -- the exposition parser and the scrape snapshot ------------------------------


def registry_ops(m):
    r = m.metrics.Registry()
    c = r.counter("node_things_total", "Things counted")
    g = r.gauge("node_depth", "A depth", labels=("stage",))
    h = r.histogram("node_latency_seconds", "A latency", labels=("route",))
    h2 = r.histogram("node_rpcs_per_certificate", "RPCs a certificate", buckets=(0.0, 1.0, 4.0))
    c.inc(3)
    g.labels("commit").set(7)
    g.labels("execute").set(-2.5)
    for i, v in enumerate((0.0005, 0.02, 0.3, 2.0, 11.0)):
        h.labels("host" if i % 2 else "device").observe(v)
    for v in (0, 1, 1, 3, 9):
        h2.observe(v)
    return r


def test_parse_exposition_and_scrape_snapshot_match_jax():
    regs = {name: registry_ops(m) for name, m in PKGS.items()}
    texts = {name: r.render() for name, r in regs.items()}
    assert texts["port"] == texts["jax"]
    parsed = {name: PKGS[name].metrics.parse_exposition(text) for name, text in texts.items()}
    assert parsed["port"] == parsed["jax"]
    assert parsed["port"]["node_rpcs_per_certificate"]["samples"]["_sum"] == 14.0
    snaps = {name: PKGS[name].metrics.scrape_snapshot(r) for name, r in regs.items()}
    assert snaps["port"] == snaps["jax"]
    assert not any(k.startswith("_bucket") for e in snaps["port"].values() for k in e["samples"])
    junk = "# free text\nnot_a_number x\nnode_x{a=\"1\"} 2\n"
    assert t_metrics.parse_exposition(junk) == j_metrics.parse_exposition(junk)
