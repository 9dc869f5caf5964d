"""Causal commit tracing and the per-node flight recorder.

Port copy of `narwhal_tpu/tracing.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

The reference debugs its pipeline with per-crate Prometheus metrics; those
aggregate. What the two diagnosis-starved problems in ROADMAP.md (the
`test_partial_committee_change` contention flake and the multi-chip
host-epilogue cap) both need is the *causal* record: where did one specific
certificate's time go, across roles and across the host/device boundary.

This module is that record, in two bounded pieces:

* **Spans** — the per-certificate waterfall. The trace context is the
  digest chain the protocol already carries on the wire (batch digest →
  header digest → certificate digest), so tracing adds ZERO wire bytes:
  `link` events recorded where the chain hops (batch digests folded into a
  proposed header, a header certified) let `waterfall()` stitch per-stage
  spans (seal / propose / certify / commit / execute, plus the device-plane
  sub-spans from gpu/pipeline.py) into one end-to-end timeline per
  certificate, joining across the dumps of every node that touched it.
  Span timestamps come from `clock.now()` — the running loop's time — so
  under simnet's virtual clock a seeded scenario produces a bit-identical
  traced event log on every run.

* **Flight recorder** — a bounded ring (`collections.deque`) of structured
  events per node: span closes, causal links, and `instant` events
  (channel-occupancy snapshots, backpressure/pacing state transitions)
  that record regardless of the trace switch because they are off the hot
  path and are exactly what a post-mortem needs. `dump()` is a
  self-contained JSON-able dict; `on_anomaly()` archives every live
  tracer's ring into a bounded module-level archive (and optionally to
  NARWHAL_FLIGHT_DIR) so commit-stall detectors, simnet oracles and the
  pytest failure hook can attach the evidence to the failure they report.

Overhead discipline: span recording on the hot path is gated by
`Tracer.enabled` (NARWHAL_TRACE, default off) — when disabled the only cost
at an instrumented site is one attribute read and a falsy branch. When
enabled, `sampled(key)` decides deterministically from the digest bytes
(NARWHAL_TRACE_SAMPLE in (0,1]), so a sampled run traces the SAME
certificates on every node — partial waterfalls never happen — and a
seeded simnet replay samples identically.
"""

from __future__ import annotations

import collections
import json
import os
import weakref

from .clock import now as _now

# Ordered ring of recently archived dumps (nodes that shut down, anomaly
# snapshots): bounded so a long test session cannot grow without limit.
ARCHIVE: collections.deque = collections.deque(maxlen=64)

# Every constructed tracer, weakly — the dump surface for "all hosted
# nodes" consumers (conftest failure hook, anomaly triggers) without tying
# tracer lifetime to this module.
_LIVE: "weakref.WeakSet[Tracer]" = weakref.WeakSet()

# Cluster-incarnation generation: successive in-process clusters reuse
# node labels AND certificate digests (seeded fixtures), so a live-tracer
# dump that mixed incarnations would stitch spans from a PRIOR cluster
# into the current one (the diagnosed test_live_cluster_scrape flake).
# Each tracer records the generation current at its construction;
# `live_dumps`/`on_anomaly` only touch the current generation. Cluster
# boot bumps this via `new_generation()`.
_GENERATION: int = 0


def new_generation() -> int:
    """Start a new tracer incarnation; previously constructed tracers
    become invisible to `live_dumps`/`on_anomaly` (their rings stay
    reachable through direct references and the archive)."""
    global _GENERATION
    _GENERATION += 1
    return _GENERATION


def _env_flag(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default) not in ("", "0", "false", "no")


class Tracer:
    """One node's span recorder + flight ring.

    `enabled`/`sample`/`ring` default from the environment at construction
    (NARWHAL_TRACE, NARWHAL_TRACE_SAMPLE, NARWHAL_FLIGHT_RING) so a whole
    in-process committee flips together without plumbing flags through
    every constructor.

    Concurrency discipline: many tasks append to `events` (every stage
    timer close, every instant), and the live-dump RPC handler reads it
    concurrently — the ring is safe because appends are single-statement
    (atomic under cooperative scheduling: no await between deciding to
    record and recording) and every reader snapshots copy-on-read
    (`dump()` does `list(self.events)` and serializes BEFORE its caller's
    next yield point). Do not hold a live reference to `events` across an
    await. Span ordering sanity (one window per key per stage, so the
    waterfall's earliest-t0 pick cannot land on a late re-opened window
    after ring eviction) is the stage timers' job: see
    pacing.StageTimer's closed-key latch."""

    __slots__ = ("node", "enabled", "events", "anomalies", "_threshold",
                 "generation", "__weakref__")

    def __init__(
        self,
        node: str = "",
        enabled: bool | None = None,
        sample: float | None = None,
        ring: int | None = None,
    ):
        self.node = node
        self.enabled = (
            _env_flag("NARWHAL_TRACE") if enabled is None else enabled
        )
        if sample is None:
            sample = float(os.environ.get("NARWHAL_TRACE_SAMPLE", "1.0"))
        # Deterministic digest-based sampling: a key is traced iff its
        # first 4 bytes, read big-endian, fall under sample * 2^32. Every
        # node makes the same decision for the same digest.
        self._threshold = int(max(0.0, min(1.0, sample)) * 0x1_0000_0000)
        if ring is None:
            ring = int(os.environ.get("NARWHAL_FLIGHT_RING", "4096"))
        self.events: collections.deque = collections.deque(maxlen=max(16, ring))
        self.anomalies: list[str] = []
        self.generation = _GENERATION
        _LIVE.add(self)

    # -- hot path ----------------------------------------------------------

    def sampled(self, key: bytes) -> bool:
        """Deterministic per-digest sampling decision (callers gate on
        `enabled` first; this never reads the clock or the environment)."""
        if self._threshold >= 0x1_0000_0000:
            return True
        return int.from_bytes(key[:4], "big") < self._threshold

    def span(self, stage: str, key: bytes, t0: float, t1: float, attrs=None):
        """One closed span: stage `stage` of causal key `key` ran [t0, t1].
        Appended at CLOSE time only — an open span costs nothing but its
        caller-held t0."""
        self.events.append(("span", stage, key.hex(), t0, t1, attrs))

    def link(self, stage: str, parent: bytes, child: bytes) -> None:
        """The causal key hops: `parent`'s journey continues under `child`
        (batch digest -> header digest at propose, header digest ->
        certificate digest at certify)."""
        self.events.append(("link", stage, parent.hex(), child.hex()))

    # -- flight recorder (off the hot path; always records) ----------------

    def instant(self, kind: str, **attrs) -> None:
        """A point-in-time flight event: occupancy snapshot, backpressure
        level transition, pacing mode change, anomaly marker."""
        self.events.append(("instant", kind, _now(), attrs or None))

    def anomaly(self, reason: str, **attrs) -> None:
        """Record an anomaly marker and archive this tracer's ring."""
        self.anomalies.append(reason)
        self.instant("anomaly", reason=reason, **attrs)
        _archive(self.dump())

    # -- dump surface ------------------------------------------------------

    def dump(self, max_events: int | None = None) -> dict:
        """Self-contained, JSON-able snapshot of the ring."""
        events = list(self.events)
        if max_events is not None and max_events > 0:
            events = events[-max_events:]
        return {
            "node": self.node,
            "trace_enabled": self.enabled,
            "ring_capacity": self.events.maxlen,
            "anomalies": list(self.anomalies),
            "events": events,
        }

    def archive(self) -> None:
        """Push this tracer's dump into the module archive (node shutdown:
        the ring must outlive the node for post-teardown diagnosis)."""
        if self.events or self.anomalies:
            _archive(self.dump())


def _archive(dump: dict) -> None:
    ARCHIVE.append(dump)
    out_dir = os.environ.get("NARWHAL_FLIGHT_DIR", "")
    if out_dir:
        try:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(
                out_dir, f"flight-{dump.get('node') or 'node'}-{len(ARCHIVE)}.json"
            )
            with open(path, "w") as f:
                json.dump(dump, f, sort_keys=True)
        except OSError:
            pass  # diagnosis must never take the node down


def live_dumps(max_events: int | None = None) -> list[dict]:
    """Dump every live tracer of the CURRENT cluster incarnation (all
    hosted nodes of an in-process committee), stable-ordered by node
    label. Tracers from a prior incarnation are excluded even while still
    referenced — their spans describe a different cluster's history."""
    return sorted(
        (
            t.dump(max_events)
            for t in _LIVE
            if t.generation == _GENERATION
        ),
        key=lambda d: d["node"],
    )


def all_dumps(max_events: int | None = None) -> list[dict]:
    """Live rings plus the bounded archive of already-torn-down nodes."""
    return list(ARCHIVE) + live_dumps(max_events)


def on_anomaly(reason: str) -> list[dict]:
    """Dump-on-anomaly trigger: snapshot every live ring into the archive,
    tagged with the reason, and return the dumps (what an oracle or a
    commit-stall detector attaches to its report)."""
    dumps = []
    for t in list(_LIVE):
        if t.generation != _GENERATION:
            continue
        t.anomalies.append(reason)
        dumps.append(t.dump())
    for d in dumps:
        d = dict(d)
        d["anomaly"] = reason
        _archive(d)
    return dumps


def clear_archive() -> None:
    ARCHIVE.clear()


# -- waterfall reconstruction ----------------------------------------------


def waterfall(dumps: list[dict]) -> dict[str, dict]:
    """Stitch span + link events from any number of node dumps into
    per-certificate waterfalls.

    Returns {certificate_digest_hex: {"stages": {stage: [t0, t1]}, ...}}
    where the stages of batches folded into the certificate's header (seal,
    propose, and the device sub-spans) are re-keyed under the certificate
    via the recorded link chain. Each stage keeps the earliest-opening span
    observed for that key across all dumps."""
    spans: dict[str, dict[str, tuple[float, float]]] = {}
    parent_of: dict[str, list[str]] = {}  # child key -> parent keys
    for d in dumps:
        for ev in d.get("events", ()):
            # Dumps arrive over RPC from possibly-older nodes: skip any
            # event too short for its kind instead of raising mid-stitch.
            if ev[0] == "span" and len(ev) >= 5:
                _, stage, key, t0, t1 = ev[:5]
                best = spans.setdefault(key, {})
                if stage not in best or t0 < best[stage][0]:
                    best[stage] = (t0, t1)
            elif ev[0] == "link" and len(ev) >= 4:
                _, _stage, parent, child = ev[:4]
                if parent != child:  # a self-link stitches nothing
                    parent_of.setdefault(child, []).append(parent)

    def ancestors(key: str, seen: set[str]) -> list[str]:
        # Iterative DFS with a seen-set: a cyclic link chain (two nodes
        # disagreeing about direction) or an arbitrarily deep one (ring
        # overflow splitting chains) degrades to a partial lineage instead
        # of looping or blowing the stack.
        out: list[str] = []
        stack = list(parent_of.get(key, ()))
        while stack:
            p = stack.pop(0)
            if p in seen:
                continue
            seen.add(p)
            out.append(p)
            stack[:0] = parent_of.get(p, ())
        return out

    # Roots = keys that are nobody's parent (certificate digests) OR keys
    # with a terminal stage recorded. Commit/execute close on the
    # certificate digest, so any key carrying those stages is a root.
    children = {p for ps in parent_of.values() for p in ps}
    out: dict[str, dict] = {}
    for key, stages in spans.items():
        terminal = "commit" in stages or "execute" in stages
        if key in children and not terminal:
            continue
        merged = dict(stages)
        lineage = ancestors(key, {key})
        for a in lineage:
            for stage, window in spans.get(a, {}).items():
                if stage not in merged or window[0] < merged[stage][0]:
                    merged[stage] = window
        out[key] = {
            "stages": {s: [t0, t1] for s, (t0, t1) in sorted(merged.items())},
            "ancestors": lineage,
        }
    return out


def stage_percentiles(dumps: list[dict]) -> dict[str, dict]:
    """Per-stage duration p50/p95 over every span in the dumps — the
    `--trace-waterfall` artifact's summary table."""
    by_stage: dict[str, list[float]] = {}
    for d in dumps:
        for ev in d.get("events", ()):
            if ev[0] == "span":
                by_stage.setdefault(ev[1], []).append(ev[4] - ev[3])
    out = {}
    for stage, samples in sorted(by_stage.items()):
        samples.sort()
        n = len(samples)
        out[stage] = {
            "count": n,
            "p50_ms": round(samples[n // 2] * 1000, 3),
            "p95_ms": round(samples[min(n - 1, int(0.95 * n))] * 1000, 3),
            "max_ms": round(samples[-1] * 1000, 3),
        }
    return out
