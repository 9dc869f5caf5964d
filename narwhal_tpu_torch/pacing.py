"""Adaptive pacing + end-to-end admission control — latency as a controlled
quantity.

Port copy of `narwhal_tpu/pacing.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Bullshark commits a leader every 2 DAG rounds, so the protocol floor at the
default delays is a few hundred ms — yet the JAX package measured an e2e
p50 of tens of seconds under load. The whole gap is queueing: fixed seal/propose timers waste the
idle capacity (a lone transaction waits the full `max_batch_delay` +
`max_header_delay` even when every queue is empty), and unbounded ingest lets
backlog grow without limit once offered load exceeds capacity. This module
holds the three pieces that close it:

* `PacingController` — one shared controller drives the effective seal delay
  (worker/batch_maker.py) and header delay (primary/proposer.py): near the
  configured floor when the channel-depth EWMA says queues are shallow
  (latency mode), climbing monotonically toward the configured ceiling as
  occupancy rises (throughput mode — bigger batches amortize the per-seal
  crypto/broadcast cost exactly when the system needs throughput).

* `BackpressureState` + `IngestGate` — the end-to-end admission-control
  signal: the primary samples its executor/consensus backlog and pushes the
  level to its own workers (messages.BackpressureMsg); the worker's
  client-facing ingest consults the gate and, past the high watermark,
  either sheds with an explicit RESOURCE_EXHAUSTED or blocks the submitter —
  overload degrades to bounded latency instead of unbounded backlog.

* `StageTimer` — bounded id→t0 maps feeding the `*_stage_latency_seconds`
  histograms, so a committed transaction's journey (ingest → seal → propose
  → certify → commit → execute) is decomposable per stage instead of one
  opaque end-to-end number.

Everything here is plain event-loop Python — no locks, no tasks of its own;
the owning actors call in from their existing select loops.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Iterable

from .clock import now as _now

# The string the wire carries when ingest sheds: typed-RPC clients see it as
# the RpcError text of the ERR frame, gRPC clients as the status detail of
# StatusCode.RESOURCE_EXHAUSTED. Clients match on the prefix.
RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"


class IngestOverloadError(Exception):
    """Raised by IngestGate.admit() under the shed policy: the caller must
    surface it to the client verbatim (the RPC server turns handler
    exceptions into ERR frames, so the prefix travels the wire as-is)."""

    def __init__(self, detail: str):
        super().__init__(f"{RESOURCE_EXHAUSTED}: {detail}")


def _clamp01(v: float) -> float:
    return 0.0 if v < 0.0 else (1.0 if v > 1.0 else v)


class PacingController:
    """Maps queue occupancy to an effective delay in [floor, ceiling].

    `sources` are zero-argument callables returning occupancy in [0, 1]
    (Channel.occupancy bound methods are the intended substrate). Each
    `delay()` call samples every source, folds the max into an EWMA, and
    interpolates:

        occupancy <= low   -> floor    (latency mode: seal/propose asap)
        occupancy >= high  -> ceiling  (throughput mode: configured delay)
        in between         -> linear, so the response is monotone

    The EWMA (not the instantaneous max) is what interpolation reads:
    occupancy at these channels is sawtoothed by burst drains, and pacing on
    the raw value would oscillate between modes within one burst.
    """

    def __init__(
        self,
        ceiling: float,
        floor: float = 0.005,
        low_occupancy: float = 0.05,
        high_occupancy: float = 0.5,
        ewma_alpha: float = 0.2,
        sources: Iterable[Callable[[], float]] = (),
        gauge=None,  # optional Gauge: the EWMA occupancy, for dashboards
    ):
        if ceiling <= floor:
            # A ceiling at/under the floor means the operator asked for a
            # delay smaller than the adaptive floor: honor it verbatim.
            floor = ceiling
        if high_occupancy <= low_occupancy:
            high_occupancy = low_occupancy + 1e-6
        self.ceiling = ceiling
        self.floor = floor
        self.low = low_occupancy
        self.high = high_occupancy
        self.alpha = ewma_alpha
        self._sources: list[Callable[[], float]] = list(sources)
        self._gauge = gauge
        self._ewma = 0.0

    def add_source(self, source: Callable[[], float]) -> None:
        self._sources.append(source)

    def observe(self, sample: float | None = None) -> float:
        """Fold one occupancy sample (default: max over the sources) into
        the EWMA and return the new EWMA."""
        if sample is None:
            sample = max((_clamp01(s()) for s in self._sources), default=0.0)
        else:
            sample = _clamp01(sample)
        self._ewma += self.alpha * (sample - self._ewma)
        if self._gauge is not None:
            self._gauge.set(self._ewma)
        return self._ewma

    def delay(self) -> float:
        """The effective seal/propose delay for the current occupancy."""
        occ = self.observe()
        if occ <= self.low:
            return self.floor
        if occ >= self.high:
            return self.ceiling
        frac = (occ - self.low) / (self.high - self.low)
        return self.floor + (self.ceiling - self.floor) * frac


class BackpressureState:
    """The downstream-backlog level a worker hears from its primary.

    `update(level)` is called by the BackpressureMsg handler; `level()` is
    what the IngestGate folds into its admission decision. Two safeguards:

    * hysteresis — `overloaded()` trips at >= high and releases only at
      <= low, so a level hovering at the watermark doesn't flap admission
      per request;
    * staleness fail-open — a level older than `stale_after` seconds reads
      as 0.0: if the primary dies (or the push path breaks), the worker
      must not shed client traffic forever on a stale signal.
    """

    def __init__(
        self,
        high: float = 0.75,
        low: float = 0.5,
        stale_after: float = 2.0,
        gauge=None,
        clock: Callable[[], float] = _now,
    ):
        self.high = high
        self.low = max(0.0, min(low, high))
        self.stale_after = stale_after
        self._gauge = gauge
        self._clock = clock
        self._level = 0.0
        self._updated_at = clock() - stale_after  # born stale: fail open
        self._overloaded = False

    def update(self, level: float) -> None:
        self._level = _clamp01(level)
        self._updated_at = self._clock()
        if self._gauge is not None:
            self._gauge.set(self._level)

    def level(self) -> float:
        if self._clock() - self._updated_at > self.stale_after:
            return 0.0
        return self._level

    def overloaded(self) -> bool:
        lvl = self.level()
        if self._overloaded:
            if lvl <= self.low:
                self._overloaded = False
        elif lvl >= self.high:
            self._overloaded = True
        return self._overloaded


class IngestGate:
    """Admission control at the worker's client-facing ingest.

    The admission level is the max of the local ingest-queue occupancy
    (`local_sources`, usually the batch-maker channel) and the downstream
    level pushed by the primary (`downstream`). Hysteresis mirrors
    BackpressureState: the gate trips at >= high and re-admits at <= low.

    Policies (Parameters.ingest_policy / NARWHAL_INGEST_POLICY):
      shed  — `admit()` raises IngestOverloadError (RESOURCE_EXHAUSTED on
              the wire) immediately; the client decides whether to retry.
      block — `admit()` waits (bounded by `block_timeout`) for the level to
              fall below the low watermark, exerting TCP-level backpressure
              through the connection's dispatch semaphore; on timeout it
              sheds anyway, so latency stays bounded under either policy.
      off   — every submission admits (the seed behavior: unbounded queue).
    """

    POLICIES = ("shed", "block", "off")

    def __init__(
        self,
        policy: str = "shed",
        local_sources: Iterable[Callable[[], float]] = (),
        downstream: BackpressureState | None = None,
        high: float = 0.75,
        low: float = 0.5,
        block_timeout: float = 5.0,
        block_poll: float = 0.02,
        metrics=None,  # WorkerMetrics (ingest_shed / ingest_blocked_seconds)
    ):
        if policy not in self.POLICIES:
            raise ValueError(
                f"ingest policy must be one of {self.POLICIES}, got {policy!r}"
            )
        self.policy = policy
        self.local_sources = list(local_sources)
        self.downstream = downstream
        self.high = high
        self.low = max(0.0, min(low, high))
        self.block_timeout = block_timeout
        self.block_poll = block_poll
        self.metrics = metrics
        self._overloaded = False

    def level(self) -> float:
        lvl = max((_clamp01(s()) for s in self.local_sources), default=0.0)
        if self.downstream is not None:
            lvl = max(lvl, self.downstream.level())
        return lvl

    def admits(self) -> bool:
        """One hysteresis-filtered admission decision (no policy applied)."""
        lvl = self.level()
        if self._overloaded:
            if lvl <= self.low:
                self._overloaded = False
        elif lvl >= self.high:
            self._overloaded = True
        return not self._overloaded

    async def admit(self) -> None:
        """Gate one client submission according to the policy."""
        if self.policy == "off" or self.admits():
            return
        if self.policy == "block":
            t0 = _now()
            deadline = t0 + self.block_timeout
            while _now() < deadline:
                await asyncio.sleep(self.block_poll)
                if self.admits():
                    if self.metrics is not None:
                        self.metrics.ingest_blocked_seconds.observe(
                            _now() - t0
                        )
                    return
            # Fall through: blocking past the timeout would just move the
            # unbounded queue into the RPC layer — shed instead.
        if self.metrics is not None:
            self.metrics.ingest_shed.inc()
        raise IngestOverloadError(
            f"ingest overloaded (level {self.level():.2f} >= {self.high}); "
            "retry later or lower the offered rate"
        )


class StageTimer:
    """One pipeline stage's latency: `start(key)` stamps, `stop(key)`
    closes the span and observes its duration into the stage's histogram
    child. The pending map is bounded — keys that never stop (certificates
    that never commit, headers GC'd mid-flight) are evicted oldest-first
    instead of leaking.

    The timer is ALSO the span layer's close site (tracing.Tracer): a
    single `close()` both emits the causal span (when tracing is enabled
    and the key samples in) and observes the histogram, so the stage
    histograms are derived from span closes by construction — no double
    bookkeeping, and the equivalence is pinned by test.

    One span window per key: once a key closes, a later `start()` for the
    same key is a no-op (bounded recently-closed latch). Without this, a
    straggler re-propose/re-deliver after the stage already closed mints
    a SECOND, later span for the same key — and if the first span has
    been evicted from the trace ring, the waterfall's earliest-t0 rule
    picks the bogus window, producing causality inversions (a certify
    span that "starts" after its own commit)."""

    def __init__(
        self,
        histogram,  # metrics.Histogram with a ("stage",) label
        stage: str,
        max_pending: int = 8192,
        clock: Callable[[], float] = _now,
        ewma_alpha: float = 0.2,
        tracer=None,  # tracing.Tracer: span sink for this stage's closes
        max_closed: int = 4096,
    ):
        self._child = histogram.labels(stage)
        self._stage = stage
        self._max = max_pending
        self._clock = clock
        self._pending: dict = {}
        self._closed: dict = {}  # insertion-ordered set of closed keys
        self._max_closed = max_closed
        self._tracer = tracer
        # Recent-latency EWMA alongside the histogram: the histogram's
        # sum/count is a lifetime mean, useless as a control signal — the
        # backpressure monitor reads this instead (None until first stop).
        self.ewma: float | None = None
        self._alpha = ewma_alpha

    def start(self, key) -> None:
        pending = self._pending
        if key in pending:
            return  # first sighting wins; re-delivery must not reset t0
        if key in self._closed:
            return  # one span window per key; no re-open after close
        while len(pending) >= self._max:
            pending.pop(next(iter(pending)))
        pending[key] = self._clock()

    def stop(self, key) -> float | None:
        t0 = self._pending.pop(key, None)
        if t0 is None:
            return None
        return self.close(key, t0)

    def _latch_closed(self, key) -> None:
        closed = self._closed
        if key in closed:
            return
        while len(closed) >= self._max_closed:
            closed.pop(next(iter(closed)))
        closed[key] = None

    def close(self, key, t0: float) -> float:
        """Close the stage span opened at t0 for `key`: emit the trace span
        and derive the histogram observation from the same close. Callers
        that learn the key only at the end of the stage (batch seal: the
        digest exists once the batch is sealed) call this directly."""
        self._latch_closed(key)
        t1 = self._clock()
        tracer = self._tracer
        if (
            tracer is not None
            and tracer.enabled
            and isinstance(key, bytes)
            and tracer.sampled(key)
        ):
            tracer.span(self._stage, key, t0, t1)
        self.observe(t1 - t0)
        return t1 - t0

    def observe(self, seconds: float) -> None:
        """Directly record a latency measured elsewhere (same histogram)."""
        self._child.observe(seconds)
        self.ewma = (
            seconds
            if self.ewma is None
            else self.ewma + self._alpha * (seconds - self.ewma)
        )


def backpressure_level(
    occupancies: Iterable[float],
    commit_latency_ewma: float | None,
    seconds_since_commit: float | None,
    latency_target: float,
    high_watermark: float,
) -> float:
    """The admission level a primary pushes to its workers, folding three
    overload signals (the JAX package's overload measurements showed why
    depth alone is blind):

    * channel occupancy — catches a *deep* queue (executor lagging
      consensus, a slow app state machine);
    * commit-stage latency vs target — catches *service-time* saturation,
      where rounds take seconds but every channel stays shallow because
      items are huge aggregates (batches, certificates). Scaled so the
      EWMA hitting the target lands exactly on the high watermark;
    * commit stall — under collapse the committee stops committing
      entirely, so there is no fresh EWMA to read: no commit for longer
      than the target pins the level at 1.0 until progress resumes.
    """
    level = max((_clamp01(o) for o in occupancies), default=0.0)
    if latency_target > 0:
        if commit_latency_ewma is not None:
            level = max(
                level, _clamp01(high_watermark * commit_latency_ewma / latency_target)
            )
        if seconds_since_commit is not None and seconds_since_commit > latency_target:
            level = 1.0
    return level
