"""Stage latency timers for the port.

Port copy of `StageTimer` from `narwhal_tpu/pacing.py` (the JAX package's
counterpart), with the `_now` clock it reads. The PyTorch port keeps its own
copy so that it imports nothing of `narwhal_tpu`.

Only `StageTimer` is here: `ConsensusMetrics` needs it. The rest of the JAX
module (`PacingController`, `BackpressureState`, `IngestGate`,
`backpressure_level`) comes with the host plane's pacing (ROADMAP queue 1
item 7). No tracer is ported yet either, so callers pass `tracer=None`.
"""

from __future__ import annotations

from typing import Callable

from .clock import now as _now


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
