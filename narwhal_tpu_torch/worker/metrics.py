"""Worker metrics (narwhal/worker/src/metrics.rs).

Port copy of `narwhal_tpu/worker/metrics.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.
"""

from __future__ import annotations

from ..metrics import Registry
from ..pacing import StageTimer


class WorkerMetrics:
    def __init__(self, registry: Registry, tracer=None):
        self.tracer = tracer
        # -- pacing / admission control / stage tracing --------------------
        self.stage_latency = registry.histogram(
            "worker_stage_latency_seconds",
            "Per-stage pipeline latency on the worker (stage=seal: first "
            "pending transaction chunk -> batch sealed)",
            labels=("stage",),
        )
        # Span-unified close site for the seal stage: the batch digest (the
        # waterfall's root causal key) exists only once the batch seals, so
        # the batch maker calls seal_timer.close(digest, t0) directly.
        self.seal_timer = StageTimer(self.stage_latency, "seal", tracer=tracer)
        self.effective_batch_delay = registry.gauge(
            "worker_effective_batch_delay_seconds",
            "The adaptive seal delay currently in force (floor when queues "
            "are shallow, max_batch_delay under load)",
        )
        self.pacing_occupancy = registry.gauge(
            "worker_pacing_occupancy",
            "EWMA queue occupancy the batch-maker pacing controller reads",
        )
        self.backpressure_level = registry.gauge(
            "worker_backpressure_level",
            "Downstream backlog level last pushed by our primary (0-1; "
            "stale values fail open to 0)",
        )
        self.ingest_shed = registry.counter(
            "worker_ingest_shed",
            "Client submissions answered RESOURCE_EXHAUSTED by admission "
            "control instead of queueing unboundedly",
        )
        self.ingest_blocked_seconds = registry.histogram(
            "worker_ingest_blocked_seconds",
            "Time client submissions were held at the gate under the "
            "'block' ingest policy before admission",
        )
        self.created_batch_size = registry.histogram(
            "worker_created_batch_size", "Size in bytes of sealed batches",
            buckets=(1_000, 10_000, 50_000, 100_000, 250_000, 500_000, 1_000_000),
        )
        self.batches_made = registry.counter(
            "worker_batches_made", "Batches sealed by the batch maker"
        )
        self.batches_received = registry.counter(
            "worker_batches_received", "Batches received from peer workers"
        )
        self.pending_sync_batches = registry.gauge(
            "worker_pending_sync_batches", "Batches the synchronizer is awaiting"
        )
        self.tx_received = registry.counter(
            "worker_tx_received", "Transactions received from clients"
        )
