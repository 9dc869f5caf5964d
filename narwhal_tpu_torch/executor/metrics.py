"""Executor progress counters surfaced on the node registry.

Port copy of `narwhal_tpu/executor/metrics.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

The reference's executor/src/metrics.rs carries only channel-depth gauges
(covered here by the node's metered channels); these applied-work counters
and the commit-to-execution data-plane instruments (prefetch hit rate,
fetch RPCs per certificate, payload bytes fetched, commit->exec latency)
are repo-specific additions for operator dashboards and tests."""

from __future__ import annotations

from ..metrics import Registry

# Fetch RPCs issued per committed certificate: the coalesced data plane
# targets <= one per (worker, certificate) group, so the interesting
# resolution is small integer counts, not the latency-shaped defaults.
_RPC_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


class ExecutorMetrics:
    def __init__(self, registry: Registry, tracer=None):
        self.tracer = tracer
        self.executed_transactions = registry.counter(
            "executor_executed_transactions",
            "Transactions applied to the execution state",
        )
        self.executed_certificates = registry.counter(
            "executor_executed_certificates",
            "Certificates whose payload finished executing",
        )
        # -- commit-to-execution data plane --------------------------------
        self.prefetch_hits = registry.counter(
            "executor_prefetch_hits",
            "Committed batch digests already resident in the temp batch "
            "store at staging time (payload RTT off the critical path)",
        )
        self.prefetch_misses = registry.counter(
            "executor_prefetch_misses",
            "Committed batch digests that needed a worker fetch at staging",
        )
        self.prefetched_batches = registry.counter(
            "executor_prefetched_batches",
            "Batches speculatively warmed by the prefetcher before commit",
        )
        self.prefetch_resident_bytes = registry.gauge(
            "executor_prefetch_resident_bytes",
            "Bytes of unclaimed speculative payload held against the budget",
        )
        self.prefetch_evicted = registry.counter(
            "executor_prefetch_evicted",
            "Speculative payloads dropped by budget eviction or gc_depth GC",
        )
        self.fetch_rpcs_per_certificate = registry.histogram(
            "executor_fetch_rpcs_per_certificate",
            "Worker fetch RPCs issued to stage one committed certificate",
            buckets=_RPC_BUCKETS,
        )
        self.bytes_fetched = registry.counter(
            "executor_bytes_fetched",
            "Serialized payload bytes pulled from workers at staging time",
        )
        self.commit_to_exec_latency = registry.histogram(
            "executor_commit_to_exec_latency_seconds",
            "Consensus emitting an ordered certificate -> its payload fully "
            "applied to the execution state",
        )
        # Same quantity under the uniform *_stage_latency_seconds family so
        # the whole pipeline (seal -> propose -> certify -> commit ->
        # execute) reads as one labeled histogram set across roles.
        self.stage_latency = registry.histogram(
            "executor_stage_latency_seconds",
            "Per-stage pipeline latency in the executor (stage=execute: "
            "ordered certificate emitted -> payload fully applied)",
            labels=("stage",),
        )
        # Span-unified close site for the execute stage, keyed by the
        # committed certificate digest (the waterfall's terminal edge).
        from ..pacing import StageTimer

        self.execute_timer = StageTimer(
            self.stage_latency, "execute", tracer=tracer
        )
