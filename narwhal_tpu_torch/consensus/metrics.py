"""Consensus metrics (narwhal/consensus/src/metrics.rs:13-49).

Port copy of `narwhal_tpu/consensus/metrics.py` (the JAX package's
counterpart). The PyTorch port keeps its own copy so that it imports
nothing of `narwhal_tpu`.
"""

from __future__ import annotations

from ..metrics import Registry
from ..pacing import StageTimer


class ConsensusMetrics:
    def __init__(self, registry: Registry, tracer=None):
        self.tracer = tracer
        # -- stage tracing --------------------------------------------------
        self.stage_latency = registry.histogram(
            "consensus_stage_latency_seconds",
            "Per-stage pipeline latency in consensus (stage=commit: "
            "certificate accepted by the ordering engine -> sequenced in a "
            "committed leader's causal history)",
            labels=("stage",),
        )
        # Bounded: certificates that never commit (GC'd past the window)
        # age out of the pending map instead of leaking.
        self.commit_timer = StageTimer(self.stage_latency, "commit", tracer=tracer)
        self.last_committed_round = registry.gauge(
            "consensus_last_committed_round", "The last committed leader round"
        )
        self.committed_certificates = registry.counter(
            "consensus_committed_certificates", "Certificates sequenced by consensus"
        )
        self.consensus_dag_size = registry.gauge(
            "consensus_dag_size", "Certificates resident in the consensus DAG"
        )
        self.recovered_consensus_state = registry.counter(
            "consensus_recovered_consensus_state",
            "Times the consensus state was rebuilt from the store at startup",
        )
        # External Dag service read path (consensus/dag.py): per-route
        # service latency, the router's live per-request EWMA, and the size
        # of the most recent fused device dispatch (how many concurrent
        # readers shared one reach_mask round trip).
        self.dag_read_latency = registry.histogram(
            "consensus_dag_read_causal_latency_seconds",
            "read_causal service time by route (host BFS vs device reach_mask)",
            labels=("route",),
        )
        self.dag_read_route_ewma_ms = registry.gauge(
            "consensus_dag_read_route_ewma_ms",
            "EWMA per-request read_causal service time by route, milliseconds",
            labels=("route",),
        )
        self.dag_read_coalesced_batch = registry.gauge(
            "consensus_dag_read_coalesced_batch_size",
            "Requests served by the most recent fused device read_causal dispatch",
        )
        # Accepted-certificate tap feeding the executor's speculative
        # payload prefetcher (runner.py): the tap is strictly non-blocking,
        # so drops here mean the prefetcher is falling behind acceptance —
        # commits then pay their payload RTT at stage time again.
        self.accepted_tap_dropped = registry.counter(
            "consensus_accepted_tap_dropped",
            "Accepted certificates dropped from the full prefetch tap "
            "channel (speculation hint lost, never blocks ordering)",
        )
