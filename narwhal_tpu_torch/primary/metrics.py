"""Primary metrics (narwhal/primary/src/metrics.rs:51-485).

Port copy of `narwhal_tpu/primary/metrics.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.
"""

from __future__ import annotations

from ..metrics import Registry
from ..pacing import StageTimer


class PrimaryMetrics:
    def __init__(self, registry: Registry, tracer=None):
        # The node's tracing.Tracer rides with the metrics object: every
        # actor already holds the metrics, so the span/link sites need no
        # extra plumbing.
        self.tracer = tracer
        # -- pacing / stage tracing ----------------------------------------
        self.stage_latency = registry.histogram(
            "primary_stage_latency_seconds",
            "Per-stage pipeline latency on the primary (stage=propose: "
            "batch digest arrival -> included in a proposed header; "
            "stage=certify: own header proposed -> certificate assembled)",
            labels=("stage",),
        )
        # Shared timers: the proposer starts them, the proposer (propose)
        # or the core (certify) stops them. Bounded maps — headers that
        # never certify and digests dropped on epoch reset age out.
        self.propose_timer = StageTimer(self.stage_latency, "propose", tracer=tracer)
        self.certify_timer = StageTimer(self.stage_latency, "certify", tracer=tracer)
        self.effective_header_delay = registry.gauge(
            "primary_effective_header_delay_seconds",
            "The adaptive header delay currently in force (floor when "
            "queues are shallow, max_header_delay under load)",
        )
        self.pacing_occupancy = registry.gauge(
            "primary_pacing_occupancy",
            "EWMA queue occupancy the proposer pacing controller reads",
        )
        self.headers_processed = registry.counter(
            "primary_headers_processed", "Headers accepted by the core"
        )
        self.headers_suspended = registry.counter(
            "primary_headers_suspended", "Headers parked awaiting parents/payload"
        )
        self.votes_processed = registry.counter(
            "primary_votes_processed", "Votes aggregated by the core"
        )
        self.certificates_processed = registry.counter(
            "primary_certificates_processed", "Certificates accepted by the core"
        )
        self.certificates_created = registry.counter(
            "primary_certificates_created", "Certificates assembled from our own headers"
        )
        self.certificates_suspended = registry.counter(
            "primary_certificates_suspended", "Certificates parked awaiting ancestors"
        )
        self.current_round = registry.gauge(
            "primary_current_round", "The proposer's current round"
        )
        self.proposed_headers = registry.counter(
            "primary_proposed_headers", "Headers proposed by this authority"
        )
        self.gc_round = registry.gauge(
            "primary_gc_round", "Last garbage-collected consensus round"
        )
        self.pending_header_waits = registry.gauge(
            "primary_pending_header_waits", "Headers pending in the header waiter"
        )
        self.pending_certificate_waits = registry.gauge(
            "primary_pending_certificate_waits",
            "Certificates pending in the certificate waiter",
        )
        self.sync_batch_requests = registry.counter(
            "primary_sync_batch_requests", "Synchronize commands sent to own workers"
        )
        self.sync_parent_requests = registry.counter(
            "primary_sync_parent_requests", "Parent-certificate fetches sent to peers"
        )
        self.votes_sent = registry.counter(
            "primary_votes_sent", "Votes sent to header authors"
        )
        self.core_burst = registry.histogram(
            "primary_core_burst_size",
            "messages the core drained per select iteration (greedy "
            "bounded burst; >1 means one grouped commit served several)",
            buckets=(1, 2, 4, 8, 16, 32, 64),
        )
        # -- payload-plane wire diet (fanout tree + delta headers) ---------
        self.round_egress_bytes = registry.gauge(
            "primary_round_egress_bytes",
            "Bytes this primary wrote to the wire between its two most "
            "recent own headers (MB/round from metrics, not log scraping)",
        )
        self.relay_broadcasts = registry.counter(
            "primary_relay_broadcasts",
            "Own announcements disseminated through the fanout tree "
            "instead of all-to-all",
        )
        self.relays_forwarded = registry.counter(
            "primary_relays_forwarded",
            "Relay envelopes forwarded to our children in a peer's tree",
        )
        self.relay_acks_received = registry.counter(
            "primary_relay_acks_received",
            "Receipt confirmations for our own fanout broadcasts",
        )
        self.relay_fallback_sends = registry.counter(
            "primary_relay_fallback_sends",
            "Direct reliable sends to peers un-acked past "
            "relay_fallback_timeout (the crashed-relay recovery path)",
        )
        self.delta_headers_rebuilt = registry.counter(
            "primary_delta_headers_rebuilt",
            "Delta header announcements reconstructed from the local "
            "recent-certificate index (no resync round trip)",
        )
        self.delta_resyncs = registry.counter(
            "primary_delta_resyncs",
            "Full-map resync requests sent because a delta header would "
            "not reconstruct (missing parent certificate or digest "
            "mismatch)",
        )
