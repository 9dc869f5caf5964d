"""Fused pipeline: verify -> DAG insert -> commit, over certificate batches.

Port of `narwhal_tpu/tpu/pipeline.py` (the JAX package's counterpart): the
entry point of the port's certificate path on the card.

  feed(batch k+1)  - host packs the signature items and launches the verify
                     kernel; the card computes batch k+1's verify WHILE
                     batch k's DAG walk and readback complete (launches are
                     asynchronous, and GpuVerifier.submit starts the
                     verdicts' copy to pinned host memory at once);
  _resolve(batch k)- verdicts gathered; accepted certificates enter the
                     consensus engine (GpuBullshark) through ONE
                     `process_batch` call: one `place_batch` scatter for the
                     whole batch, the commit rule evaluated per trigger, one
                     `chain_commit` launch per commit event.

Output equivalence: the commit sequence is identical to feeding the same
certificates one at a time through `process_certificate`.

Both wire forms: a full-format certificate (`cert_format=full`) contributes
one signature item per voter to `GpuVerifier.submit`; a compact certificate
(`cert_format=compact`, the committee-wide default) contributes its
half-aggregated proof to the group lane (`submit_groups`: one A2 launch per
chunk of groups). The two halves of a batch are in flight together.
"""

from __future__ import annotations

import collections
from typing import Iterable, Sequence

from ..clock import now
from ..types import Certificate, ConsensusOutput


class FusedCertificatePipeline:
    """verify -> place_batch -> chain_commit over certificate batches.

    verifier: a GpuVerifier — its submit/collect halves are the pipeline's
    stage boundary; engine: a GpuBullshark; state: the ConsensusState the
    engine mutates. `depth` is the number of verify batches kept in flight
    (2 = double-buffered)."""

    def __init__(
        self, verifier, engine, state, start_index: int = 0, depth: int = 2,
        tracer=None,
    ):
        self.verifier = verifier
        self.engine = engine
        self.state = state
        self.consensus_index = start_index
        self.depth = max(1, depth)
        self.tracer = tracer
        self._inflight: collections.deque = collections.deque()
        self.outputs: list[ConsensusOutput] = []
        self.rejected: list[Certificate] = []

    def _span_key(self, certs: Sequence[Certificate]):
        """Device sub-spans are per-batch, keyed by the batch's first
        certificate digest (the batch has no digest of its own); the n=
        attribute records how many certificates the span covers."""
        tracer = self.tracer
        if tracer is None or not tracer.enabled or not certs:
            return None
        key = certs[0].digest
        return key if tracer.sampled(key) else None

    def feed(self, certs: Sequence[Certificate], committee=None) -> None:
        """Pack + launch one verify batch; resolves the oldest in-flight
        batch first when the pipeline is full, so at most `depth` batches
        ride the card at once. Full-format certificates launch their
        per-vote signature items; compact certificates ride the verifier's
        aggregate group lane, both halves of one batch in flight together."""
        while len(self._inflight) >= self.depth:
            self._resolve_one()
        committee = committee or self.engine.committee
        span_key = self._span_key(certs)
        # Input order preserved: ("item", cert, lo, hi) spans index into the
        # item verdicts, ("group", cert, g) into the group verdicts; an
        # empty item span or g of None marks a signature-free (genesis)
        # certificate: valid. Full-format certificates stage first, then
        # compact ones, so each branch's staging is one interval of its own.
        spans: list = [None] * len(certs)
        items: list = []
        groups: list = []
        t_pack = now()
        for i, cert in enumerate(certs):
            if not cert.is_compact:
                cert_items = cert.verify_items(committee)
                spans[i] = ("item", cert, len(items), len(items) + len(cert_items))
                items.extend(cert_items)
        t_groups = now()
        for i, cert in enumerate(certs):
            if cert.is_compact:
                group = cert.aggregate_group(committee)
                if group is None:
                    spans[i] = ("group", cert, None)
                else:
                    spans[i] = ("group", cert, len(groups))
                    groups.append(group)
        t_dispatch = now()
        handle = self.verifier.submit(items)
        ghandle = self.verifier.submit_groups(groups) if groups else None
        if span_key is not None:
            n = len(certs)
            self.tracer.span("device_pack", span_key, t_pack, t_dispatch, {"n": n})
            self.tracer.span("pack_items", span_key, t_pack, t_groups, {"n_items": len(items)})
            self.tracer.span(
                "pack_groups", span_key, t_groups, t_dispatch, {"n_groups": len(groups)}
            )
            self.tracer.span("device_dispatch", span_key, t_dispatch, now(), {"n": n})
        self._inflight.append((spans, handle, ghandle, span_key))

    def _resolve_one(self) -> None:
        spans, handle, ghandle, span_key = self._inflight.popleft()
        t_collect = now()
        self.verifier.wait(handle)
        if ghandle is not None:
            self.verifier.wait(ghandle)
        t_landed = now()
        ok = self.verifier.collect(handle)
        t_items = now()
        gok = self.verifier.collect_groups(ghandle) if ghandle is not None else []
        if span_key is not None:
            n = len(spans)
            # The device->host copies of both lanes; then each lane's host
            # epilogue: item verdicts (with the msm epilogue and a failed
            # bucket's fallback in msm mode), and the group lane's msm
            # epilogue, solo bisect and host re-checks.
            self.tracer.span("device_mask_readback", span_key, t_collect, t_landed, {"n": n})
            self.tracer.span("item_epilogue", span_key, t_landed, t_items, {"n": n})
            self.tracer.span("group_epilogue", span_key, t_items, now(), {"n": n})
        t_epilogue = now()
        accepted: list[Certificate] = []
        for span in spans:
            if span[0] == "group":
                _, cert, g = span
                passed = True if g is None else gok[g]
            else:
                _, cert, lo, hi = span
                passed = all(ok[lo:hi])
            if passed:
                accepted.append(cert)
            else:
                self.rejected.append(cert)
        t_unpack = now()
        if accepted:
            outs = self.engine.process_batch(self.state, self.consensus_index, accepted)
            self.consensus_index += len(outs)
            self.outputs.extend(outs)
        if span_key is not None:
            t_end = now()
            self.tracer.span(
                "epilogue_unpack", span_key, t_epilogue, t_unpack, {"n": len(spans)},
            )
            self.tracer.span(
                "epilogue_commit", span_key, t_unpack, t_end, {"n_accepted": len(accepted)},
            )
            self.tracer.span("host_epilogue", span_key, t_epilogue, t_end, {"n": len(spans)})

    def drain(self) -> list[ConsensusOutput]:
        """Resolve every in-flight batch and return the full committed
        sequence so far."""
        while self._inflight:
            self._resolve_one()
        return self.outputs

    def run(self, batches: Iterable[Sequence[Certificate]]) -> list[ConsensusOutput]:
        for batch in batches:
            self.feed(batch)
        return self.drain()
