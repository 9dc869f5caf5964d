"""The Helper: serves peers' certificate / payload-availability queries.

Port copy of `narwhal_tpu/primary/helper.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/helper.rs:32-261. In the reference the
helper is an actor replying with loose messages; our RPC layer supports typed
request/response, so these are direct handlers mounted by the primary's RPC
server — same capability, one less hop.
"""

from __future__ import annotations

import logging

from ..config import Committee
from ..messages import (
    CertificatesBatchRequest,
    CertificatesBatchResponse,
    CertificatesRangeRequest,
    CertificatesRangeResponse,
    PayloadAvailabilityRequest,
    PayloadAvailabilityResponse,
)
from ..stores import CertificateStore, PayloadStore

logger = logging.getLogger("narwhal.primary")


class Helper:
    def __init__(
        self,
        committee: Committee,
        certificate_store: CertificateStore,
        payload_store: PayloadStore,
    ):
        self.committee = committee
        self.certificate_store = certificate_store
        self.payload_store = payload_store

    async def on_certificates_batch(
        self, msg: CertificatesBatchRequest, peer: str
    ) -> CertificatesBatchResponse:
        """(helper.rs:117-163): return each requested certificate or None."""
        pairs = tuple(
            (digest, self.certificate_store.read(digest)) for digest in msg.digests
        )
        return CertificatesBatchResponse(pairs)

    async def on_certificates_range(
        self, msg: CertificatesRangeRequest, peer: str
    ) -> CertificatesRangeResponse:
        """Catch-up support (block_synchronizer SynchronizeRange): digests of
        all stored certificates with from_round < round <= to_round."""
        digests = tuple(
            cert.digest
            for cert in self.certificate_store.after_round(msg.from_round + 1)
            if cert.round <= msg.to_round
        )
        return CertificatesRangeResponse(digests)

    async def on_payload_availability(
        self, msg: PayloadAvailabilityRequest, peer: str
    ) -> PayloadAvailabilityResponse:
        """(helper.rs:165-213): for each certificate digest, do we hold its
        entire payload locally?"""
        result = []
        for digest in msg.digests:
            certificate = self.certificate_store.read(digest)
            if certificate is None:
                result.append((digest, False))
                continue
            available = all(
                self.payload_store.contains(batch_digest, worker_id)
                for batch_digest, worker_id in certificate.header.payload.items()
            )
            result.append((digest, available))
        return PayloadAvailabilityResponse(tuple(result))
