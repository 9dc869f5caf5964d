"""Pure dependency-check helper used by the core.

Port copy of `narwhal_tpu/primary/synchronizer.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/synchronizer.rs:22-178 —
`missing_payload` checks the payload store and queues a SyncBatches command for
anything absent; `get_parents` reads parent certificates from the store and
queues SyncParents when incomplete; `deliver_certificate` checks a
certificate's ancestry is complete.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..channels import Channel
from ..stores import CertificateStore, PayloadStore
from ..types import Certificate, Digest, Header, PublicKey, WorkerId


@dataclass
class SyncBatches:
    """Ask own workers to fetch `missing` batches, then replay `header`
    (WaiterMessage::SyncBatches)."""

    missing: dict[Digest, WorkerId]
    header: Header


@dataclass
class SyncParents:
    """Fetch `missing` parent certificates from `header.author`'s primary, then
    replay `header` (WaiterMessage::SyncParents)."""

    missing: list[Digest]
    header: Header


class Synchronizer:
    def __init__(
        self,
        name: PublicKey,
        certificate_store: CertificateStore,
        payload_store: PayloadStore,
        tx_header_waiter: Channel,
        genesis: dict[Digest, Certificate],
    ):
        self.name = name
        self.certificate_store = certificate_store
        self.payload_store = payload_store
        self.tx_header_waiter = tx_header_waiter
        self.genesis = dict(genesis)
        self.genesis_digests = frozenset(genesis)

    def update_genesis(self, committee) -> None:
        """Genesis digests embed the epoch; recompute them on reconfiguration
        or round-1 headers of the new epoch would suspend forever."""
        self.genesis = {c.digest: c for c in Certificate.genesis(committee)}
        self.genesis_digests = frozenset(self.genesis)

    async def missing_payload(self, header: Header) -> bool:
        """True if some batch of the header isn't locally available yet; queues
        the repair (synchronizer.rs:60-113). Our own headers never miss: we
        created them from digests our workers reported."""
        if header.author == self.name:
            return False
        missing = {
            digest: worker_id
            for digest, worker_id in header.payload.items()
            if not self.payload_store.contains(digest, worker_id)
        }
        if missing:
            await self.tx_header_waiter.send(SyncBatches(missing, header))
            return True
        return False

    async def get_parents(self, header: Header) -> list[Certificate] | None:
        """The parent certificates, or None (repair queued) if any is missing
        (synchronizer.rs:115-144). Genesis certificates are returned like any
        other parent (synchronizer.rs:119-125) so the caller's round-match and
        stake-quorum checks always run — an empty or sub-quorum genesis parent
        set must be rejected, not silently voted for."""
        parents: list[Certificate] = []
        missing: list[Digest] = []
        for digest in header.parents:
            genesis_cert = self.genesis.get(digest)
            if genesis_cert is not None:
                parents.append(genesis_cert)
                continue
            cert = self.certificate_store.read(digest)
            if cert is None:
                missing.append(digest)
            else:
                parents.append(cert)
        if missing:
            await self.tx_header_waiter.send(SyncParents(missing, header))
            return None
        return parents

    def deliver_certificate(self, certificate: Certificate) -> bool:
        """True iff the certificate's direct ancestry is locally complete
        (synchronizer.rs:146-178)."""
        return all(
            digest in self.genesis_digests or self.certificate_store.contains(digest)
            for digest in certificate.header.parents
        )
