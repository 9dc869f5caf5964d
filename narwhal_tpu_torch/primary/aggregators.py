"""Stake-weighted vote and certificate accumulation.

Port copy of `narwhal_tpu/primary/aggregators.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/aggregators.rs:16-99 — VotesAggregator
turns a quorum of votes over our header into a Certificate; one
CertificatesAggregator per round turns a quorum of certificates into the next
round's parent set.
"""

from __future__ import annotations

from ..config import Committee
from ..types import Certificate, Digest, Header, Vote


class VotesAggregator:
    """Collects votes for one of our headers; yields the certificate once the
    accumulated stake (author's own stake included, counted at append of the
    author's implicit self-vote) reaches quorum
    (narwhal/primary/src/aggregators.rs:16-57)."""

    def __init__(self, cert_format: str = "full") -> None:
        self.weight = 0
        self.votes: list[tuple[int, bytes]] = []  # (committee index, signature)
        self.seen: set[bytes] = set()  # voter public keys
        self.done = False
        self.cert_format = cert_format

    def append(
        self, vote: Vote, committee: Committee, header: Header
    ) -> Certificate | None:
        if self.done or vote.author in self.seen:
            return None
        self.seen.add(vote.author)
        self.votes.append((committee.index_of(vote.author), vote.signature))
        self.weight += committee.stake(vote.author)
        if self.weight >= committee.quorum_threshold():
            self.done = True
            signers, sigs = zip(*sorted(self.votes))
            if self.cert_format == "compact":
                # Half-aggregate: ~32 bytes/signer instead of 64, and the
                # proof verifies as one msm-kernel equation (types.py
                # Certificate docstring; Parameters.cert_format). Passing
                # the committee lets assembly pre-seed the aggregate
                # verdict cache when every vote is already known-valid.
                return Certificate.compact_from_votes(
                    header, tuple(signers), tuple(sigs), committee=committee
                )
            return Certificate(header, tuple(signers), tuple(sigs))
        return None


class CertificatesAggregator:
    """Collects certificates of one round; yields the parent digest set once
    their combined stake reaches quorum
    (narwhal/primary/src/aggregators.rs:59-99)."""

    def __init__(self) -> None:
        self.weight = 0
        self.certificates: list[Certificate] = []
        self.seen: set[bytes] = set()  # origins

    def append(
        self, certificate: Certificate, committee: Committee
    ) -> list[Certificate] | None:
        if certificate.origin in self.seen:
            return None
        self.seen.add(certificate.origin)
        self.certificates.append(certificate)
        self.weight += committee.stake(certificate.origin)
        if self.weight >= committee.quorum_threshold():
            # Deliberately keep the accumulated weight: certificates arriving
            # after the quorum (e.g. the leader's) are each drained and
            # forwarded too — Bullshark's leader linkage depends on late
            # parents reaching the proposer (aggregators.rs:83-97).
            drained = self.certificates
            self.certificates = []
            return drained
        return None
