"""Delta-encoded header wire forms: the header/certificate wire diet.

Port copy of `narwhal_tpu/primary/delta.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

At committee scale the control plane's per-link bytes are dominated by the
O(N) parts of every header announcement — the parent set (one 32-byte
certificate digest per committee member) — and by the certificate broadcast
re-shipping the same header body every voter already stores. This module
ref-encodes both against state the receiver provably holds:

- `DeltaHeaderMsg` (messages.py) carries the payload pairs *added since the
  sender's last header* (in this codebase a header's payload map is already
  the per-round delta: the proposer clears its digest buffer at every seal)
  and each parent as a 2-byte committee index into the receiver's
  recent-certificate index (parents of a round-r header are round r-1
  certificates, and at most one certificate per (round, origin) can gather a
  vote quorum, so (round-1, origin) names a parent unambiguously).
- Reconstruction is self-verifying: the rebuilt Header must hash to the
  carried header_digest (collision resistance makes a verified match
  byte-exact), after which the normal signature/sanitize path runs. Any
  unresolvable parent or digest mismatch falls back to the full-map resync
  path: `HeaderResyncRequest(digest, author, since_round)` to the author,
  answered with the full header plus the author's own intervening headers
  after the receiver's last-seen round.
- `CertificateDeltaMsg` rebuilds full-format certificates from the header
  store exactly like the compact form's CertificateRefMsg (primary.py shares
  one resolution path between them).

The codec is owned by the Core (one per primary): certificates are noted as
the core accepts them, which is also the order-correct place to decode —
a delta header queued behind its parent certificates resolves once the core
drains the queue in arrival order.
"""

from __future__ import annotations

import logging

from ..config import Committee
from ..crypto import digest256
from ..messages import CertificateDeltaMsg, DeltaHeaderMsg, HeaderMsg
from ..types import Certificate, Digest, Header, PublicKey, Round

logger = logging.getLogger("narwhal.primary")

# Own headers retained for resync service / since_round catch-up. Far above
# any plausible resync horizon (a receiver more than gc_depth behind repairs
# through the block synchronizer, not this path).
OWN_HEADER_WINDOW = 128
# Cap on intervening own headers piggybacked on one resync response.
RESYNC_CATCHUP_CAP = 32


class HeaderDeltaCodec:
    """Encode/decode delta headers against the recent-certificate index.

    All state is per-epoch volatile: rounds restart at 0 on epoch change and
    the index reseeds from the new committee's genesis certificates.
    """

    def __init__(self, committee: Committee):
        # round -> committee dense index -> certificate digest, and the
        # reverse map used by the encoder (parent digests -> indices).
        self._by_round: dict[Round, dict[int, Digest]] = {}
        self._index_of: dict[Digest, tuple[Round, int]] = {}
        # Our own recent headers, served to resyncing peers.
        self._own_headers: dict[Round, Header] = {}
        self.change_epoch(committee)

    # -- state maintenance -------------------------------------------------
    def note_certificate(self, certificate: Certificate) -> None:
        """Called by the core for every ACCEPTED certificate (the same spot
        that feeds the parent aggregator), so the encoder can always resolve
        its own parents and the decoder resolves anything the core already
        processed."""
        self._note(certificate.origin, certificate.round, certificate.digest)

    def note_header(self, header: Header) -> None:
        """Called by the core for every header it processes: a certificate's
        digest is a pure function of its header's digest (types.Certificate
        — digest256(b"CERT" || header_digest)), and receivers see a round's
        headers a FULL ROUND before the matching certificates arrive. Under
        load the certificate broadcast lags in-flight, so without this the
        decoder would miss parents it could already name — every miss costs
        a grace sleep or a resync round trip on the vote path. A wrong guess
        (equivocating origin) is harmless: the reconstruction digest check
        catches it and the resync path recovers."""
        self._note(
            header.author, header.round, digest256(b"CERT" + header.digest)
        )

    def _note(self, origin: PublicKey, round: Round, cert_digest: Digest) -> None:
        try:
            idx = self.committee.index_of(origin)
        except KeyError:
            return  # not in this epoch's committee; sanitize already rejects
        self._by_round.setdefault(round, {})[idx] = cert_digest
        self._index_of[cert_digest] = (round, idx)

    def note_own_header(self, header: Header) -> None:
        self._own_headers[header.round] = header
        while len(self._own_headers) > OWN_HEADER_WINDOW:
            del self._own_headers[min(self._own_headers)]

    def last_seen_round(self, origin: PublicKey) -> Round:
        """The highest round with an indexed certificate from `origin` — the
        since_round key a resync request carries."""
        try:
            idx = self.committee.index_of(origin)
        except KeyError:
            return 0
        seen = [r for r, certs in self._by_round.items() if idx in certs]
        return max(seen) if seen else 0

    def own_headers_since(self, since_round: Round, exclude: Digest) -> list[Header]:
        """Our own headers after since_round (ascending, capped) for the
        resync response's catch-up piggyback."""
        rounds = sorted(r for r in self._own_headers if r > since_round)
        out = [
            self._own_headers[r]
            for r in rounds[:RESYNC_CATCHUP_CAP]
            if self._own_headers[r].digest != exclude
        ]
        return out

    # -- encode ------------------------------------------------------------
    def encode_header(self, header: Header) -> DeltaHeaderMsg | None:
        """The wire-diet form of our own header, or None when any parent is
        not in the index (the caller then broadcasts the full HeaderMsg —
        correctness never depends on the delta form being available)."""
        indices = []
        for parent in header.parents:
            entry = self._index_of.get(parent)
            if entry is None or entry[0] + 1 != header.round:
                return None
            indices.append(entry[1])
        return DeltaHeaderMsg(
            header.author,
            header.round,
            header.epoch,
            header.digest,
            tuple(header.payload.items()),
            tuple(sorted(indices)),
            header.signature,
        )

    # -- decode ------------------------------------------------------------
    def decode_header(self, msg: DeltaHeaderMsg) -> Header | None:
        """Reconstruct the full Header, or None when a parent is missing or
        the reconstruction does not hash to the carried digest (the caller
        resyncs). A successful decode is byte-exact: header.digest ==
        msg.header_digest pins every reconstructed field."""
        round_certs = self._by_round.get(msg.round - 1, {})
        parents = []
        for idx in msg.parent_indices:
            digest = round_certs.get(idx)
            if digest is None:
                return None
            parents.append(digest)
        header = Header(
            msg.author,
            msg.round,
            msg.epoch,
            dict(msg.payload),
            frozenset(parents),
            msg.signature,
        )
        if header.digest != msg.header_digest:
            logger.debug(
                "delta header %s reconstruction mismatch (stale index or "
                "bad sender); resyncing",
                msg.header_digest.hex()[:16],
            )
            return None
        return header

    # -- lifecycle ---------------------------------------------------------
    def gc(self, gc_round: Round) -> None:
        for r in [r for r in self._by_round if r <= gc_round]:
            for digest in self._by_round.pop(r).values():
                self._index_of.pop(digest, None)
        for r in [r for r in self._own_headers if r <= gc_round]:
            del self._own_headers[r]

    def change_epoch(self, committee: Committee) -> None:
        self.committee = committee
        self._by_round.clear()
        self._index_of.clear()
        self._own_headers.clear()
        # Round-1 headers parent the genesis certificates; seed them so the
        # first delta headers of the epoch encode/decode without resync.
        for cert in Certificate.genesis(committee):
            self.note_certificate(cert)


def encode_announcement(codec: HeaderDeltaCodec, header: Header, wire: str):
    """The header announcement in the configured wire form, falling back to
    the self-describing full form whenever the delta is unavailable."""
    if wire == "delta":
        msg = codec.encode_header(header)
        if msg is not None:
            return msg
    return HeaderMsg(header)


def encode_certificate_announcement(certificate: Certificate, wire: str):
    """The certificate announcement: compact certificates already broadcast
    by reference (CertificateRefMsg); full-format ones shed the embedded
    header body under the delta wire form."""
    from ..messages import CertificateMsg, CertificateRefMsg

    if certificate.is_compact:
        return CertificateRefMsg.from_certificate(certificate)
    if wire == "delta":
        return CertificateDeltaMsg.from_certificate(certificate)
    return CertificateMsg(certificate)
