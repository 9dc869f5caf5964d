"""Inter-role RPC messages with a tag registry.

Port copy of `narwhal_tpu/messages.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference message enums: PrimaryMessage / PrimaryWorkerMessage /
WorkerPrimaryMessage (narwhal/types/src/primary.rs:646-789) and the
worker<->worker plane (narwhal/types/src/worker.rs:17-32), carried by
anemo services generated in narwhal/types/build.rs:42-121.

Every message is a dataclass with a unique TAG, canonical encode/decode, and
is registered for the RPC layer's dispatch. Reliable sends are acked request/
response pairs (the anemo RPC analog); messages that expect data back define a
response type.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bounded_cache import BoundedCache
from .codec import Reader, Writer
from .config import Committee
from .crypto import DIGEST_LEN, PUBLIC_KEY_LEN, SIGNATURE_LEN
from .types import Batch, Certificate, Digest, Header, PublicKey, Round, Vote, WorkerId

REGISTRY: dict[int, type] = {}


def message(tag: int):
    def deco(cls):
        assert tag not in REGISTRY, f"duplicate message tag {tag}"
        cls.TAG = tag
        REGISTRY[tag] = cls
        return cls

    return deco


def encode_message(msg) -> tuple[int, bytes]:
    # Broadcasts and retries encode the same object repeatedly (a batch goes
    # to every peer and each reliable-send attempt re-encodes); memoize the
    # wire form on the instance.
    cached = getattr(msg, "_encoded", None)
    if cached is not None:
        return cached
    w = Writer()
    msg.encode(w)
    encoded = (msg.TAG, w.finish())
    try:
        msg._encoded = encoded
    except AttributeError:
        pass  # slotted/frozen types just skip the memo
    return encoded


# Process-wide decode cache. A broadcast's wire bytes arrive once per
# LINK: every node hosted in this process decodes an identical body, and a
# single node re-decodes identical bodies on retry/re-delivery. The JAX
# package's N=50 profile (its host, not the port's) measured message
# decode at ~30% of the host's CPU, nearly all of it duplicates. Decoded messages are immutable by convention —
# nothing in the codebase mutates a received message (encode memoization
# is the one benign exception) — so identical (tag, body) pairs can share
# one decoded object. Keyed by the raw bytes (hashed once per received
# frame, C-speed), bounded by a byte budget with FIFO eviction
# (BoundedCache: thread-safe, shared with the crypto/store caches).
_DECODE_CACHE = BoundedCache(max_bytes=64 << 20)
_DECODE_MAX_BODY = 1 << 16  # don't pin data-plane (batch) bodies


def decode_message(tag: int, body: bytes):
    key = (tag, body)
    cached = _DECODE_CACHE.get(key)
    if cached is not None:
        return cached
    cls = REGISTRY.get(tag)
    if cls is None:
        raise ValueError(f"unknown message tag {tag}")
    r = Reader(body)
    msg = cls.decode(r)
    r.done()
    if len(body) <= _DECODE_MAX_BODY:
        # The (tag, body) key tuple pins the raw body bytes alongside the
        # decoded object (which aliases/copies roughly the same bytes), so
        # one entry holds ~2x the body in memory; charge both sides against
        # the byte budget or the cache runs ~2x over its nominal bound.
        _DECODE_CACHE.put(key, msg, weight=2 * len(body))
    return msg


def _enc_digest(w: Writer, d: Digest) -> None:
    w.raw(d)


def _dec_digest(r: Reader) -> Digest:
    return r.raw(DIGEST_LEN)


# ---------------------------------------------------------------------------
# Generic
# ---------------------------------------------------------------------------


@message(0)
@dataclass
class Ack:
    """Empty reliable-delivery acknowledgment."""

    def encode(self, w: Writer) -> None:
        pass

    @staticmethod
    def decode(r: Reader) -> "Ack":
        return Ack()


# ---------------------------------------------------------------------------
# Primary <-> Primary (types/src/primary.rs:646-700)
# ---------------------------------------------------------------------------


@message(1)
@dataclass
class HeaderMsg:
    header: Header

    def encode(self, w: Writer) -> None:
        self.header.encode(w)

    @staticmethod
    def decode(r: Reader) -> "HeaderMsg":
        return HeaderMsg(Header.decode(r))


@message(2)
@dataclass
class VoteMsg:
    vote: Vote

    def encode(self, w: Writer) -> None:
        self.vote.encode(w)

    @staticmethod
    def decode(r: Reader) -> "VoteMsg":
        return VoteMsg(Vote.decode(r))


@message(3)
@dataclass
class CertificateMsg:
    certificate: Certificate

    def encode(self, w: Writer) -> None:
        self.certificate.encode(w)

    @staticmethod
    def decode(r: Reader) -> "CertificateMsg":
        return CertificateMsg(Certificate.decode(r))


@message(72)
@dataclass
class CertificateRefMsg:
    """Compact-certificate broadcast WITHOUT the header body
    (Parameters.cert_format="compact"): every peer that voted already
    stores the header, so the announcement carries only its digest plus
    the half-aggregated proof — cutting the dominant O(N) control-plane
    bytes (header parents + per-signer signatures) from every certificate
    broadcast. Receivers rebuild the Certificate from their header store
    and fall back to fetching the full certificate from the origin
    (CertificatesBatchRequest -> Helper) on miss. Replaces the capability
    the reference gets from O(1) BLS certificates
    (narwhal/types/src/primary.rs:386-644)."""

    header_digest: Digest
    round: Round
    epoch: Epoch
    origin: PublicKey
    signers: tuple[int, ...]
    rs: tuple[bytes, ...]  # 32-byte nonce points
    agg_s: bytes  # 32-byte aggregate scalar

    @staticmethod
    def from_certificate(cert: Certificate) -> "CertificateRefMsg":
        assert cert.is_compact
        return CertificateRefMsg(
            cert.header.digest,
            cert.round,
            cert.epoch,
            cert.origin,
            cert.signers,
            cert.signatures,
            cert.agg_s,
        )

    def rebuild(self, header: Header) -> Certificate:
        return Certificate(header, self.signers, self.rs, self.agg_s)

    def encode(self, w: Writer) -> None:
        w.raw(self.header_digest)
        w.u64(self.round)
        w.u64(self.epoch)
        w.raw(self.origin)
        w.seq(self.signers, lambda w_, i: w_.u32(i))
        w.seq(self.rs, lambda w_, r: w_.raw(r))
        w.raw(self.agg_s)

    @staticmethod
    def decode(r: Reader) -> "CertificateRefMsg":
        return CertificateRefMsg(
            r.raw(DIGEST_LEN),
            r.u64(),
            r.u64(),
            r.raw(PUBLIC_KEY_LEN),
            tuple(r.seq(lambda r_: r_.u32())),
            tuple(r.seq(lambda r_: r_.raw(32))),
            r.raw(32),
        )


@message(4)
@dataclass
class CertificatesRequest:
    """Ask a peer for specific certificates; peer replies with loose
    CertificateMsg sends (reference PrimaryMessage::CertificatesRequest,
    helper.rs:82-99)."""

    digests: tuple[Digest, ...]
    requestor: PublicKey

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)
        w.raw(self.requestor)

    @staticmethod
    def decode(r: Reader) -> "CertificatesRequest":
        return CertificatesRequest(
            tuple(r.seq(_dec_digest)), r.raw(PUBLIC_KEY_LEN)
        )


@message(5)
@dataclass
class CertificatesBatchRequest:
    """Block-synchronizer bulk fetch; RPC with CertificatesBatchResponse."""

    digests: tuple[Digest, ...]
    requestor: PublicKey = b"\0" * 32

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)
        w.raw(self.requestor)

    @staticmethod
    def decode(r: Reader) -> "CertificatesBatchRequest":
        return CertificatesBatchRequest(tuple(r.seq(_dec_digest)), r.raw(PUBLIC_KEY_LEN))


@message(6)
@dataclass
class CertificatesBatchResponse:
    """(digest, certificate|None) pairs (reference CertificateDigestsResponse)."""

    certificates: tuple[tuple[Digest, Certificate | None], ...]

    def encode(self, w: Writer) -> None:
        def enc(w_: Writer, item) -> None:
            digest, cert = item
            w_.raw(digest)
            if cert is None:
                w_.u8(0)
            else:
                w_.u8(1)
                cert.encode(w_)

        w.seq(self.certificates, enc)

    @staticmethod
    def decode(r: Reader) -> "CertificatesBatchResponse":
        def dec(r_: Reader):
            digest = _dec_digest(r_)
            return (digest, Certificate.decode(r_) if r_.u8() else None)

        return CertificatesBatchResponse(tuple(r.seq(dec)))


@message(7)
@dataclass
class CertificatesRangeRequest:
    """Catch-up: digests of certificates in rounds (from, to] per authority
    (block_synchronizer SynchronizeRange)."""

    from_round: Round
    to_round: Round
    requestor: PublicKey = b"\0" * 32

    def encode(self, w: Writer) -> None:
        w.u64(self.from_round)
        w.u64(self.to_round)
        w.raw(self.requestor)

    @staticmethod
    def decode(r: Reader) -> "CertificatesRangeRequest":
        return CertificatesRangeRequest(r.u64(), r.u64(), r.raw(PUBLIC_KEY_LEN))


@message(8)
@dataclass
class CertificatesRangeResponse:
    digests: tuple[Digest, ...]

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)

    @staticmethod
    def decode(r: Reader) -> "CertificatesRangeResponse":
        return CertificatesRangeResponse(tuple(r.seq(_dec_digest)))


@message(9)
@dataclass
class PayloadAvailabilityRequest:
    digests: tuple[Digest, ...]
    requestor: PublicKey = b"\0" * 32

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)
        w.raw(self.requestor)

    @staticmethod
    def decode(r: Reader) -> "PayloadAvailabilityRequest":
        return PayloadAvailabilityRequest(tuple(r.seq(_dec_digest)), r.raw(PUBLIC_KEY_LEN))


@message(10)
@dataclass
class PayloadAvailabilityResponse:
    available: tuple[tuple[Digest, bool], ...]

    def encode(self, w: Writer) -> None:
        def enc(w_: Writer, item) -> None:
            w_.raw(item[0])
            w_.u8(1 if item[1] else 0)

        w.seq(self.available, enc)

    @staticmethod
    def decode(r: Reader) -> "PayloadAvailabilityResponse":
        def dec(r_: Reader):
            return (_dec_digest(r_), bool(r_.u8()))

        return PayloadAvailabilityResponse(tuple(r.seq(dec)))


@message(73)
@dataclass
class RelayMsg:
    """Fanout-tree broadcast envelope (primary/fanout.py). The origin sends
    its header/certificate announcement to its direct children in a
    deterministic, stake-weighted per-round tree instead of all-to-all;
    every receiver re-derives the same tree from (epoch, round, origin) and
    forwards the UNCHANGED envelope to its own children, so the origin's
    per-round egress is O(fanout) rather than O(N). The inner message rides
    as raw (tag, body) wire bytes — relays never re-encode, and the ack id
    every hop agrees on is digest256(tag_le16 || body)."""

    origin: PublicKey  # the broadcasting authority (tree root)
    round: Round
    epoch: int
    inner_tag: int
    inner_body: bytes

    def encode(self, w: Writer) -> None:
        w.raw(self.origin)
        w.u64(self.round)
        w.u64(self.epoch)
        w.u16(self.inner_tag)
        w.bytes(self.inner_body)

    @staticmethod
    def decode(r: Reader) -> "RelayMsg":
        return RelayMsg(
            r.raw(PUBLIC_KEY_LEN), r.u64(), r.u64(), r.u16(), r.bytes()
        )

    def inner(self):
        return decode_message(self.inner_tag, self.inner_body)

    @property
    def ack_id(self) -> Digest:
        from .crypto import digest256

        return digest256(self.inner_tag.to_bytes(2, "little") + self.inner_body)


@message(74)
@dataclass
class RelayAckMsg:
    """Receipt confirmation a relay RECEIVER sends back to the tree's origin
    (direct children are covered by the relay RPC ack itself). Peers the
    origin has not heard from within relay_fallback_timeout get the original
    message by direct reliable send — the fallback that preserves
    reliable-broadcast semantics when a relay node crashes. The acker is
    authenticated by the handshake-verified peer identity; the carried name
    is only trusted on unauthenticated (bare-test) meshes."""

    ack_id: Digest
    acker: PublicKey

    def encode(self, w: Writer) -> None:
        w.raw(self.ack_id)
        w.raw(self.acker)

    @staticmethod
    def decode(r: Reader) -> "RelayAckMsg":
        return RelayAckMsg(r.raw(DIGEST_LEN), r.raw(PUBLIC_KEY_LEN))


@message(75)
@dataclass
class DeltaHeaderMsg:
    """Header announcement on a wire diet (Parameters.header_wire="delta").

    Carries only the (digest, worker_id) payload pairs added since the
    sender's last header (in this codebase a header's payload map IS the
    per-round delta — the proposer clears its digest buffer at every seal),
    and ref-encodes the O(N) parent set: parents of a round-r header are
    round r-1 certificates, which every peer already received via the
    certificate broadcast, so 2 bytes of committee index replace each 32-byte
    digest. The receiver reconstructs the full Header from its recent
    certificate index (primary/delta.py), checks the reconstruction against
    the carried header_digest (collision resistance makes a verified match
    byte-exact), and runs the normal signature/sanitize path. Any
    unresolvable parent or digest mismatch triggers the full-map resync path
    (HeaderResyncRequest, keyed off the receiver's last-seen round)."""

    author: PublicKey
    round: Round
    epoch: int
    header_digest: Digest
    payload: tuple[tuple[Digest, WorkerId], ...]  # pairs added since last header
    parent_indices: tuple[int, ...]  # committee dense indices of parent origins
    signature: bytes

    def encode(self, w: Writer) -> None:
        w.raw(self.author)
        w.u64(self.round)
        w.u64(self.epoch)
        w.raw(self.header_digest)

        def enc_pair(w_: Writer, item) -> None:
            w_.raw(item[0])
            w_.u32(item[1])

        w.seq(self.payload, enc_pair)
        w.seq(self.parent_indices, lambda w_, i: w_.u16(i))
        w.bytes(self.signature)

    @staticmethod
    def decode(r: Reader) -> "DeltaHeaderMsg":
        return DeltaHeaderMsg(
            r.raw(PUBLIC_KEY_LEN),
            r.u64(),
            r.u64(),
            r.raw(DIGEST_LEN),
            tuple(r.seq(lambda r_: (r_.raw(DIGEST_LEN), r_.u32()))),
            tuple(r.seq(lambda r_: r_.u16())),
            r.bytes(),
        )


@message(76)
@dataclass
class HeaderResyncRequest:
    """Full-map resync for a delta header the receiver could not
    reconstruct: ask the AUTHOR for the full header by digest, keyed off the
    receiver's last-seen round for that author so the response can also
    carry the author's intervening headers (the receiver is behind by more
    than one round exactly when parents stop resolving)."""

    header_digest: Digest
    author: PublicKey
    since_round: Round  # receiver's last-seen round for this author
    requestor: PublicKey = b"\0" * 32

    def encode(self, w: Writer) -> None:
        w.raw(self.header_digest)
        w.raw(self.author)
        w.u64(self.since_round)
        w.raw(self.requestor)

    @staticmethod
    def decode(r: Reader) -> "HeaderResyncRequest":
        return HeaderResyncRequest(
            r.raw(DIGEST_LEN), r.raw(PUBLIC_KEY_LEN), r.u64(), r.raw(PUBLIC_KEY_LEN)
        )


@message(77)
@dataclass
class HeaderResyncResponse:
    """Full headers answering a HeaderResyncRequest: the requested header
    plus any of the author's own headers after since_round it still holds
    (bounded). Receivers feed every entry through the normal sanitize path —
    a byzantine responder can only send headers that fail verification."""

    headers: tuple[Header, ...]

    def encode(self, w: Writer) -> None:
        w.seq(self.headers, lambda w_, h: h.encode(w_))

    @staticmethod
    def decode(r: Reader) -> "HeaderResyncResponse":
        return HeaderResyncResponse(tuple(r.seq(Header.decode)))


@message(78)
@dataclass
class CertificateDeltaMsg:
    """Full-format certificate broadcast WITHOUT the embedded header body
    (the header_wire="delta" analog of CertificateRefMsg): every peer that
    voted already stores the header — a round's header bytes otherwise
    travel every link twice (HeaderMsg, then again inside CertificateMsg).
    Receivers rebuild the Certificate from their header store and fall back
    to fetching the full certificate from the origin on miss (same
    resolution path as CertificateRefMsg)."""

    header_digest: Digest
    round: Round
    epoch: int
    origin: PublicKey
    signers: tuple[int, ...]
    signatures: tuple[bytes, ...]  # 64-byte ed25519 signatures

    @staticmethod
    def from_certificate(cert: Certificate) -> "CertificateDeltaMsg":
        assert not cert.is_compact
        return CertificateDeltaMsg(
            cert.header.digest,
            cert.round,
            cert.epoch,
            cert.origin,
            cert.signers,
            cert.signatures,
        )

    def rebuild(self, header: Header) -> Certificate:
        return Certificate(header, self.signers, self.signatures)

    def encode(self, w: Writer) -> None:
        w.raw(self.header_digest)
        w.u64(self.round)
        w.u64(self.epoch)
        w.raw(self.origin)
        # u16 committee indices: dense ids, and this message exists to
        # shave broadcast bytes.
        w.seq(self.signers, lambda w_, i: w_.u16(i))
        w.seq(self.signatures, lambda w_, s: w_.raw(s))

    @staticmethod
    def decode(r: Reader) -> "CertificateDeltaMsg":
        return CertificateDeltaMsg(
            r.raw(DIGEST_LEN),
            r.u64(),
            r.u64(),
            r.raw(PUBLIC_KEY_LEN),
            tuple(r.seq(lambda r_: r_.u16())),
            tuple(r.seq(lambda r_: r_.raw(64))),
        )


@message(79)
@dataclass
class Relay2Msg:
    """Slim fanout-tree envelope (the wire-diet successor of RelayMsg —
    which stays accepted): the origin is a 2-byte committee index, round and
    epoch shrink to u32/u16, and the inner announcement rides as a
    purpose-built compact body instead of a self-describing message, so the
    envelope stops re-shipping fields the announcement also carries:

      kind 1 — delta header: header_digest | parents BITMAP (one bit per
               committee index at round-1) | 64-byte signature | payload
               (digest, u16 worker) pairs; author/round/epoch come from the
               envelope. ~150 B at N=50 vs ~260 for DeltaHeaderMsg-in-RelayMsg.
      kind 2 — compact certificate: header_digest | agg_s | signer BITMAP |
               the 32-byte R nonces in signer order. Saves the duplicated
               origin/round/epoch and the u32-per-signer index list of
               CertificateRefMsg (~190 B/certificate/link at N=50).
      kind 0 — generic: u16 inner tag | raw body (any announcement the slim
               kinds cannot express: full HeaderMsg fallbacks, full-format
               CertificateMsg/CertificateDeltaMsg).

    Decoding kinds 1/2 back into DeltaHeaderMsg/CertificateRefMsg needs the
    committee (index->key, bitmap width) and happens in primary/fanout.py;
    receivers then run the EXACT resolution paths the fat forms take. The
    ack id every hop agrees on covers the whole envelope identity."""

    origin_index: int  # committee dense index of the broadcasting authority
    round: Round
    epoch: int
    kind: int  # 0 generic | 1 delta header | 2 compact certificate
    body: bytes

    def encode(self, w: Writer) -> None:
        w.u16(self.origin_index)
        w.u32(self.round)
        w.u16(self.epoch)
        w.u8(self.kind)
        w.raw(self.body)

    @staticmethod
    def decode(r: Reader) -> "Relay2Msg":
        return Relay2Msg(r.u16(), r.u32(), r.u16(), r.u8(), r.rest())

    @property
    def ack_id(self) -> Digest:
        from .crypto import digest256

        return digest256(
            b"R2"
            + self.origin_index.to_bytes(2, "little")
            + self.round.to_bytes(4, "little")
            + self.epoch.to_bytes(2, "little")
            + bytes([self.kind])
            + self.body
        )


@message(81)
@dataclass
class Vote2Msg:
    """Slim vote (the wire-diet successor of VoteMsg, which stays
    accepted): a vote always travels to the HEADER AUTHOR, who can
    reconstruct round/epoch/origin from the header digest (its own current
    header, or its header store) — so the wire carries only the digest,
    the voter, and the signature (128 B vs 180). The rebuilt Vote's signed
    message is a pure function of the reconstructed fields, so a forged or
    misdirected slim vote simply fails signature verification."""

    header_digest: Digest
    author: PublicKey  # the voter
    signature: bytes  # 64-byte ed25519

    @staticmethod
    def from_vote(vote: Vote) -> "Vote2Msg":
        return Vote2Msg(vote.header_digest, vote.author, vote.signature)

    def rebuild(self, header: Header) -> Vote:
        return Vote(
            self.header_digest,
            header.round,
            header.epoch,
            header.author,
            self.author,
            self.signature,
        )

    def encode(self, w: Writer) -> None:
        w.raw(self.header_digest)
        w.raw(self.author)
        w.raw(self.signature)

    @staticmethod
    def decode(r: Reader) -> "Vote2Msg":
        return Vote2Msg(
            r.raw(DIGEST_LEN), r.raw(PUBLIC_KEY_LEN), r.raw(SIGNATURE_LEN)
        )


@message(80)
@dataclass
class RelayAck2Msg:
    """Slim receipt confirmation for Relay2Msg broadcasts, sent as a
    fire-and-forget KIND_ONEWAY frame (no RPC Ack response — delivery of
    the ack itself is best-effort by design: a lost ack costs the origin
    one fallback direct send). The acker is the handshake-verified peer on
    authenticated meshes; the carried committee index is only trusted on
    open (bare-test) meshes, like RelayAckMsg's name field."""

    ack_id: Digest
    acker_index: int

    def encode(self, w: Writer) -> None:
        w.raw(self.ack_id)
        w.u16(self.acker_index)

    @staticmethod
    def decode(r: Reader) -> "RelayAck2Msg":
        return RelayAck2Msg(r.raw(DIGEST_LEN), r.u16())


# ---------------------------------------------------------------------------
# Telemetry plane: scrape + flight-recorder dump over the public typed API
# (ConsensusApi routes these, so they're fabric-reachable under simnet; the
# gRPC edge exposes the same payloads for interop scrapers).
# ---------------------------------------------------------------------------


@message(82)
@dataclass
class TelemetryScrapeMsg:
    """Request the node's Prometheus text exposition."""

    def encode(self, w: Writer) -> None:
        pass

    @staticmethod
    def decode(r: Reader) -> "TelemetryScrapeMsg":
        return TelemetryScrapeMsg()


@message(83)
@dataclass
class TelemetryScrapeResponse:
    """Prometheus exposition-format text (# HELP/# TYPE + samples)."""

    text: str

    def encode(self, w: Writer) -> None:
        w.bytes(self.text.encode())

    @staticmethod
    def decode(r: Reader) -> "TelemetryScrapeResponse":
        return TelemetryScrapeResponse(r.bytes().decode())


@message(84)
@dataclass
class FlightDumpMsg:
    """Request the node's flight-recorder dump (bounded structured event
    ring + span edges). max_events=0 means the full ring."""

    max_events: int = 0

    def encode(self, w: Writer) -> None:
        w.u32(self.max_events)

    @staticmethod
    def decode(r: Reader) -> "FlightDumpMsg":
        return FlightDumpMsg(r.u32())


@message(85)
@dataclass
class FlightDumpResponse:
    """Self-contained JSON flight-recorder dump (tracing.Tracer.dump),
    sort_keys-canonical so dumps diff and snapshot deterministically."""

    payload: bytes

    def encode(self, w: Writer) -> None:
        w.bytes(self.payload)

    @staticmethod
    def decode(r: Reader) -> "FlightDumpResponse":
        return FlightDumpResponse(r.bytes())


# ---------------------------------------------------------------------------
# Primary -> Worker (types/src/primary.rs:702-750)
# ---------------------------------------------------------------------------


@message(20)
@dataclass
class SynchronizeMsg:
    """Fetch these batches from the target authority's same-id worker
    (worker/src/synchronizer.rs:77-384)."""

    digests: tuple[Digest, ...]
    target: PublicKey

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)
        w.raw(self.target)

    @staticmethod
    def decode(r: Reader) -> "SynchronizeMsg":
        return SynchronizeMsg(tuple(r.seq(_dec_digest)), r.raw(PUBLIC_KEY_LEN))


@message(21)
@dataclass
class CleanupMsg:
    round: Round

    def encode(self, w: Writer) -> None:
        w.u64(self.round)

    @staticmethod
    def decode(r: Reader) -> "CleanupMsg":
        return CleanupMsg(r.u64())


@message(22)
@dataclass
class RequestBatchMsg:
    digest: Digest

    def encode(self, w: Writer) -> None:
        w.raw(self.digest)

    @staticmethod
    def decode(r: Reader) -> "RequestBatchMsg":
        return RequestBatchMsg(_dec_digest(r))


@message(25)
@dataclass
class RequestBatchesMsg:
    """Coalesced batch fetch: every digest a requester is missing from ONE
    worker rides a single RPC instead of one round trip each. The worker
    answers from one coalesced store read with RequestedBatchesMsg, so the
    commit-to-execution data plane pays RTT per (worker, certificate) group
    rather than per batch. Digests answer in request order."""

    digests: tuple[Digest, ...]

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)

    @staticmethod
    def decode(r: Reader) -> "RequestBatchesMsg":
        return RequestBatchesMsg(tuple(r.seq(_dec_digest)))


@message(23)
@dataclass
class DeleteBatchesMsg:
    digests: tuple[Digest, ...]

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)

    @staticmethod
    def decode(r: Reader) -> "DeleteBatchesMsg":
        return DeleteBatchesMsg(tuple(r.seq(_dec_digest)))


@message(26)
@dataclass
class BackpressureMsg:
    """Primary -> own workers: the downstream (consensus/executor) backlog
    level in [0, 1], pushed every backpressure_poll_interval. The worker's
    ingest gate folds it into admission decisions (pacing.IngestGate) so
    client-facing ingest sheds/blocks BEFORE the backlog grows unboundedly.
    Fixed-point basis points on the wire; best-effort delivery — a worker
    that stops hearing levels fails open (BackpressureState.stale_after)."""

    level_bp: int  # level * 10_000, clamped to [0, 10_000]

    def encode(self, w: Writer) -> None:
        w.u16(self.level_bp)

    @staticmethod
    def decode(r: Reader) -> "BackpressureMsg":
        return BackpressureMsg(r.u16())

    @staticmethod
    def from_level(level: float) -> "BackpressureMsg":
        return BackpressureMsg(int(max(0.0, min(1.0, level)) * 10_000))

    @property
    def level(self) -> float:
        return self.level_bp / 10_000


@message(24)
@dataclass
class ReconfigureMsg:
    """kind: 'new_epoch' | 'update_committee' | 'shutdown'; committee as JSON
    (ReconfigureNotification, types/src/primary.rs:646-668)."""

    kind: str
    committee_json: str = ""

    def encode(self, w: Writer) -> None:
        w.bytes(self.kind.encode())
        w.bytes(self.committee_json.encode())

    @staticmethod
    def decode(r: Reader) -> "ReconfigureMsg":
        return ReconfigureMsg(r.bytes().decode(), r.bytes().decode())

    def committee(self) -> Committee | None:
        return Committee.from_json(self.committee_json) if self.committee_json else None


# ---------------------------------------------------------------------------
# Worker -> Primary (types/src/worker.rs WorkerPrimaryMessage)
# ---------------------------------------------------------------------------


@message(30)
@dataclass
class OurBatchMsg:
    digest: Digest
    worker_id: WorkerId

    def encode(self, w: Writer) -> None:
        w.raw(self.digest)
        w.u32(self.worker_id)

    @staticmethod
    def decode(r: Reader) -> "OurBatchMsg":
        return OurBatchMsg(_dec_digest(r), r.u32())


@message(31)
@dataclass
class OthersBatchMsg:
    digest: Digest
    worker_id: WorkerId

    def encode(self, w: Writer) -> None:
        w.raw(self.digest)
        w.u32(self.worker_id)

    @staticmethod
    def decode(r: Reader) -> "OthersBatchMsg":
        return OthersBatchMsg(_dec_digest(r), r.u32())


@message(32)
@dataclass
class RequestedBatchMsg:
    """Batch fetch response. Carries the *serialized* batch so the server
    side never decodes/re-encodes transactions (found=False for a miss);
    requesters decode once via `transactions`."""

    digest: Digest
    serialized_batch: bytes
    found: bool = True

    def encode(self, w: Writer) -> None:
        w.raw(self.digest)
        w.u8(1 if self.found else 0)
        w.bytes(self.serialized_batch)

    @staticmethod
    def decode(r: Reader) -> "RequestedBatchMsg":
        digest = _dec_digest(r)
        found = r.u8() == 1
        return RequestedBatchMsg(digest, r.bytes(), found)

    @property
    def transactions(self) -> tuple[bytes, ...]:
        if not self.found:
            return ()
        return Batch.from_bytes(self.serialized_batch).transactions


@message(35)
@dataclass
class RequestedBatchesMsg:
    """Response to RequestBatchesMsg: one (digest, found, serialized_batch)
    entry per requested digest, in request order, each byte-identical to what
    the equivalent single RequestBatchMsg would have returned (misses carry
    found=False and empty bytes). The server never decodes the stored wire
    bytes; verification (serialized_batch_digest) is the requester's."""

    batches: tuple[tuple[Digest, bool, bytes], ...]

    def encode(self, w: Writer) -> None:
        def enc(w_: Writer, item) -> None:
            digest, found, raw = item
            w_.raw(digest)
            w_.u8(1 if found else 0)
            w_.bytes(raw)

        w.seq(self.batches, enc)

    @staticmethod
    def decode(r: Reader) -> "RequestedBatchesMsg":
        def dec(r_: Reader):
            digest = _dec_digest(r_)
            found = r_.u8() == 1
            return (digest, found, r_.bytes())

        return RequestedBatchesMsg(tuple(r.seq(dec)))


@message(33)
@dataclass
class DeletedBatchesMsg:
    digests: tuple[Digest, ...]

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)

    @staticmethod
    def decode(r: Reader) -> "DeletedBatchesMsg":
        return DeletedBatchesMsg(tuple(r.seq(_dec_digest)))


@message(34)
@dataclass
class WorkerErrorMsg:
    error: str

    def encode(self, w: Writer) -> None:
        w.bytes(self.error.encode())

    @staticmethod
    def decode(r: Reader) -> "WorkerErrorMsg":
        return WorkerErrorMsg(r.bytes().decode())


# ---------------------------------------------------------------------------
# Worker <-> Worker (types/src/worker.rs:17-32)
# ---------------------------------------------------------------------------


@message(40)
@dataclass
class WorkerBatchMsg:
    """Batch dissemination. Carries the serialized batch so the receiver can
    digest the wire bytes directly (serialized_batch_digest,
    types/src/worker.rs:44-62). The message body IS the serialized batch
    (no length wrapper): encoding a broadcast is zero-copy — the memoized
    wire form aliases the batch bytes instead of duplicating them."""

    serialized_batch: bytes

    def encode(self, w: Writer) -> None:
        w.raw(self.serialized_batch)

    @staticmethod
    def decode(r: Reader) -> "WorkerBatchMsg":
        return WorkerBatchMsg(r.rest())

    def batch(self) -> Batch:
        return Batch.from_bytes(self.serialized_batch)


@message(41)
@dataclass
class WorkerBatchRequest:
    digests: tuple[Digest, ...]

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)

    @staticmethod
    def decode(r: Reader) -> "WorkerBatchRequest":
        return WorkerBatchRequest(tuple(r.seq(_dec_digest)))


@message(42)
@dataclass
class WorkerBatchResponse:
    batches: tuple[bytes, ...]  # serialized batches

    def encode(self, w: Writer) -> None:
        w.seq(self.batches, lambda w_, b: w_.bytes(b))

    @staticmethod
    def decode(r: Reader) -> "WorkerBatchResponse":
        return WorkerBatchResponse(tuple(r.seq(lambda r_: r_.bytes())))


# ---------------------------------------------------------------------------
# Client -> Worker transactions (the tonic Transactions service analog,
# worker/src/worker.rs:352-423)
# ---------------------------------------------------------------------------


@message(50)
@dataclass
class SubmitTransactionMsg:
    transaction: bytes

    def encode(self, w: Writer) -> None:
        w.bytes(self.transaction)

    @staticmethod
    def decode(r: Reader) -> "SubmitTransactionMsg":
        return SubmitTransactionMsg(r.bytes())


@message(51)
@dataclass
class SubmitTransactionStreamMsg:
    """Batched client submission (the streaming variant).

    Decoded lazily: the ingest path validates the frames structurally
    (types.validate_tx_frames) and forwards the undecoded chunk straight into
    batch sealing — the burst's wire form IS the batch's wire form, so no
    per-transaction split ever happens on the worker."""

    transactions: tuple[bytes, ...] = ()
    raw: bytes | None = None  # full wire body: u32 count | frames

    def encode(self, w: Writer) -> None:
        if self.raw is not None:
            w.raw(self.raw)
        else:
            w.bytes_seq(self.transactions)

    @staticmethod
    def decode(r: Reader) -> "SubmitTransactionStreamMsg":
        return SubmitTransactionStreamMsg((), r.rest())

    @property
    def count(self) -> int:
        if self.raw is None:
            return len(self.transactions)
        import struct

        (n,) = struct.unpack_from("<I", self.raw, 0)
        return n

    @property
    def frames(self) -> bytes:
        """The per-tx frames without the leading count word."""
        if self.raw is None:
            w = Writer()
            self.encode(w)
            return w.finish()[4:]
        return self.raw[4:]

    @property
    def txs(self) -> tuple[bytes, ...]:
        """Materialized transactions (tests/low-rate tools only)."""
        if self.raw is None:
            return self.transactions
        r = Reader(self.raw)
        out = tuple(r.bytes_seq())
        r.done()
        return out


# ---------------------------------------------------------------------------
# Public consensus API (the tonic Validator / Proposer / Configuration
# services, narwhal/types/proto/narwhal.proto:127-152 served by
# primary/src/grpc_server/). "Collection" = a certificate's payload.
# ---------------------------------------------------------------------------


@message(60)
@dataclass
class GetCollectionsRequest:
    digests: tuple[Digest, ...]

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)

    @staticmethod
    def decode(r: Reader) -> "GetCollectionsRequest":
        return GetCollectionsRequest(tuple(r.seq(_dec_digest)))


@message(61)
@dataclass
class GetCollectionsResponse:
    """Per requested digest: (digest, batches, error). `batches` is a tuple
    of (batch_digest, transactions); `error` is "" on success."""

    results: tuple[tuple[Digest, tuple[tuple[Digest, tuple[bytes, ...]], ...], str], ...]

    def encode(self, w: Writer) -> None:
        def enc_batch(w_: Writer, item) -> None:
            _enc_digest(w_, item[0])
            w_.seq(item[1], lambda w2, t: w2.bytes(t))

        def enc(w_: Writer, item) -> None:
            _enc_digest(w_, item[0])
            w_.seq(item[1], enc_batch)
            w_.bytes(item[2].encode())

        w.seq(self.results, enc)

    @staticmethod
    def decode(r: Reader) -> "GetCollectionsResponse":
        def dec_batch(r_: Reader):
            return (_dec_digest(r_), tuple(r_.seq(lambda r2: r2.bytes())))

        def dec(r_: Reader):
            return (
                _dec_digest(r_),
                tuple(r_.seq(dec_batch)),
                r_.bytes().decode(),
            )

        return GetCollectionsResponse(tuple(r.seq(dec)))


@message(62)
@dataclass
class RemoveCollectionsRequest:
    digests: tuple[Digest, ...]

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)

    @staticmethod
    def decode(r: Reader) -> "RemoveCollectionsRequest":
        return RemoveCollectionsRequest(tuple(r.seq(_dec_digest)))


@message(63)
@dataclass
class ReadCausalRequest:
    digest: Digest

    def encode(self, w: Writer) -> None:
        _enc_digest(w, self.digest)

    @staticmethod
    def decode(r: Reader) -> "ReadCausalRequest":
        return ReadCausalRequest(_dec_digest(r))


@message(64)
@dataclass
class ReadCausalResponse:
    digests: tuple[Digest, ...]

    def encode(self, w: Writer) -> None:
        w.seq(self.digests, _enc_digest)

    @staticmethod
    def decode(r: Reader) -> "ReadCausalResponse":
        return ReadCausalResponse(tuple(r.seq(_dec_digest)))


@message(65)
@dataclass
class RoundsRequest:
    public_key: PublicKey

    def encode(self, w: Writer) -> None:
        w.raw(self.public_key)

    @staticmethod
    def decode(r: Reader) -> "RoundsRequest":
        return RoundsRequest(r.raw(PUBLIC_KEY_LEN))


@message(66)
@dataclass
class RoundsResponse:
    oldest_round: Round
    newest_round: Round

    def encode(self, w: Writer) -> None:
        w.u64(self.oldest_round)
        w.u64(self.newest_round)

    @staticmethod
    def decode(r: Reader) -> "RoundsResponse":
        return RoundsResponse(r.u64(), r.u64())


@message(67)
@dataclass
class NodeReadCausalRequest:
    public_key: PublicKey
    round: Round

    def encode(self, w: Writer) -> None:
        w.raw(self.public_key)
        w.u64(self.round)

    @staticmethod
    def decode(r: Reader) -> "NodeReadCausalRequest":
        return NodeReadCausalRequest(r.raw(PUBLIC_KEY_LEN), r.u64())


@message(68)
@dataclass
class NewNetworkInfoRequest:
    """(epoch, [(public_key, stake, primary_address)])."""

    epoch: int
    validators: tuple[tuple[PublicKey, int, str], ...]

    def encode(self, w: Writer) -> None:
        w.u64(self.epoch)

        def enc(w_: Writer, item) -> None:
            w_.raw(item[0])
            w_.u64(item[1])
            w_.bytes(item[2].encode())

        w.seq(self.validators, enc)

    @staticmethod
    def decode(r: Reader) -> "NewNetworkInfoRequest":
        def dec(r_: Reader):
            return (r_.raw(PUBLIC_KEY_LEN), r_.u64(), r_.bytes().decode())

        return NewNetworkInfoRequest(r.u64(), tuple(r.seq(dec)))


@message(69)
@dataclass
class GetPrimaryAddressRequest:
    def encode(self, w: Writer) -> None:
        pass

    @staticmethod
    def decode(r: Reader) -> "GetPrimaryAddressRequest":
        return GetPrimaryAddressRequest()


@message(70)
@dataclass
class GetPrimaryAddressResponse:
    address: str

    def encode(self, w: Writer) -> None:
        w.bytes(self.address.encode())

    @staticmethod
    def decode(r: Reader) -> "GetPrimaryAddressResponse":
        return GetPrimaryAddressResponse(r.bytes().decode())


@message(71)
@dataclass
class NewEpochRequest:
    epoch: int

    def encode(self, w: Writer) -> None:
        w.u64(self.epoch)

    @staticmethod
    def decode(r: Reader) -> "NewEpochRequest":
        return NewEpochRequest(r.u64())
