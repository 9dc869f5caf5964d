"""Fanout-tree dissemination: O(fanout) origin egress instead of all-to-all.

Port copy of `narwhal_tpu/primary/fanout.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference Narwhal broadcasts headers and certificates primary-to-primary
all-to-all (core.rs:149-179), which concentrates O(N) egress per round on
every origin — 13.7 MB/round at N=10@1k and O(N^2) toward the N=100 target.
This module spreads that egress over a deterministic, stake-weighted relay
tree, recomputed per (epoch, round, origin) so relay positions rotate and no
authority is a permanent interior node:

- Ordering: every node derives the same priority for each peer —
  `ticket = int(digest256(seed || pk)[:16]) // stake` sorted ascending — a
  pure-integer, platform-deterministic stake-weighted shuffle (higher stake
  => statistically earlier => closer to the root, carrying more relay duty,
  matching its resources). The seed binds epoch, round and origin.
- Topology: a complete `fanout`-ary heap over [origin] + ordering; children
  of position j are positions fanout*j+1 .. fanout*j+fanout. Depth >= 2
  whenever the committee has more others than the fanout (below that the
  broadcaster degrades to plain direct broadcast — a flat tree would only
  add envelope overhead).
- Transport: the origin reliable-sends a `RelayMsg` envelope (raw inner
  wire bytes, never re-encoded) to its direct children; every receiver
  delivers the inner message locally, forwards the unchanged envelope to
  its own children, and confirms receipt to the origin with a tiny
  `RelayAckMsg` (direct children are confirmed by the relay RPC ack
  itself).
- Reliability: reliable-broadcast semantics are preserved by a fallback —
  after `relay_fallback_timeout` the origin direct-sends the ORIGINAL
  message (reliable, retry-forever like the reference's broadcast) to every
  peer it has not heard from, so a crashed or byzantine-silent relay only
  delays its subtree by one timeout, never partitions it. All handles are
  round-keyed and cancelled at garbage collection, exactly like the core's
  cancel_handlers.
"""

from __future__ import annotations

import asyncio
import logging

from ..bounded_cache import BoundedCache
from ..clock import now
from ..channels import CancelOnDrop
from ..codec import Reader, Writer
from ..config import Committee
from ..crypto import DIGEST_LEN, digest256
from ..messages import (
    CertificateRefMsg,
    DeltaHeaderMsg,
    Relay2Msg,
    RelayAck2Msg,
    RelayAckMsg,
    RelayMsg,
    decode_message,
    encode_message,
)
from ..network import NetworkClient
from ..types import Digest, PublicKey, Round

logger = logging.getLogger("narwhal.primary")

# Relay2Msg body kinds (messages.Relay2Msg docstring).
R2_GENERIC = 0
R2_DELTA_HEADER = 1
R2_CERT_REF = 2


def _bitmap(indices, size: int) -> bytes:
    out = bytearray(-(-size // 8))
    for i in indices:
        out[i >> 3] |= 1 << (i & 7)
    return bytes(out)


def _bitmap_indices(bitmap: bytes) -> list[int]:
    return [
        (byte_i << 3) + bit
        for byte_i, b in enumerate(bitmap)
        for bit in range(8)
        if b & (1 << bit)
    ]


def encode_relay2(committee: Committee, name: PublicKey, round: Round, msg) -> Relay2Msg | None:
    """The slim relay envelope for our own announcement, or None when the
    slim ranges don't fit (huge round/epoch, foreign origin) — the caller
    then falls back to the legacy RelayMsg. Announcement fields duplicated
    by the envelope (origin, round, epoch) are DROPPED from the body; the
    receiver's decode_relay2 reconstitutes the exact fat message, so the
    resolution paths downstream never know the diet happened."""
    epoch = committee.epoch
    if round >= 1 << 32 or epoch >= 1 << 16:
        return None
    try:
        origin_index = committee.index_of(name)
    except KeyError:
        return None
    n = committee.size()
    w = Writer()
    if (
        isinstance(msg, CertificateRefMsg)
        and msg.origin == name
        and msg.round == round
        and msg.epoch == epoch
        and len(msg.agg_s) == 32
        and len(msg.rs) == len(msg.signers)
        and all(len(r) == 32 for r in msg.rs)
        and all(0 <= i < n for i in msg.signers)
        and list(msg.signers) == sorted(set(msg.signers))
    ):
        w.raw(msg.header_digest)
        w.raw(msg.agg_s)
        w.bytes(_bitmap(msg.signers, n))
        for r in msg.rs:  # signer-index order == ascending bitmap order
            w.raw(r)
        return Relay2Msg(origin_index, round, epoch, R2_CERT_REF, w.finish())
    if (
        isinstance(msg, DeltaHeaderMsg)
        and msg.author == name
        and msg.round == round
        and msg.epoch == epoch
        and len(msg.signature) == 64
        and all(0 <= i < n for i in msg.parent_indices)
        and list(msg.parent_indices) == sorted(set(msg.parent_indices))
        and all(0 <= wid < 1 << 16 for _, wid in msg.payload)
    ):
        w.raw(msg.header_digest)
        w.bytes(_bitmap(msg.parent_indices, n))
        w.raw(msg.signature)

        def enc_pair(w_: Writer, item) -> None:
            w_.raw(item[0])
            w_.u16(item[1])

        w.seq(msg.payload, enc_pair)
        return Relay2Msg(origin_index, round, epoch, R2_DELTA_HEADER, w.finish())
    tag, body = encode_message(msg)
    w.u16(tag)
    w.raw(body)
    return Relay2Msg(origin_index, round, epoch, R2_GENERIC, w.finish())


def decode_relay2(committee: Committee, msg: Relay2Msg):
    """Reconstitute the fat announcement a Relay2Msg carries. Raises
    ValueError/CodecError on anything malformed — byzantine envelopes can
    only be dropped (and the origin's own tree position is derived from the
    envelope, so a forged origin only mis-roots a tree the inner message's
    signature checks still gate)."""
    keys = committee.authority_keys()
    if msg.origin_index >= len(keys):
        raise ValueError(f"origin index {msg.origin_index} out of range")
    origin = keys[msg.origin_index]
    r = Reader(msg.body)
    if msg.kind == R2_GENERIC:
        tag = r.u16()
        return decode_message(tag, r.rest())
    if msg.kind == R2_CERT_REF:
        header_digest = r.raw(DIGEST_LEN)
        agg_s = r.raw(32)
        signers = tuple(_bitmap_indices(r.bytes()))
        if any(i >= len(keys) for i in signers):
            raise ValueError("signer bitmap exceeds committee")
        rs = tuple(r.raw(32) for _ in signers)
        r.done()
        return CertificateRefMsg(
            header_digest, msg.round, msg.epoch, origin, signers, rs, agg_s
        )
    if msg.kind == R2_DELTA_HEADER:
        header_digest = r.raw(DIGEST_LEN)
        parents = tuple(_bitmap_indices(r.bytes()))
        if any(i >= len(keys) for i in parents):
            raise ValueError("parent bitmap exceeds committee")
        signature = r.raw(64)
        payload = tuple(r.seq(lambda r_: (r_.raw(DIGEST_LEN), r_.u16())))
        r.done()
        return DeltaHeaderMsg(
            origin, msg.round, msg.epoch, header_digest, payload, parents, signature
        )
    raise ValueError(f"unknown relay2 kind {msg.kind}")


def relay_order(committee: Committee, epoch: int, round: Round, origin: PublicKey) -> list[PublicKey]:
    """Deterministic stake-weighted ordering of the origin's peers for the
    (epoch, round, origin) tree. Pure integer math so every implementation
    agrees bit-for-bit (the committee.leader discipline)."""
    seed = digest256(
        b"relay-tree"
        + int(epoch).to_bytes(8, "little")
        + int(round).to_bytes(8, "little")
        + origin
    )
    def ticket(pk: PublicKey) -> tuple[int, PublicKey]:
        stake = max(1, committee.stake(pk))
        return (int.from_bytes(digest256(seed + pk)[:16], "little") // stake, pk)

    return sorted(
        (pk for pk in committee.authority_keys() if pk != origin), key=ticket
    )


def relay_children(
    committee: Committee,
    epoch: int,
    round: Round,
    origin: PublicKey,
    me: PublicKey,
    fanout: int,
) -> list[PublicKey]:
    """My children in the (epoch, round, origin)-rooted tree (empty when I
    am a leaf or not a committee member for this epoch)."""
    order = relay_order(committee, epoch, round, origin)
    seq = [origin] + order
    try:
        j = seq.index(me)
    except ValueError:
        return []
    return seq[fanout * j + 1 : fanout * j + 1 + fanout]


class _TreeCache:
    """Bounded memo of relay orderings: every node derives each
    (epoch, round, origin) tree at least twice per round (the origin's
    header AND certificate broadcasts), and at N=50 each derivation is ~N
    digest256 tickets — measurable on a starved host. FIFO-bounded so a
    byzantine round/origin spray cannot grow it."""

    def __init__(self, capacity: int = 512):
        self._cache: dict[tuple, list[PublicKey]] = {}
        self._capacity = capacity

    def order(
        self, committee: Committee, epoch: int, round: Round, origin: PublicKey
    ) -> list[PublicKey]:
        key = (epoch, round, origin)
        cached = self._cache.get(key)
        if cached is None:
            cached = relay_order(committee, epoch, round, origin)
            while len(self._cache) >= self._capacity:
                del self._cache[next(iter(self._cache))]
            self._cache[key] = cached
        return cached

    def children(
        self,
        committee: Committee,
        epoch: int,
        round: Round,
        origin: PublicKey,
        me: PublicKey,
        fanout: int,
    ) -> list[PublicKey]:
        seq = [origin] + self.order(committee, epoch, round, origin)
        try:
            j = seq.index(me)
        except ValueError:
            return []
        return seq[fanout * j + 1 : fanout * j + 1 + fanout]

    def clear(self) -> None:
        self._cache.clear()


class FanoutBroadcaster:
    """Owns the relay plane of one primary: origin-side broadcasts with ack
    tracking + fallback, relay-side forwarding, and round-keyed handle GC."""

    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        network: NetworkClient,
        fanout: int,
        fallback_timeout: float,
        metrics=None,
    ):
        self.name = name
        self.network = network
        self.fanout = fanout
        self.fallback_timeout = fallback_timeout
        self.metrics = metrics
        # Reliable-send + fallback-task handles by round, cancelled at GC
        # (the cancel_handlers discipline of core.rs).
        self._round_handles: dict[Round, list] = {}
        # ack_id -> authorities confirmed (via RelayAckMsg or a completed
        # child send), for our own in-flight broadcasts only.
        self._acks: dict[Digest, set[PublicKey]] = {}
        self._ack_round: dict[Digest, Round] = {}
        self._ack_t0: dict[Digest, float] = {}
        # Observed broadcast->ack latency EWMA. The configured
        # fallback_timeout is a FLOOR, not the deadline: a CPU-starved
        # committee (N=50+ on a small host) legitimately takes seconds to
        # relay + ack, and falling back on a wall-clock guess re-sends the
        # whole broadcast direct — measured at N=50 this DOUBLED wire
        # bytes/round and halved rounds/s. Waiting ~4 observed latencies
        # keeps the fallback a crash-recovery path, not a steady-state one.
        self._ack_latency_ewma: float | None = None
        # round -> ack_id of OUR header broadcast at that round: votes are
        # implicit receipt confirmations (a vote travels to the broadcast's
        # origin — us — and proves the voter processed the header), so
        # receivers skip the explicit RelayAck2Msg for slim header relays
        # entirely. Peers that receive but cannot vote (suspended on
        # missing parents/payload) simply get one fallback direct send —
        # dedup'd on arrival, and the vote-fed latency EWMA keeps that
        # fallback deadline honest under load.
        self._header_ack_ids: dict[Round, Digest] = {}
        # Short-lived best-effort tasks (ack sends), kept strongly.
        self._tasks: set[asyncio.Task] = set()
        # ack_ids whose envelope we already forwarded to our children:
        # duplicate copies of the same broadcast (several relayers share us
        # as a child) still ACK per copy — the origin's fallback timer needs
        # every receipt — but re-forwarding each copy would re-amplify the
        # whole subtree O(copies) times. Bounded FIFO; capacity comfortably
        # covers the in-flight rounds of the largest committees.
        self._forwarded = BoundedCache(max_entries=8192)
        self._trees = _TreeCache()
        self.change_epoch(committee)

    # -- configuration -----------------------------------------------------
    def relaying(self) -> bool:
        """Relay only when the tree has depth >= 2; a flat tree is just a
        direct broadcast wearing an envelope."""
        return 0 < self.fanout < self.committee.size() - 1

    # -- origin side -------------------------------------------------------
    def broadcast(self, round: Round, msg) -> list:
        """Disseminate our own header/certificate announcement. Returns the
        handles the caller should treat like network.broadcast handles
        (this object ALSO tracks them for its own GC, so callers may simply
        drop the return value)."""
        others = self.committee.others_primaries(self.name)
        if not self.relaying():
            handles = self.network.broadcast([a for _, a, _ in others], msg)
            self._round_handles.setdefault(round, []).extend(handles)
            return handles
        relay = encode_relay2(self.committee, self.name, round, msg)
        if relay is not None:
            ack_id = relay.ack_id
        else:  # slim ranges don't fit: legacy fat envelope
            tag, body = encode_message(msg)
            ack_id = digest256(tag.to_bytes(2, "little") + body)
            relay = RelayMsg(self.name, round, self.committee.epoch, tag, body)
        children = self._trees.children(
            self.committee, self.committee.epoch, round, self.name, self.name,
            self.fanout,
        )
        acked: set[PublicKey] = set()
        self._acks[ack_id] = acked
        self._ack_round[ack_id] = round
        self._ack_t0[ack_id] = now()
        if isinstance(relay, Relay2Msg) and relay.kind == R2_DELTA_HEADER:
            self._header_ack_ids[round] = ack_id
        handles = []
        # Per-attempt deadline scaled to observed relay reality (like the
        # fallback deadline): a fixed 10 s deadline on a committee whose
        # broadcasts take seconds re-sends kilobyte envelopes to SLOW peers
        # — pure wire waste the receiver dedups.
        send_timeout = max(10.0, self._fallback_delay())
        for child in children:
            handle = self.network.send(
                self.committee.primary_address(child), relay,
                timeout=send_timeout,
            )
            handle.task.add_done_callback(
                lambda t, pk=child, a=ack_id: (
                    self._mark_acked(a, pk)
                    if not t.cancelled() and t.exception() is None
                    else None
                )
            )
            handles.append(handle)
        fallback = asyncio.ensure_future(
            self._fallback(ack_id, round, msg, [pk for pk, _, _ in others])
        )
        handles.append(CancelOnDrop(fallback))
        self._round_handles.setdefault(round, []).extend(handles)
        if self.metrics is not None:
            self.metrics.relay_broadcasts.inc()
        return handles

    def _mark_acked(self, ack_id: Digest, pk: PublicKey) -> None:
        acked = self._acks.get(ack_id)
        if acked is None or pk in acked:
            return
        acked.add(pk)
        t0 = self._ack_t0.get(ack_id)
        if t0 is not None:
            latency = now() - t0
            prev = self._ack_latency_ewma
            self._ack_latency_ewma = (
                latency if prev is None else 0.2 * latency + 0.8 * prev
            )

    def _fallback_delay(self) -> float:
        """The configured timeout floored against observed relay reality: a
        committee whose broadcasts take seconds end-to-end must not pay a
        full direct re-broadcast every round for being slow."""
        ewma = self._ack_latency_ewma
        if ewma is None:
            return self.fallback_timeout
        return min(60.0, max(self.fallback_timeout, 4.0 * ewma))

    async def _fallback(
        self, ack_id: Digest, round: Round, msg, targets: list[PublicKey]
    ) -> None:
        await asyncio.sleep(self._fallback_delay())
        acked = self._acks.get(ack_id, set())
        missing = [pk for pk in targets if pk not in acked]
        if not missing:
            return
        logger.debug(
            "relay fallback round %s: direct-sending to %d un-acked peers",
            round,
            len(missing),
        )
        if self.metrics is not None:
            self.metrics.relay_fallback_sends.inc(len(missing))
        send_timeout = max(10.0, self._fallback_delay())
        handles = [
            self.network.send(
                self.committee.primary_address(pk), msg, timeout=send_timeout
            )
            for pk in missing
        ]
        self._round_handles.setdefault(round, []).extend(handles)

    # -- relay side --------------------------------------------------------
    def on_relay(self, msg: RelayMsg) -> None:
        """Forward the unchanged LEGACY envelope to our children in the
        origin's tree and confirm receipt to the origin. Local delivery of
        the inner message is the caller's job (Primary routes it through
        the normal ingest paths). Non-blocking: forwards are reliable-send
        background handles, the ack a tracked best-effort task."""
        if msg.epoch != self.committee.epoch or msg.origin == self.name:
            # Cross-epoch relays can't place us in a tree we agree on; the
            # inner message still buffers/drops through the core's epoch
            # logic, and the origin's fallback covers our would-be subtree.
            return
        ack_id = msg.ack_id
        if self._forwarded.get(ack_id) is None:
            self._forwarded.put(ack_id, True)
            children = self._trees.children(
                self.committee, msg.epoch, msg.round, msg.origin, self.name,
                self.fanout,
            )
            forwards = [
                self.network.send(self.committee.primary_address(child), msg)
                for child in children
                if child != msg.origin
            ]
            self._round_handles.setdefault(msg.round, []).extend(forwards)
            if self.metrics is not None and forwards:
                self.metrics.relays_forwarded.inc(len(forwards))
        try:
            origin_address = self.committee.primary_address(msg.origin)
        except KeyError:
            return
        task = asyncio.ensure_future(
            self.network.unreliable_send(
                origin_address, RelayAckMsg(ack_id, self.name), timeout=5.0
            )
        )
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def on_relay2(self, msg: Relay2Msg, origin: PublicKey) -> None:
        """Relay2 receive side: forward the unchanged slim envelope to our
        children and ack the origin — both as fire-and-forget KIND_ONEWAY
        frames. The per-hop RPC Ack and retry machinery are deliberately
        skipped: delivery of the WHOLE broadcast is guaranteed by the
        origin's ack tracking + direct fallback, so a frame lost on a torn
        connection costs one fallback send, while the removed response
        frames and deadline resends were ~10% of all control-plane bytes
        at N=50."""
        if msg.epoch != self.committee.epoch or origin == self.name:
            return
        ack_id = msg.ack_id
        sends = []
        if self._forwarded.get(ack_id) is None:
            self._forwarded.put(ack_id, True)
            children = self._trees.children(
                self.committee, msg.epoch, msg.round, origin, self.name,
                self.fanout,
            )
            sends = [
                self.network.oneway_send(self.committee.primary_address(child), msg)
                for child in children
                if child != origin
            ]
            if self.metrics is not None and sends:
                self.metrics.relays_forwarded.inc(len(sends))
        try:
            my_index = self.committee.index_of(self.name)
            origin_address = self.committee.primary_address(origin)
        except KeyError:
            my_index = None
        # Slim header relays are acked IMPLICITLY by the vote we send the
        # author (note_vote at the origin); only non-header relays need an
        # explicit receipt.
        if my_index is not None and msg.kind != R2_DELTA_HEADER:
            sends.append(
                self.network.oneway_send(
                    origin_address, RelayAck2Msg(ack_id, my_index)
                )
            )
        for coro in sends:
            task = asyncio.ensure_future(coro)
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    def note_vote(self, round: Round, voter: PublicKey) -> None:
        """A vote for OUR round-`round` header arrived: the voter provably
        received (and processed) the header broadcast — the implicit
        receipt that replaces explicit RelayAck2Msg frames on the slim
        header lane."""
        ack_id = self._header_ack_ids.get(round)
        if ack_id is not None:
            self._mark_acked(ack_id, voter)

    def on_ack2(self, msg: RelayAck2Msg, peer_key: PublicKey | None) -> None:
        """Slim receipt confirmation: handshake-verified identity wins, the
        carried committee index is only trusted on open meshes (the
        RelayAckMsg discipline)."""
        if peer_key is not None:
            acker = self._authority_of_network_key.get(peer_key)
        else:
            keys = self.committee.authority_keys()
            acker = (
                keys[msg.acker_index] if msg.acker_index < len(keys) else None
            )
        if acker is None or msg.ack_id not in self._acks:
            return
        self._mark_acked(msg.ack_id, acker)
        if self.metrics is not None:
            self.metrics.relay_acks_received.inc()

    def on_ack(self, msg: RelayAckMsg, peer_key: PublicKey | None) -> None:
        """Record a receipt confirmation. The acker identity comes from the
        handshake-verified peer network key when the mesh is authenticated;
        the carried name is only trusted on open (bare-test) meshes — a
        byzantine peer must not be able to suppress another peer's
        fallback delivery by acking on its behalf."""
        acker = (
            self._authority_of_network_key.get(peer_key)
            if peer_key is not None
            else msg.acker
        )
        if acker is None or msg.ack_id not in self._acks:
            return
        self._mark_acked(msg.ack_id, acker)
        if self.metrics is not None:
            self.metrics.relay_acks_received.inc()

    # -- lifecycle ---------------------------------------------------------
    def gc(self, gc_round: Round) -> None:
        for r in [r for r in self._round_handles if r <= gc_round]:
            for handle in self._round_handles.pop(r):
                handle.cancel()
        for ack_id in [
            a for a, r in self._ack_round.items() if r <= gc_round
        ]:
            del self._ack_round[ack_id]
            self._acks.pop(ack_id, None)
            self._ack_t0.pop(ack_id, None)
        for r in [r for r in self._header_ack_ids if r <= gc_round]:
            del self._header_ack_ids[r]

    def change_epoch(self, committee: Committee) -> None:
        self.committee = committee
        self._authority_of_network_key: dict[PublicKey, PublicKey] = {
            a.network_key: pk for pk, a in committee.authorities.items()
        }
        for handles in self._round_handles.values():
            for handle in handles:
                handle.cancel()
        self._round_handles.clear()
        self._acks.clear()
        self._ack_round.clear()
        self._ack_t0.clear()
        self._header_ack_ids.clear()
        # Ack latencies of the old epoch say nothing about the new
        # committee — and an inflated stale EWMA would slow the fallback
        # exactly when cross-epoch slim relays depend on it for delivery.
        self._ack_latency_ewma = None
        self._trees.clear()

    def shutdown(self) -> None:
        for handles in self._round_handles.values():
            for handle in handles:
                handle.cancel()
        self._round_handles.clear()
        for task in list(self._tasks):
            task.cancel()
