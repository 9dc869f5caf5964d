"""Asyncio TCP RPC mesh — the validator-internal communication backend.

Port copy of `narwhal_tpu/network/rpc.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: anemo QUIC with bincode codec wrapped by P2pNetwork
(narwhal/network/src/p2p.rs:26-360) offering unreliable_send
(fire-once), send (retry forever with exponential backoff, cancel-on-drop)
and broadcast/lucky_broadcast policies (narwhal/network/src/traits.rs:10-94),
with per-peer BoundedExecutor concurrency caps
(narwhal/network/src/bounded_executor.rs:46-153) and RetryConfig
(narwhal/network/src/retry.rs:9-60).

A device-backed deployment keeps this plane on the host NIC (ethernet): BFT
messages must stay per-validator-signed point-to-point — device collectives
(NVLink) are trust-free only inside one operator's machine (SURVEY §5.9). Transport is
length-prefixed frames over TCP with persistent auto-reconnecting peer
connections; every send is an acked request/response, so reliable-send stake
counting (QuorumWaiter) works exactly as in the reference.

Frame layout: u32 body_len | u8 kind(REQ/RESP/ERR/ONEWAY) | u64 request_id |
u16 msg_tag | u8 lane | payload.

The lane byte is the multiplexing key of the CONNECTION POOL
(network/pool.py): all of a node pair's role lanes — the primary<->primary
plane (lane 0) and every worker mesh lane (lane 1+worker_id) — share ONE
authenticated framed stream, the anemo one-QUIC-connection-per-peer model.
The server side dispatches each frame to the lane's handler table; the
FrameSender drains per-lane queues round-robin so a saturated bulk lane
(batch relay) cannot starve a latency-critical one (votes). Pooled
connections are also BIDIRECTIONAL: the acceptor sends its own requests
over the accepted stream (PeerLink) — the request/response kinds travel in
opposite directions per rid namespace, so both endpoints' rid counters stay
independent — which is what takes an in-process N-node committee from
O(N^2 * lanes) sockets to one per unordered node pair.
"""

from __future__ import annotations

import asyncio
import hashlib
import itertools
import logging
import random
import struct
from typing import Awaitable, Callable, Iterable

from ..bounded_cache import BoundedCache
from ..channels import CancelOnDrop
from ..messages import Ack, decode_message, encode_message
from . import transport
from .auth import (
    KIND_HELLO,
    MAC_LEN,
    AuthError,
    Credentials,
    Peer,
    Session,
    client_handshake,
    server_handshake,
)

logger = logging.getLogger("narwhal.network")

_FRAME_HDR = struct.Struct("<IBQHB")  # len, kind, rid, tag, lane
KIND_REQ = 0
KIND_RESP = 1
KIND_ERR = 2
# Fire-and-forget request: the server dispatches the handler but writes NO
# response frame, and the client tracks no rid. For high-frequency lanes
# whose delivery is guaranteed by an APPLICATION-level mechanism (the relay
# plane: origin-side ack tracking + direct fallback), the per-frame Ack
# response and the retry-on-deadline resends of the RPC layer are pure
# overhead — ~10% of all control-plane bytes at N=50 in the JAX
# package's measurement.
# (KIND_HELLO = 3 lives in auth.py.)
KIND_ONEWAY = 4

MAX_FRAME = 64 << 20  # 64 MiB, > max batch size with generous headroom
MAX_TASK_CONCURRENCY = 500  # per-peer cap (network/src/lib.rs:54)

# Lane ids (the u8 lane byte of the frame header): lane 0 is the
# primary<->primary plane, lane 1+wid is worker mesh lane wid. Legacy
# (non-pooled) connections always carry lane 0 — the server they dial is
# the single role that owns the address, so the byte is redundant there.
LANE_PRIMARY = 0


def worker_lane(worker_id: int) -> int:
    return 1 + worker_id


# ERR body a pool-accepting server answers when a frame names a lane whose
# role is not co-hosted in its process (a split primary/worker deployment):
# the client falls back to a direct connection to the role's own address.
LANE_UNAVAILABLE = b"lane-unavailable"


class RpcError(Exception):
    pass


class RpcTimeout(RpcError):
    """The request deadline fired after the transport was up — the peer is
    slow (or the deadline too tight), not gone. Reliable-send escalates its
    per-attempt deadline only for this class; connect-refused and other
    transport failures are instant and must not inflate later deadlines."""


class RpcLaneUnavailable(RpcError):
    """The pooled endpoint does not co-host the target lane (split
    deployment); NetworkClient reroutes to a direct legacy connection."""


class RetryConfig:
    """Exponential backoff (network/src/retry.rs:9-60). max_elapsed=None
    retries forever (the reliable-send policy, p2p.rs:37-41)."""

    def __init__(
        self,
        initial: float = 0.05,
        multiplier: float = 1.5,
        max_interval: float = 5.0,
        max_elapsed: float | None = 30.0,
        jitter: float = 0.1,
    ):
        self.initial = initial
        self.multiplier = multiplier
        self.max_interval = max_interval
        self.max_elapsed = max_elapsed
        self.jitter = jitter

    def delays(self):
        delay = self.initial
        elapsed = 0.0
        while True:
            # Reconnect jitter rides the scenario-seeded global stream
            # (scenario.py seeds `random` per plan), so replays see the
            # same backoff schedule; outside simnet jitter spread is the
            # entire point and determinism is irrelevant.
            d = delay * (1.0 + random.uniform(-self.jitter, self.jitter))  # lint: allow(unseeded-random)
            yield d
            elapsed += d
            if self.max_elapsed is not None and elapsed >= self.max_elapsed:
                return
            delay = min(delay * self.multiplier, self.max_interval)


def _pack(kind: int, rid: int, tag: int, body: bytes, lane: int = 0) -> bytes:
    return _FRAME_HDR.pack(len(body), kind, rid, tag, lane) + body


class WireStats:
    """Process-wide wire counters: every frame written/read by every peer
    link in this process (an in-process committee's WHOLE control plane).
    Two integer adds per frame — cheap enough to stay always-on; the
    benchmark harness samples `snapshot()` around its measurement window
    to report bytes-per-round (the metric the compact-certificate wire
    form exists to move) and frames-per-drain (the metric the write
    coalescer exists to move)."""

    frames_sent = 0
    bytes_sent = 0
    frames_received = 0
    bytes_received = 0
    # Write-coalescing accounting: one "drain" = one socket flush covering
    # every frame queued on that connection at that moment.
    drains = 0
    frames_per_drain: dict[int, int] = {}  # power-of-two bucket -> drains

    @classmethod
    def record_drain(cls, frames: int) -> None:
        cls.drains += 1
        bucket = 1
        while bucket < frames:
            bucket <<= 1
        cls.frames_per_drain[bucket] = cls.frames_per_drain.get(bucket, 0) + 1

    @classmethod
    def snapshot(cls) -> dict:
        return {
            "frames_sent": cls.frames_sent,
            "bytes_sent": cls.bytes_sent,
            "frames_received": cls.frames_received,
            "bytes_received": cls.bytes_received,
            "drains": cls.drains,
            "frames_per_drain": dict(sorted(cls.frames_per_drain.items())),
        }


class WireCounters:
    """Per-ROLE wire accounting (one instance per primary/worker network,
    unlike the process-wide WireStats): every frame the role writes or
    reads, bucketed by message type AND lane, surfaced as the registry
    counters `wire_bytes_{sent,received}_total{msg_type=,lane=}` and
    `wire_frames_{sent,received}_total{msg_type=,lane=}` — the lane
    dimension makes the pool's per-lane interleaving observable (is the
    vote lane moving while the batch lane saturates?). Plain integer totals
    (`bytes_sent`/`bytes_received`) ride along for cheap deltas — the
    core's per-round egress gauge reads them once per round. Cost per frame
    is two int adds + one cached labels() lookup."""

    __slots__ = (
        "bytes_sent",
        "bytes_received",
        "frames_sent",
        "frames_received",
        "_sent_bytes_m",
        "_recv_bytes_m",
        "_sent_frames_m",
        "_recv_frames_m",
        "_label_cache",
        "_sent_children",
        "_recv_children",
    )

    def __init__(self, registry=None):
        self.bytes_sent = 0
        self.bytes_received = 0
        self.frames_sent = 0
        self.frames_received = 0
        self._sent_bytes_m = self._recv_bytes_m = None
        self._sent_frames_m = self._recv_frames_m = None
        self._label_cache: dict[tuple[int, int], tuple[str, str]] = {}
        # Labelled-child cache: (tag, lane) -> (bytes child, frames child).
        # labels() re-stringifies + re-hashes on every call; at N=200 the
        # four per-frame lookups are a top-of-profile tax, so we resolve
        # each (tag, lane) pair once and bump the child values directly.
        self._sent_children: dict[tuple[int, int], tuple] = {}
        self._recv_children: dict[tuple[int, int], tuple] = {}
        if registry is not None:
            self._sent_bytes_m = registry.counter(
                "wire_bytes_sent_total",
                "Wire bytes written by this role, by message type and lane",
                labels=("msg_type", "lane"),
            )
            self._recv_bytes_m = registry.counter(
                "wire_bytes_received_total",
                "Wire bytes read by this role, by message type and lane",
                labels=("msg_type", "lane"),
            )
            self._sent_frames_m = registry.counter(
                "wire_frames_sent_total",
                "Frames written by this role, by message type and lane",
                labels=("msg_type", "lane"),
            )
            self._recv_frames_m = registry.counter(
                "wire_frames_received_total",
                "Frames read by this role, by message type and lane",
                labels=("msg_type", "lane"),
            )

    def _labels(self, tag: int, lane: int) -> tuple[str, str]:
        pair = self._label_cache.get((tag, lane))
        if pair is None:
            from ..messages import REGISTRY

            cls = REGISTRY.get(tag)
            name = cls.__name__ if cls is not None else f"tag{tag}"
            pair = (name, str(lane))
            self._label_cache[(tag, lane)] = pair
        return pair

    def record_sent(self, tag: int, wire_len: int, lane: int = 0) -> None:
        self.bytes_sent += wire_len
        self.frames_sent += 1
        if self._sent_bytes_m is not None:
            pair = self._sent_children.get((tag, lane))
            if pair is None:
                name, lane_s = self._labels(tag, lane)
                pair = (
                    self._sent_bytes_m.labels(name, lane_s),
                    self._sent_frames_m.labels(name, lane_s),
                )
                self._sent_children[(tag, lane)] = pair
            pair[0].value += wire_len
            pair[1].value += 1.0

    def record_received(self, tag: int, wire_len: int, lane: int = 0) -> None:
        self.bytes_received += wire_len
        self.frames_received += 1
        if self._recv_bytes_m is not None:
            pair = self._recv_children.get((tag, lane))
            if pair is None:
                name, lane_s = self._labels(tag, lane)
                pair = (
                    self._recv_bytes_m.labels(name, lane_s),
                    self._recv_frames_m.labels(name, lane_s),
                )
                self._recv_children[(tag, lane)] = pair
            pair[0].value += wire_len
            pair[1].value += 1.0


def _write_frame(
    writer: asyncio.StreamWriter,
    kind: int,
    rid: int,
    tag: int,
    body: bytes,
    session: Session | None = None,
    counters: WireCounters | None = None,
    lane: int = 0,
) -> None:
    # Two writes instead of one concatenated buffer: batch frames are large
    # (hundreds of KB) and the header+body copy showed up at high rates.
    # On authenticated connections the body is AEAD-sealed (AES-GCM,
    # counter nonce, header as AAD); seal+write happen without an await in
    # between so the nonce sequence matches the wire order.
    if session is not None:
        ct = session.seal_body(kind, rid, tag, body, lane)
        writer.write(_FRAME_HDR.pack(len(ct), kind, rid, tag, lane))
        writer.write(ct)
        wire_len = _FRAME_HDR.size + len(ct)
    else:
        writer.write(_FRAME_HDR.pack(len(body), kind, rid, tag, lane))
        if body:
            writer.write(body)
        wire_len = _FRAME_HDR.size + len(body)
    WireStats.frames_sent += 1
    WireStats.bytes_sent += wire_len
    if counters is not None:
        counters.record_sent(tag, wire_len, lane)


class _FrameBuffer:
    """Write-capture shim for FrameSender's inline fast path: collects the
    header/body writes `_write_frame` emits so a whole burst can reach the
    transport as one buffer."""

    __slots__ = ("parts",)

    def __init__(self) -> None:
        self.parts: list[bytes] = []

    def write(self, data: bytes) -> None:
        self.parts.append(data)


async def _read_frame(
    reader: asyncio.StreamReader,
    session: Session | None = None,
    counters: WireCounters | None = None,
) -> tuple[int, int, int, int, bytes]:
    hdr = await reader.readexactly(_FRAME_HDR.size)
    length, kind, rid, tag, lane = _FRAME_HDR.unpack(hdr)
    if length > MAX_FRAME:
        raise RpcError(f"frame of {length} bytes exceeds cap")
    body = await reader.readexactly(length) if length else b""
    WireStats.frames_received += 1
    WireStats.bytes_received += _FRAME_HDR.size + length
    if counters is not None:
        counters.record_received(tag, _FRAME_HDR.size + length, lane)
    if session is not None:
        if length < MAC_LEN:
            raise RpcError("unauthenticated frame on authenticated connection")
        body = session.open_body(kind, rid, tag, body, lane)  # AuthError on forgery
    return kind, rid, tag, lane, body


class FrameSender:
    """Per-connection write coalescer with PER-LANE flow control: frames
    enqueue synchronously into their lane's queue; a single drainer task
    interleaves the lane queues ROUND-ROBIN (one frame per non-empty lane
    per pass) and packs the interleaved burst into `writer.write` calls
    followed by ONE `drain()`. Nagle without the delay — nothing ever waits
    for more traffic, but whatever is already pending when the socket
    flushes shares that flush, so an N-frame burst (a broadcast fan-in, a
    server's concurrent responses) costs one syscall round-trip instead
    of N.

    The round-robin is the pool's fairness mechanism: on a multiplexed
    connection, a saturated bulk lane (a worker's batch relay backlog)
    cannot starve a latency-critical lane (the primary's votes) — a vote
    enqueued behind 50 queued batch frames departs after at most one frame
    per OTHER lane, not after the whole backlog. Fairness is per-frame
    (frames are never fragmented), so the worst-case holdup is one maximum-
    size in-flight frame per competing lane.

    AEAD sealing happens at WRITE time in interleaved order, so the
    session's counter-nonce sequence always matches the wire order (the
    invariant `_write_frame` documents). Post-handshake, a connection's
    frames MUST all go through its sender — a second writer would fork the
    nonce sequence.

    Queue depth is bounded by the callers: client requests are capped by
    their own timeouts/retry handles, server responses by the per-
    connection dispatch semaphore (MAX_TASK_CONCURRENCY).

    Transports whose writers advertise `sync_drain` (the simnet fabric's
    duck-typed writer: no kernel buffer, drain() is a no-op) take an
    inline fast path instead: frames are packed and written synchronously
    from send(), one fabric transmit per drain, NO drainer task at all.
    Under a co-hosted simulation that removes one ensure_future + wakeup
    per write burst — a first-order term of the profiled loop churn."""

    __slots__ = (
        "_writer",
        "_session",
        "_on_error",
        "_queues",
        "_depth",
        "_task",
        "_closed",
        "_counters",
        "_inline",
    )

    def __init__(
        self,
        writer: asyncio.StreamWriter,
        session: Session | None = None,
        on_error: Callable[[Exception], None] | None = None,
        counters: WireCounters | None = None,
    ):
        self._writer = writer
        self._session = session
        self._on_error = on_error
        self._counters = counters
        # lane -> FIFO of (kind, rid, tag, body). Insertion-ordered dict:
        # the round-robin cycles lanes in first-traffic order, which is
        # deterministic under the seeded simnet schedule.
        self._queues: dict[int, list[tuple[int, int, int, bytes]]] = {}
        self._depth = 0
        self._task: asyncio.Task | None = None
        self._closed = False
        self._inline = bool(getattr(writer, "sync_drain", False))

    def send(
        self, kind: int, rid: int, tag: int, body: bytes, lane: int = 0
    ) -> None:
        """Enqueue one frame (never blocks). Raises RpcError if the
        transport already failed."""
        if self._closed:
            raise RpcError("connection closed")
        queue = self._queues.get(lane)
        if queue is None:
            queue = self._queues[lane] = []
        queue.append((kind, rid, tag, body))
        self._depth += 1
        if self._inline:
            self._drain_inline()
        elif self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._drain_loop())

    def _take_interleaved(self) -> list[tuple[int, int, int, int, bytes]]:
        """Snapshot and clear the lane queues as ONE round-robin-interleaved
        batch: pass k takes the k-th frame of every lane that still has
        one. Single-lane connections (the common legacy case) reduce to the
        old FIFO order with no extra copying beyond the append loop."""
        queues = [
            (lane, q) for lane, q in self._queues.items() if q
        ]
        if not queues:
            return []
        if len(queues) == 1:
            lane, q = queues[0]
            self._queues[lane] = []
            self._depth = 0
            return [(kind, rid, tag, lane, body) for kind, rid, tag, body in q]
        batch: list[tuple[int, int, int, int, bytes]] = []
        depth = max(len(q) for _, q in queues)
        for k in range(depth):
            for lane, q in queues:
                if k < len(q):
                    kind, rid, tag, body = q[k]
                    batch.append((kind, rid, tag, lane, body))
        for lane, _ in queues:
            self._queues[lane] = []
        self._depth = 0
        return batch

    def _drain_inline(self) -> None:
        """Synchronous drain for no-buffer transports: seal in interleaved
        order (same nonce invariant as the task path) and hand the packed
        burst to the writer as ONE write."""
        try:
            while self._depth:
                batch = self._take_interleaved()
                buf = _FrameBuffer()
                for kind, rid, tag, lane, body in batch:
                    _write_frame(
                        buf, kind, rid, tag, body, self._session,
                        self._counters, lane,
                    )
                WireStats.record_drain(len(batch))
                # _FrameBuffer is a per-drain local scratch buffer: created,
                # filled and read inside this one call frame (creator
                # pattern) — the class is shared, the instance never is.
                parts = buf.parts  # lint: allow(multi-task-mutation)
                self._writer.write(
                    parts[0] if len(parts) == 1 else b"".join(parts)
                )
        except (ConnectionError, OSError) as e:
            self._closed = True
            self._queues.clear()
            self._depth = 0
            if self._on_error is not None:
                self._on_error(e)

    async def _drain_loop(self) -> None:
        try:
            while self._depth:
                batch = self._take_interleaved()
                for kind, rid, tag, lane, body in batch:
                    _write_frame(
                        self._writer, kind, rid, tag, body, self._session,
                        self._counters, lane,
                    )
                WireStats.record_drain(len(batch))
                # Frames enqueued while this drain awaits ride the next
                # iteration — one flush each for whatever coalesced.
                await self._writer.drain()
        except (ConnectionError, OSError) as e:
            self._closed = True
            # Connection is dead: frames enqueued during the failed drain
            # are deliberately dropped with it (there is nowhere to send
            # them) — losing a concurrent enqueue here is the semantics.
            self._queues.clear()  # lint: allow(await-interleaved-rmw)
            self._depth = 0  # lint: allow(await-interleaved-rmw)
            if self._on_error is not None:
                self._on_error(e)

    def close(self) -> None:
        self._closed = True
        self._queues.clear()
        self._depth = 0
        if self._task is not None and not self._task.done():
            self._task.cancel()


class PeerClient:
    """Persistent connection to one peer address with request/response
    correlation and lazy reconnect. With credentials + an expected key the
    connection is mutually authenticated before any request flows."""

    def __init__(
        self,
        address: str,
        credentials: Credentials | None = None,
        counters: WireCounters | None = None,
    ):
        self.address = address
        self._credentials = credentials
        self._counters = counters
        self._writer: asyncio.StreamWriter | None = None
        self._sender: FrameSender | None = None
        self._reader_task: asyncio.Task | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._rid = itertools.count(1)
        self._lock = asyncio.Lock()
        self._session: Session | None = None

    async def _connect(self) -> None:
        async with self._lock:
            if self._writer is not None:
                return
            host, port = self.address.rsplit(":", 1)
            # Through the transport seam: real TCP normally, the simnet
            # in-memory fabric when one is installed (simnet/fabric.py).
            reader, writer = await transport.open_connection(
                host, int(port), limit=MAX_FRAME + 1024
            )
            # Resolve the expected identity at connect time so reconnects
            # after an epoch change see the current committee's keys.
            expected_key = (
                self._credentials.resolve(self.address)
                if self._credentials is not None
                else None
            )
            session = None
            if self._credentials is not None and expected_key is not None:
                try:
                    session = await client_handshake(
                        reader,
                        writer,
                        self._credentials,
                        expected_key,
                        _read_frame,
                        _write_frame,
                    )
                except (AuthError, asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
                    writer.close()
                    raise RpcError(f"handshake with {self.address} failed: {e}") from e
            self._session = session
            # The whole connect sequence is serialized by self._lock (with
            # an early return when another task won the race), so this
            # check-then-act cannot interleave with a second connect.
            self._writer = writer  # lint: allow(await-interleaved-rmw)
            self._sender = FrameSender(
                writer,
                session,
                on_error=lambda e: self._teardown(
                    RpcError(f"send to {self.address} failed: {e}")
                ),
                counters=self._counters,
            )
            self._reader_task = asyncio.ensure_future(self._read_loop(reader, session))

    async def _read_loop(
        self, reader: asyncio.StreamReader, session: Session | None
    ) -> None:
        try:
            while True:
                # Legacy single-lane connection: the lane byte is read (and
                # AAD-verified) but carries no routing — everything is lane 0.
                kind, rid, tag, _lane, body = await _read_frame(
                    reader, session, self._counters
                )
                if kind == KIND_HELLO and session is None:
                    # The server demands a handshake we are not configured
                    # for: fail every pending request immediately instead of
                    # letting them time out one by one.
                    logger.warning(
                        "%s requires an authenticated handshake but this "
                        "client has no credentials for it",
                        self.address,
                    )
                    self._teardown(
                        RpcError(
                            f"{self.address} requires an authenticated "
                            "handshake (no credentials resolve this address)"
                        )
                    )
                    return
                fut = self._pending.pop(rid, None)
                if fut is None or fut.done():
                    continue
                if kind == KIND_RESP:
                    try:
                        fut.set_result(decode_message(tag, body))
                    except Exception as e:  # decode error
                        fut.set_exception(RpcError(str(e)))
                elif kind == KIND_ERR:
                    fut.set_exception(RpcError(body.decode(errors="replace")))
        except (asyncio.IncompleteReadError, ConnectionError, OSError, RpcError, AuthError) as e:
            logger.debug("connection to %s lost: %r", self.address, e)
        finally:
            self._teardown(RpcError(f"connection to {self.address} lost"))

    def _teardown(self, exc: Exception) -> None:
        if self._sender is not None:
            self._sender.close()
        self._sender = None
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:  # lint: allow(no-silent-except)
                pass  # best-effort close of an already-failed transport
        self._writer = None
        # Cancel the read loop unless teardown IS the read loop's own
        # finally: on a half-open transport (peer gone silently, no EOF
        # delivered) the reader would otherwise survive close() parked in
        # _read_frame forever — the dropped-handle shutdown-wedge class.
        reader_task, self._reader_task = self._reader_task, None
        if reader_task is not None and not reader_task.done():
            try:
                current = asyncio.current_task()
            except RuntimeError:
                current = None
            if reader_task is not current:
                reader_task.cancel()
        self._session = None
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)

    async def request(self, msg, timeout: float | None = 10.0):
        """Send a request frame, await the peer's response (Ack for oneway
        handlers). Raises RpcError/OSError on transport failure.

        The frame goes through the connection's FrameSender: concurrent
        requests on one link (a broadcast burst, QuorumWaiter fan-out)
        share a single socket flush instead of awaiting one drain() each;
        transport failures surface through the pending future (the sender's
        on_error tears the connection down, failing every in-flight rid)."""
        if self._sender is None:
            await self._connect()
        rid = next(self._rid)
        tag, body = encode_message(msg)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            self._sender.send(KIND_REQ, rid, tag, body)
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            # Before the OSError clause: since Python 3.11 asyncio's
            # TimeoutError IS the builtin TimeoutError, an OSError subclass,
            # so a deadline miss caught there would tear a live connection
            # down and surface as a plain RpcError, and reliable send would
            # never escalate its deadline (RpcTimeout's contract).
            self._pending.pop(rid, None)
            raise RpcTimeout(f"request to {self.address} timed out")
        except (ConnectionError, OSError) as e:
            # Register/await/cleanup idiom: each task pops only the rid it
            # registered itself — concurrent requests touch disjoint keys.
            self._pending.pop(rid, None)  # lint: allow(await-interleaved-rmw)
            self._teardown(RpcError(str(e)))
            raise RpcError(f"send to {self.address} failed: {e}") from e
        except RpcError:
            self._pending.pop(rid, None)
            raise

    async def oneway(self, msg) -> None:
        """Enqueue a fire-and-forget frame (KIND_ONEWAY): no response, no
        rid, no retry. The frame rides the same FrameSender (coalesced
        writes, in-order AEAD sealing); a torn connection surfaces as
        RpcError/OSError from the connect, and silently dropped frames are
        the CALLER's contract — only use this where an application-level
        mechanism (relay fallback) already guarantees delivery."""
        if self._sender is None:
            await self._connect()
        tag, body = encode_message(msg)
        try:
            self._sender.send(KIND_ONEWAY, 0, tag, body)
        except (ConnectionError, OSError) as e:
            self._teardown(RpcError(str(e)))
            raise RpcError(f"send to {self.address} failed: {e}") from e

    def close(self) -> None:
        self._teardown(RpcError("client closed"))


# Post-handshake marker frame a pool dialer sends as the FIRST frame of a
# new connection (KIND_HELLO is unused after the handshake): it tells the
# accepting server "this is a multiplexed pool link — adopt it for your own
# outbound traffic too". A server without a pool (knob off, old deployment)
# simply ignores the frame and serves the connection as a legacy single-lane
# client, so mixed-knob committees degrade gracefully instead of breaking.
POOL_HELLO = b"pool-link/1"


class PeerLink:
    """One multiplexed, BIDIRECTIONAL authenticated connection to a peer
    node: every lane of the node pair (primary plane + each worker plane)
    shares this socket, and BOTH endpoints issue requests over it — each
    side keeps its own rid namespace, and the frame `kind` disambiguates
    direction (REQ/ONEWAY frames are the remote's calls into our lanes,
    RESP/ERR are answers to ours).

    A link never dials: the pool (network/pool.py) owns connection
    establishment, the crossed-dial survivor rule, reconnect, and lane
    dispatch. The link owns one live socket: the demux read loop, the
    pending-rid table for outbound requests, the per-connection dispatch
    semaphore for inbound ones, and teardown (which fails every in-flight
    rid so the caller's retry path — NetworkClient.send — re-acquires a
    fresh link from the pool: the in-flight retry handoff)."""

    __slots__ = (
        "pool",
        "peer_pk",
        "address",
        "peer",
        "dialed",
        "closed",
        "_writer",
        "_session",
        "_counters",
        "_sender",
        "_pending",
        "_rid",
        "_read_task",
        "_sem",
        "_tasks",
    )

    def __init__(
        self,
        pool,
        peer_pk,
        address: str,
        writer: asyncio.StreamWriter,
        session: Session | None,
        counters: WireCounters | None = None,
        dialed: bool = True,
        sender: FrameSender | None = None,
    ):
        self.pool = pool
        self.peer_pk = peer_pk
        self.address = address
        self.peer = Peer(address, peer_pk)
        self.dialed = dialed
        self.closed = False
        self._writer = writer
        self._session = session
        self._counters = counters
        # The adopted (server) side reuses the sender _on_connection already
        # created for this writer — a second FrameSender on one writer would
        # fork the AEAD nonce sequence.
        self._sender = sender or FrameSender(
            writer,
            session,
            on_error=lambda e: self._teardown(
                RpcError(f"send on pooled link to {self.address} failed: {e}")
            ),
            counters=counters,
        )
        self._pending: dict[int, asyncio.Future] = {}
        self._rid = itertools.count(1)
        self._read_task: asyncio.Task | None = None
        self._sem = asyncio.Semaphore(MAX_TASK_CONCURRENCY)
        self._tasks: set[asyncio.Task] = set()

    @property
    def sender(self) -> FrameSender:
        """The link's single FrameSender — lane servers write their
        responses through it (one writer per connection: the nonce-order
        invariant)."""
        return self._sender

    def start(self, reader: asyncio.StreamReader) -> None:
        """Dialed side: spawn the demux loop as a background task. (The
        adopted side awaits run() directly from _on_connection so the
        connection's lifetime stays tied to the accept task.)"""
        self._read_task = asyncio.ensure_future(self.run(reader))

    def send_pool_hello(self) -> None:
        self._sender.send(KIND_HELLO, 0, 0, POOL_HELLO)

    async def run(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                kind, rid, tag, lane, body = await _read_frame(
                    reader, self._session, self._counters
                )
                if kind == KIND_REQ or kind == KIND_ONEWAY:
                    # Inbound call into one of our lanes: same bounded
                    # concurrency model as RpcServer._on_connection.
                    await self._sem.acquire()
                    t = asyncio.ensure_future(
                        self.pool.dispatch(
                            self, lane, rid, tag, body,
                            oneway=kind == KIND_ONEWAY,
                        )
                    )
                    self._tasks.add(t)
                    t.add_done_callback(
                        lambda t_: (self._tasks.discard(t_), self._sem.release())
                    )
                    continue
                fut = self._pending.pop(rid, None)
                if fut is None or fut.done():
                    continue
                if kind == KIND_RESP:
                    try:
                        fut.set_result(decode_message(tag, body))
                    except Exception as e:  # decode error
                        fut.set_exception(RpcError(str(e)))
                elif kind == KIND_ERR:
                    if body == LANE_UNAVAILABLE:
                        fut.set_exception(
                            RpcLaneUnavailable(
                                f"{self.address} does not co-host the lane"
                            )
                        )
                    else:
                        fut.set_exception(RpcError(body.decode(errors="replace")))
        except (asyncio.IncompleteReadError, ConnectionError, OSError, RpcError, AuthError) as e:
            logger.debug("pooled link to %s lost: %r", self.address, e)
        finally:
            self._teardown(RpcError(f"pooled link to {self.address} lost"))

    def respond(self, kind: int, rid: int, tag: int, body: bytes, lane: int) -> None:
        """Write one response frame on behalf of a lane server (same-lane
        response: the reply rides the queue of the lane it answers)."""
        self._sender.send(kind, rid, tag, body, lane)

    async def request(self, msg, lane: int, timeout: float | None = 10.0):
        """Send a request frame on `lane`, await the peer's response.
        Raises RpcLaneUnavailable when the peer answers that the lane's
        role is not co-hosted behind this connection (split deployment)."""
        if self.closed:
            raise RpcError(f"pooled link to {self.address} closed")
        rid = next(self._rid)
        tag, body = encode_message(msg)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            self._sender.send(KIND_REQ, rid, tag, body, lane)
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            # Before the OSError clause: since Python 3.11 asyncio's
            # TimeoutError IS the builtin TimeoutError, an OSError subclass,
            # so a deadline miss caught there would tear a live connection
            # down and surface as a plain RpcError, and reliable send would
            # never escalate its deadline (RpcTimeout's contract).
            self._pending.pop(rid, None)
            raise RpcTimeout(f"request to {self.address} (lane {lane}) timed out")
        except (ConnectionError, OSError) as e:
            # Register/await/cleanup idiom: each task pops only the rid it
            # registered itself — concurrent requests touch disjoint keys.
            self._pending.pop(rid, None)  # lint: allow(await-interleaved-rmw)
            self._teardown(RpcError(str(e)))
            raise RpcError(f"send to {self.address} failed: {e}") from e
        except RpcError:
            self._pending.pop(rid, None)
            raise

    async def oneway(self, msg, lane: int) -> None:
        """Fire-and-forget frame on `lane` (same caller contract as
        PeerClient.oneway: delivery is the application's problem)."""
        if self.closed:
            raise RpcError(f"pooled link to {self.address} closed")
        tag, body = encode_message(msg)
        try:
            self._sender.send(KIND_ONEWAY, 0, tag, body, lane)
        except (ConnectionError, OSError) as e:
            self._teardown(RpcError(str(e)))
            raise RpcError(f"send to {self.address} failed: {e}") from e

    def _teardown(self, exc: Exception) -> None:
        if self.closed:
            return
        self.closed = True
        self._sender.close()
        try:
            self._writer.close()
        except Exception:  # lint: allow(no-silent-except)
            pass  # best-effort close of an already-failed transport
        read_task, self._read_task = self._read_task, None
        if read_task is not None and not read_task.done():
            try:
                current = asyncio.current_task()
            except RuntimeError:
                current = None
            if read_task is not current:
                read_task.cancel()
        for t in list(self._tasks):
            t.cancel()
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)
        # Deregister LAST: once the pool forgets this link, the next
        # link_for() dials fresh — pending rids are already failed, so the
        # caller's retry lands on the new connection, never this one.
        self.pool.discard(self)

    def close(self) -> None:
        self._teardown(RpcError(f"pooled link to {self.address} closed"))


Handler = Callable[[object, Peer], Awaitable[object | None]]


def ALLOW_ANY(peer: "Peer") -> bool:
    """Explicit opt-out of route-level authorization on an authenticated
    server: any handshake-verified peer may call the route."""
    return True


class RpcServer:
    """Listens for peers and dispatches requests to handlers by message tag.

    Handlers receive (message, Peer) and return a response message or
    None (=> Ack). Handler exceptions become ERR frames, like anemo's status
    responses. Concurrency is bounded per connection.

    With `auth_keypair` set the server requires the mutual handshake on
    every connection (the anemo PeerId model): unauthenticated sockets never
    reach a handler, and routes may further restrict the verified identity
    with an `allow(peer)` predicate — the reference rejects unknown peers at
    the network layer (network/src/p2p.rs:26-158)."""

    def __init__(
        self,
        max_concurrency: int = MAX_TASK_CONCURRENCY,
        auth_keypair=None,
        counters: WireCounters | None = None,
        pool=None,
        dedup_cache_bytes: int = 32 << 20,
    ):
        self._handlers: dict[
            int, tuple[Handler, Callable[[Peer], bool] | None, Handler | None]
        ] = {}
        self._server: asyncio.AbstractServer | None = None
        self._max_concurrency = max_concurrency
        self._writers: set[asyncio.StreamWriter] = set()
        self._auth_keypair = auth_keypair
        self._counters = counters
        # The node's LanePool, set only on the LISTENER server (the primary's,
        # bound at the pooled address): connections whose first frame is the
        # POOL_HELLO marker are adopted into it as bidirectional PeerLinks.
        self._pool = pool
        self._dedup_cache_bytes = dedup_cache_bytes
        self._dedup: BoundedCache | None = None

    def route(self, msg_cls, handler: Handler, allow=None, dedup=None) -> None:
        # Deny-by-default on authenticated servers: the handshake only proves
        # the peer holds *a* key, not that the key is known to the committee
        # (the reference rejects unknown peers at the network layer via
        # anemo's known-peers set). A route registered without an identity
        # predicate would silently be world-open, so require one — ALLOW_ANY
        # documents a deliberate opt-out.
        if self._auth_keypair is not None and allow is None:
            raise ValueError(
                f"route {msg_cls.__name__}: authenticated servers are "
                "deny-by-default; pass allow= (or ALLOW_ANY to open the "
                "route to any handshake-verified peer)"
            )
        # `dedup` opts the route into digest-keyed duplicate suppression:
        # when an identical body (same tag, same bytes) arrives again while
        # still in the bounded cache, the codec decode and the full handler
        # are SKIPPED and `dedup(first_decoded_msg, peer)` runs instead —
        # the cheap bookkeeping path (ack the sender, note the extra copy)
        # for fan-out planes where every committee member relays the same
        # payload N-1 times (RelayMsg/Relay2Msg). The authorization
        # predicate still runs per copy.
        if dedup is not None and self._dedup is None:
            self._dedup = BoundedCache(max_bytes=self._dedup_cache_bytes)
        self._handlers[msg_cls.TAG] = (handler, allow, dedup)

    async def start(self, host: str, port: int) -> int:
        # Simnet path first: the fabric owns the whole address namespace
        # (no real ports, no placeholders, no fd budget) — every frame this
        # server reads still goes through the same handshake/AEAD/dispatch
        # code below, just over in-memory streams.
        fabric = transport.active()
        if fabric is not None:
            self._server = await fabric.start_server(
                self._on_connection, host, port, limit=MAX_FRAME + 1024
            )
            return self._server.sockets[0].getsockname()[1]
        # reuse_port lets the bind coexist with the allocator's SO_REUSEPORT
        # placeholder (config.get_available_port), which reserves
        # pre-assigned ports against ephemeral collisions; the placeholder
        # never listens, so all connections land here. But blanket
        # reuse_port would also let two misconfigured servers (duplicate
        # addresses in a committee file, the same node started twice)
        # silently co-bind and nondeterministically split connections — so
        # only co-bind ports that are actually known to be placeheld:
        # either by this process's allocator, or by a harness parent that
        # assigned our ports and advertises its placeholders via
        # NARWHAL_PLACEHELD_PORTS ("all" or a comma-separated list). Any
        # other duplicate fails fast with EADDRINUSE.
        from ..config import port_is_placeheld

        reuse = port != 0 and port_is_placeheld(port)
        # A pre-assigned port can transiently collide (TIME_WAIT, an
        # ephemeral outbound connection): retry briefly before giving up.
        for attempt in range(5):
            try:
                self._server = await asyncio.start_server(
                    self._on_connection, host, port, limit=MAX_FRAME + 1024,
                    reuse_port=reuse,
                )
                break
            except OSError:
                if attempt == 4:
                    raise
                await asyncio.sleep(0.2 * (attempt + 1))
        bound = self._server.sockets[0].getsockname()[1]
        # The allocator's placeholder has done its job once we hold the
        # listening socket; dropping it returns the fd (a long-lived
        # process building many clusters would otherwise hold up to a
        # window's worth of placeholder fds against the ulimit). Marking
        # the port bound also strikes it from any parent's spawn-time
        # NARWHAL_PLACEHELD_PORTS advertisement, so a second server on the
        # same port in this process fails fast instead of co-binding.
        from ..config import mark_port_bound, release_port

        release_port(bound)
        mark_port_bound(bound)
        return bound

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peername = writer.get_extra_info("peername")
        peer_addr = f"{peername[0]}:{peername[1]}" if peername else "?"
        peer = Peer(peer_addr)
        self._writers.add(writer)
        sem = asyncio.Semaphore(self._max_concurrency)
        tasks: set[asyncio.Task] = set()
        session: Session | None = None
        sender: FrameSender | None = None
        try:
            if self._auth_keypair is not None:
                try:
                    # Written once here, before the pool/dispatch tasks that
                    # read it can exist (adoption happens frames later).
                    peer.key, session = await server_handshake(  # lint: allow(multi-task-mutation)
                        reader, writer, self._auth_keypair, _read_frame, _write_frame
                    )
                except (AuthError, asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
                    logger.debug("Rejected unauthenticated peer %s: %s", peer_addr, e)
                    return
            # Responses coalesce per connection: concurrent handlers that
            # complete in the same window share one socket flush.
            sender = FrameSender(writer, session, counters=self._counters)
            first = True
            while True:
                kind, rid, tag, lane, body = await _read_frame(
                    reader, session, self._counters
                )
                if (
                    first
                    and kind == KIND_HELLO
                    and body == POOL_HELLO
                    and self._pool is not None
                    and peer.key is not None
                ):
                    # Pool dialer announcing itself (always its first frame,
                    # so this sender has written nothing yet and can be
                    # handed to the link without forking the nonce stream).
                    # adopt() returns the link's demux loop coroutine — or
                    # None if the peer key is unknown to the pool — and we
                    # await it HERE so the connection's lifetime stays tied
                    # to this accept task.
                    link_run = self._pool.adopt(peer, reader, writer, session, sender)
                    if link_run is not None:
                        sender = None  # the link owns teardown now
                        await link_run
                        return
                first = False
                if kind != KIND_REQ and kind != KIND_ONEWAY:
                    continue
                if lane != LANE_PRIMARY:
                    # Non-adopted connections reach exactly one role — the
                    # one that bound this address — so a lane-routed frame
                    # here means the remote pooled to a server whose pool is
                    # off (mixed-knob committee). Tell it to fall back to a
                    # direct connection instead of dispatching to the wrong
                    # handler table.
                    if kind == KIND_REQ:
                        sender.send(KIND_ERR, rid, 0, LANE_UNAVAILABLE, lane)
                    continue
                await sem.acquire()
                t = asyncio.ensure_future(
                    self._dispatch(
                        sender, rid, tag, body, peer, oneway=kind == KIND_ONEWAY
                    )
                )
                tasks.add(t)
                t.add_done_callback(lambda t_: (tasks.discard(t_), sem.release()))
        except (asyncio.IncompleteReadError, ConnectionError, OSError, RpcError, AuthError) as e:
            logger.debug("peer %s disconnected: %r", peer_addr, e)
        finally:
            # Each connection task discards only its own writer (added once
            # at accept): concurrent connections touch disjoint elements.
            self._writers.discard(writer)  # lint: allow(await-interleaved-rmw)
            if sender is not None:
                sender.close()
            for t in tasks:
                t.cancel()
            try:
                writer.close()
            except Exception:  # lint: allow(no-silent-except)
                pass  # best-effort close of an already-failed transport

    async def dispatch_frame(
        self,
        sender: FrameSender,
        rid: int,
        tag: int,
        body: bytes,
        peer: Peer,
        oneway: bool,
        lane: int,
    ) -> None:
        """Pool entry point: dispatch one frame that arrived on a
        multiplexed PeerLink into this lane server's handler table. The
        response (if any) is written back on the SAME lane so replies ride
        the queue of the plane they answer."""
        await self._dispatch(sender, rid, tag, body, peer, oneway=oneway, lane=lane)

    async def _dispatch(
        self,
        sender: FrameSender,
        rid: int,
        tag: int,
        body: bytes,
        peer: Peer,
        oneway: bool = False,
        lane: int = LANE_PRIMARY,
    ) -> None:
        try:
            entry = self._handlers.get(tag)
            if entry is None:
                raise RpcError(f"no handler for tag {tag}")
            handler, allow, dedup = entry
            if allow is not None and not allow(peer):
                raise RpcError(f"unauthorized peer for tag {tag}")
            if dedup is not None:
                # Digest-keyed duplicate shortcut, keyed on the RAW body so
                # the duplicate never reaches the codec: in the relay fan-out
                # every committee member forwards the same payload, so all
                # but the first arrival pay only a blake2b over bytes already
                # in cache-warm memory plus the route's bookkeeping handler.
                key = (tag, hashlib.blake2b(body, digest_size=16).digest())
                cached = self._dedup.get(key)
                if cached is not None:
                    resp = await dedup(cached, peer)
                else:
                    msg = decode_message(tag, body)
                    # First write wins in BoundedCache, so a concurrent
                    # decode of the same body settles on one canonical
                    # message object; weight tracks the encoded size the
                    # entry is standing in for.
                    self._dedup.put(key, msg, weight=len(body) + 64)
                    resp = await handler(msg, peer)
            else:
                msg = decode_message(tag, body)
                resp = await handler(msg, peer)
            if oneway:
                # Fire-and-forget frame: the handler ran, nothing to write
                # back (any returned value is discarded by contract).
                return
            if resp is None:
                resp = Ack()
            rtag, rbody = encode_message(resp)
            out = (KIND_RESP, rid, rtag, rbody)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # The peer sees the failure as an ERR frame; keep local
            # visibility too — a handler bug otherwise only surfaces as
            # remote retry noise.
            logger.debug("handler for tag %d raised: %r", tag, e)
            if oneway:
                return
            out = (KIND_ERR, rid, 0, str(e).encode())
        try:
            sender.send(*out, lane)
        except RpcError as e:
            logger.debug("response to %s dropped (peer gone): %r", peer.addr, e)

    async def stop(self) -> None:
        if self._server is not None:
            try:
                bound = self._server.sockets[0].getsockname()[1]
            except (IndexError, OSError):
                bound = None
            self._server.close()
            # Drop live connections: wait_closed() (3.12+) waits for every
            # connection handler, which would otherwise run until the peer
            # hangs up.
            for w in list(self._writers):
                try:
                    w.close()
                except Exception:  # lint: allow(no-silent-except)
                    pass  # best-effort close during server stop
            await self._server.wait_closed()
            if bound is not None:
                # A later bind of this port (node restart) may again
                # co-bind through a parent's still-live placeholder.
                from ..config import mark_port_unbound

                mark_port_unbound(bound)


class _PooledPeer:
    """PeerClient-shaped facade over a pooled lane: request/oneway acquire
    the live PeerLink for the peer NODE from the pool (dialing or waiting
    out a reconnect as needed) and tag frames with this peer's lane.

    If the pooled endpoint ever answers RpcLaneUnavailable — the lane's
    role is not co-hosted behind the pooled address (split primary/worker
    deployment) — the facade permanently falls back to a direct legacy
    connection to the role's own address; the pool only ever multiplexes
    what is actually behind one process."""

    __slots__ = ("_pool", "_peer_pk", "_lane", "address", "_credentials", "_counters", "_legacy")

    def __init__(self, pool, peer_pk, lane, address, credentials, counters):
        self._pool = pool
        self._peer_pk = peer_pk
        self._lane = lane
        self.address = address
        self._credentials = credentials
        self._counters = counters
        self._legacy: PeerClient | None = None

    def _fall_back(self) -> PeerClient:
        logger.info(
            "pooled endpoint for %s does not co-host lane %d; "
            "falling back to a direct connection",
            self.address,
            self._lane,
        )
        self._legacy = PeerClient(self.address, self._credentials, self._counters)
        return self._legacy

    async def request(self, msg, timeout: float | None = 10.0):
        if self._legacy is not None:
            return await self._legacy.request(msg, timeout)
        try:
            link = await self._pool.link_for(self._peer_pk)
            return await link.request(msg, self._lane, timeout)
        except RpcLaneUnavailable:
            return await self._fall_back().request(msg, timeout)

    async def oneway(self, msg) -> None:
        if self._legacy is not None:
            return await self._legacy.oneway(msg)
        # A oneway to a non-co-hosted lane is logged and dropped by the
        # remote (no response frame exists to carry the lane error); the
        # first REQUEST on this lane flips the facade to the legacy path.
        link = await self._pool.link_for(self._peer_pk)
        await link.oneway(msg, self._lane)

    def close(self) -> None:
        # The pool owns its links' lifecycles; only a fallback is ours.
        if self._legacy is not None:
            self._legacy.close()


class NetworkClient:
    """The P2pNetwork facade (narwhal/network/src/p2p.rs:26-158):
    cached per-peer clients + the three send policies. With credentials,
    every connection to an address the committee/worker-cache knows is
    mutually authenticated; unknown addresses (public endpoints) connect
    plain. With a LanePool, addresses the pool can place (a committee
    role of a known node) route over the node pair's ONE multiplexed
    connection instead of a dedicated socket."""

    def __init__(
        self,
        retry: RetryConfig | None = None,
        credentials: Credentials | None = None,
        counters: WireCounters | None = None,
        pool=None,
    ):
        self._peers: dict[str, PeerClient | _PooledPeer] = {}
        self._retry = retry or RetryConfig(max_elapsed=None)
        self._send_tasks: set[asyncio.Task] = set()
        self._credentials = credentials
        self._counters = counters
        self._pool = pool

    def attach_pool(self, pool) -> None:
        """Late pool attachment for assemblies whose pool is created after
        this client (a Worker joining the node pool at spawn). Only
        addresses resolved AFTER attachment route through the pool."""
        self._pool = pool

    def peer(self, address: str) -> PeerClient | _PooledPeer:
        client = self._peers.get(address)
        if client is None:
            if self._pool is not None:
                target = self._pool.lookup(address)
                if target is not None:
                    peer_pk, lane = target
                    client = _PooledPeer(
                        self._pool, peer_pk, lane, address,
                        self._credentials, self._counters,
                    )
            if client is None:
                client = PeerClient(address, self._credentials, self._counters)
            self._peers[address] = client
        return client

    async def request(self, address: str, msg, timeout: float | None = 10.0):
        """One attempt RPC with a typed response."""
        return await self.peer(address).request(msg, timeout)

    async def unreliable_send(self, address: str, msg, timeout: float | None = 5.0) -> bool:
        """Fire once; True iff delivered+acked (UnreliableNetwork,
        traits.rs:10-40)."""
        try:
            await self.peer(address).request(msg, timeout)
            return True
        except (RpcError, OSError):
            return False

    async def oneway_send(self, address: str, msg) -> bool:
        """Fire-and-forget: one KIND_ONEWAY frame, no response awaited, no
        retry. True iff the frame was enqueued on a live connection. For
        lanes with their own application-level delivery guarantee (the
        relay plane's origin fallback) — a lost frame there costs one
        fallback direct send, never correctness."""
        try:
            await self.peer(address).oneway(msg)
            return True
        except (RpcError, OSError):
            return False

    def send(self, address: str, msg, timeout: float | None = 10.0) -> CancelOnDrop:
        """Reliable send: background task retrying forever with backoff until
        the peer acks; returns a cancellable handle whose await yields True
        (ReliableNetwork, traits.rs:42-94 + p2p.rs:37-41)."""

        async def attempt_forever():
            delays = self._retry.delays()
            attempt_timeout = timeout
            while True:
                try:
                    await self.peer(address).request(msg, attempt_timeout)
                    return True
                except (RpcError, OSError) as e:
                    timed_out = isinstance(e, (RpcTimeout, asyncio.TimeoutError))
                    try:
                        delay = next(delays)
                    except StopIteration:
                        raise RpcError(f"retries to {address} exhausted: {e}") from e
                    await asyncio.sleep(delay)
                    if attempt_timeout is None:
                        continue
                    if timed_out:
                        # A deadline miss on a loaded host usually means
                        # the peer is SLOW, not gone — resending on a fixed
                        # deadline re-executes the handler and multiplies
                        # load (the JAX package measured ~300k frames per
                        # committed round at N=50, mostly retries). Escalate the
                        # per-attempt deadline so a slow-but-alive peer is
                        # retried into success, not congestion collapse.
                        attempt_timeout = min(attempt_timeout * 2.0, timeout * 8.0)
                    else:
                        # Connection-refused and friends fail instantly:
                        # they say nothing about the peer's SPEED, so a
                        # burst of them (node restarting) must not leave
                        # later attempts stuck at an 8x deadline once the
                        # peer is back. Reset to the configured deadline.
                        attempt_timeout = timeout

        task = asyncio.ensure_future(attempt_forever())
        self._send_tasks.add(task)
        task.add_done_callback(self._send_tasks.discard)
        return CancelOnDrop(task)

    def broadcast(self, addresses: Iterable[str], msg) -> list[CancelOnDrop]:
        return [self.send(a, msg) for a in addresses]

    async def unreliable_broadcast(self, addresses: Iterable[str], msg) -> list[bool]:
        return list(
            await asyncio.gather(*(self.unreliable_send(a, msg) for a in addresses))
        )

    async def lucky_broadcast(self, addresses: list[str], msg, nodes: int) -> list[bool]:
        """Random-subset broadcast (LuckyNetwork, traits.rs:70-94)."""
        # Deliberate draw from the scenario-seeded global stream
        # (scenario.py seeds `random` per plan): the "lucky" subset is
        # meant to be random AND replayable under the same seed.
        chosen = random.sample(addresses, min(nodes, len(addresses)))  # lint: allow(unseeded-random)
        return await self.unreliable_broadcast(chosen, msg)

    def close(self) -> None:
        for t in self._send_tasks:
            t.cancel()
        for p in self._peers.values():
            p.close()
        self._peers.clear()
