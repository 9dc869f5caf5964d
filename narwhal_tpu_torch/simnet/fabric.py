"""SimFabric — the socket-free, seeded, virtual-latency network.

Port copy of `narwhal_tpu/simnet/fabric.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

The fabric implements the two calls the transport seam
(network/transport.py) routes here: `start_server` registers an in-process
listener under a "host:port" string, `open_connection` pairs a client with
it through two directed byte pipes (`asyncio.StreamReader`s fed by duck-typed
writers). Everything above — framing, handshakes, AEAD sealing, write
coalescing — is the production `rpc.py` code, byte for byte; only the medium
changes.

Delivery model:

* every `writer.write(chunk)` enqueues the chunk for delivery into the
  peer's reader at `now + latency + jitter` (seeded RNG), clamped
  non-decreasing per direction so the byte stream stays ordered, like TCP.
  Deliveries are BATCHED: the fabric keeps one pending min-heap ordered by
  (deliver_t, enqueue seq) and arms a single loop timer at the head
  deadline — when it fires, every chunk due at that virtual instant drains
  in one flush, with consecutive same-stream chunks coalesced into one
  `feed_data`. One timer per flush instead of one per chunk is where the
  10x on the asyncio_loop/timer-churn profile line comes from;
* a `drop` hit kills the connection (both readers see ConnectionResetError)
  — on a framed, nonce-sequenced stream a lost segment is unrecoverable, so
  reset-and-reconnect is the honest model of a lossy link;
* partitions/crashes refuse new connects (ConnectionRefusedError) and reset
  live cross-cut connections, so the retry/backoff machinery is exercised
  exactly as by a real outage.

Attribution: the *server* side of an address is known from registration
(`register_node`); the *client* side is read from the `CURRENT_NODE`
context variable, which SimCluster sets around each node's spawn — tasks
inherit it, so every lazy reconnect rounds later still carries its node
identity. Connections with no node attribution (benchmark clients) are
conditioned by the default link and are unaffected by partitions.

Every chunk movement is appended to the event log: `(seq, t_send, t_deliver,
src, dst, kind, nbytes)` with virtual times. Two runs of the same seeded
scenario produce identical logs — `EventLog.digest()` is the equality the
replay test pins.
"""

from __future__ import annotations

import asyncio
import contextvars
import hashlib
import heapq
import itertools
import random

from .plan import LinkSpec

# Pending-queue entry kinds, ordered within a flush by (deliver_t, seq):
# data chunks, graceful EOFs and drop-resets all ride the same queue so a
# half-close or a mid-flight reset can never overtake bytes sent before it.
_DATA, _EOF, _RESET = 0, 1, 2

# The node id on whose behalf the current task opens connections. Set by
# SimCluster around node construction/spawn; inherited by every task those
# actors create (asyncio tasks copy the current context).
CURRENT_NODE: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "simnet_current_node", default=None
)


class EventLog:
    """Append-only record of everything the fabric did, in virtual time."""

    def __init__(self):
        self.entries: list[tuple] = []
        self._seq = itertools.count()

    def append(self, kind: str, *fields) -> None:
        self.entries.append((next(self._seq), kind) + fields)

    def digest(self) -> str:
        h = hashlib.sha256()
        for entry in self.entries:
            h.update(repr(entry).encode())
            h.update(b"\n")
        return h.hexdigest()

    def __len__(self) -> int:
        return len(self.entries)


class _SimSocket:
    """Just enough of a socket for RpcServer's getsockname()."""

    def __init__(self, host: str, port: int):
        self._name = (host, port)

    def getsockname(self):
        return self._name


class SimServer:
    """The asyncio.AbstractServer shape RpcServer.start/stop expects."""

    def __init__(self, fabric: "SimFabric", host: str, port: int):
        self._fabric = fabric
        self.sockets = [_SimSocket(host, port)]
        self._closed = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._fabric._unbind(f"{self.sockets[0]._name[0]}:{self.sockets[0]._name[1]}")

    async def wait_closed(self) -> None:
        return None


class _Listener:
    def __init__(self, cb, limit: int, node: str | None, ctx):
        self.cb = cb
        self.limit = limit
        self.node = node  # owning node id (None for unattributed servers)
        self.ctx = ctx  # context the acceptor runs handler tasks in


class _SimWriter:
    """Duck-typed StreamWriter over the fabric: write() hands the chunk to
    the fabric for conditioned delivery into the peer's reader."""

    # No kernel send buffer behind this writer, so drain() never blocks —
    # FrameSender uses this flag to write synchronously (no drainer task).
    sync_drain = True

    def __init__(self, conn: "_SimConnection", direction: int):
        self._conn = conn
        self._dir = direction  # 0: client->server, 1: server->client

    def write(self, data: bytes) -> None:
        if self._conn.reset_exc is not None:
            raise ConnectionResetError(str(self._conn.reset_exc))
        if self._conn.closed[self._dir]:
            # EOF is already in flight; a later chunk would violate stream
            # order. Matches a real transport's write-after-close failure.
            raise ConnectionResetError("write after close")
        self._conn.fabric._transmit(self._conn, self._dir, bytes(data))

    async def drain(self) -> None:
        # No kernel send buffer to fill; readers buffer without bound (the
        # per-connection volume is capped by the protocol's own
        # request/response concurrency limits).
        if self._conn.reset_exc is not None:
            raise ConnectionResetError(str(self._conn.reset_exc))

    def close(self) -> None:
        self._conn.close(self._dir)

    def is_closing(self) -> bool:
        return self._conn.closed[self._dir] or self._conn.reset_exc is not None

    async def wait_closed(self) -> None:
        return None

    def get_extra_info(self, name, default=None):
        if name == "peername":
            if self._dir == 0:  # client writer: peer is the server address
                host, port = self._conn.dst_addr.rsplit(":", 1)
                return (host, int(port))
            return (self._conn.src or "client", 0)
        return default


class _SimConnection:
    """One client<->server pairing: two readers, two writers, per-direction
    FIFO delivery cursors, and a reset latch. Ids are per-fabric so two
    scenarios in one process log identical ids."""

    def __init__(self, fabric: "SimFabric", src: str | None, dst: str | None, dst_addr: str, limit: int):
        self.id = next(fabric._conn_ids)
        self.fabric = fabric
        self.src = src  # client node id (None = external client)
        self.dst = dst  # server node id
        self.dst_addr = dst_addr
        # readers[0]: what the SERVER reads (client->server direction 0)
        # readers[1]: what the CLIENT reads (server->client direction 1)
        self.readers = [
            asyncio.StreamReader(limit=limit),
            asyncio.StreamReader(limit=limit),
        ]
        self.closed = [False, False]
        self.reset_exc: Exception | None = None
        self._next_deliver = [0.0, 0.0]

    def endpoints(self, direction: int) -> tuple[str, str]:
        a, b = self.src or "client", self.dst or "?"
        return (a, b) if direction == 0 else (b, a)

    def reset(self, reason: str) -> None:
        if self.reset_exc is not None:
            return
        self.reset_exc = ConnectionResetError(reason)
        for r in self.readers:
            if r.exception() is None and not r.at_eof():
                r.set_exception(ConnectionResetError(reason))
        self.fabric._conns.discard(self)
        self.fabric.log.append("reset", self.id, reason)
        self.fabric.counters["resets"] += 1

    def close(self, direction: int) -> None:
        """Graceful half-close from one side: the peer reads EOF.
        Direction d's writes land in readers[d], so that is where the EOF
        goes too."""
        if self.closed[direction] or self.reset_exc is not None:
            self.closed[direction] = True
            return
        self.closed[direction] = True
        # EOF rides the fabric's pending queue behind any chunks still in
        # flight on this direction (queue order is (deliver_t, seq), so an
        # equal-deadline EOF still lands after earlier-enqueued data).
        try:
            loop = asyncio.get_event_loop()
            eof_t = max(loop.time(), self._next_deliver[direction])
            self._next_deliver[direction] = eof_t
            self.fabric._schedule(loop, eof_t, _EOF, self, direction, None)
        except RuntimeError:  # closing outside any loop (test teardown)
            self._feed_eof(direction)
        if all(self.closed):
            self.fabric._conns.discard(self)

    def _feed_eof(self, direction: int) -> None:
        reader = self.readers[direction]
        if (
            self.reset_exc is None
            and reader.exception() is None
            and not reader.at_eof()
        ):
            reader.feed_eof()


class SimFabric:
    """The in-memory network: listeners, connections, link conditions."""

    # Snapshot of the most recent fabric's counters: scenarios tear the
    # instance down with the loop, so post-run tooling (the fabric
    # profiler) reads the class-level alias instead.
    last_counters: dict = {}

    def __init__(self, seed: int = 0, default_link: LinkSpec | None = None):
        self.rng = random.Random(seed)
        self.default_link = default_link or LinkSpec()
        self.log = EventLog()
        # Hot-path tallies (plain dict, no locking: the loop is single
        # threaded). Purely observational — nothing reads them to make
        # decisions, so determinism is untouched.
        self.counters = {
            "dials": 0,
            "connects": 0,
            "transmits": 0,
            "bytes_sent": 0,
            "drops": 0,
            "delivers": 0,
            "bytes_delivered": 0,
            "resets": 0,
            "peak_conns": 0,
        }
        SimFabric.last_counters = self.counters
        # Batched delivery: one min-heap of (deliver_t, seq, kind, conn,
        # direction, payload) and ONE armed loop timer at the head
        # deadline, instead of one loop timer per in-flight chunk.
        self._pending: list[tuple] = []
        self._pending_seq = itertools.count()
        self._timer = None
        self._timer_when = 0.0
        self._listeners: dict[str, _Listener] = {}
        self._conns: set[_SimConnection] = set()
        self._conn_ids = itertools.count(1)
        self._ports = itertools.count(40000)
        self._addr_node: dict[str, str] = {}  # "host:port" -> node id
        self._down: set[str] = set()  # crashed/isolated node ids
        self._groups: dict[str, int] | None = None  # node id -> partition group
        self._links: dict[tuple[str, str], LinkSpec] = {}  # (a,b) sorted pair

    # -- topology registration (SimCluster) ---------------------------------
    def register_node(self, node: str, addresses) -> None:
        for addr in addresses:
            self._addr_node[addr] = node

    # -- fault controls (applied by the scenario runner) --------------------
    def set_partition(self, groups) -> None:
        """groups: iterable of iterables of node ids; None clears. Existing
        cross-group connections are reset immediately."""
        if groups is None:
            self._groups = None
            self.log.append("heal")
            return
        mapping: dict[str, int] = {}
        for gi, group in enumerate(groups):
            for node in group:
                mapping[node] = gi
        self._groups = mapping
        self.log.append("partition", tuple(sorted(mapping.items())))
        # Sorted by connection id: set iteration is id-ordered and would
        # reorder the resets (and the log) between otherwise identical runs.
        for conn in sorted(self._conns, key=lambda c: c.id):
            if self._cut(conn.src, conn.dst):
                conn.reset("partitioned")

    def set_node_down(self, node: str, down: bool = True) -> None:
        if down:
            self._down.add(node)
            self.log.append("node_down", node)
            for conn in sorted(self._conns, key=lambda c: c.id):
                if conn.src == node or conn.dst == node:
                    conn.reset(f"{node} crashed")
        else:
            self._down.discard(node)
            self.log.append("node_up", node)

    def set_link(self, a: str, b: str, link: LinkSpec | None) -> None:
        key = (a, b) if a <= b else (b, a)
        if link is None:
            self._links.pop(key, None)
            self.log.append("link_clear", key)
        else:
            self._links[key] = link
            self.log.append(
                "link_set", key, link.latency, link.jitter, link.drop
            )

    # -- condition lookups --------------------------------------------------
    def _cut(self, a: str | None, b: str | None) -> bool:
        if self._groups is None or a is None or b is None:
            return False
        ga, gb = self._groups.get(a), self._groups.get(b)
        # Nodes outside every named group share the implicit last group.
        return ga != gb

    def _link_for(self, a: str | None, b: str | None) -> LinkSpec:
        if a is None or b is None:
            return self.default_link
        key = (a, b) if a <= b else (b, a)
        return self._links.get(key, self.default_link)

    # -- the transport-seam surface ----------------------------------------
    async def start_server(self, cb, host: str, port: int, *, limit: int) -> SimServer:
        if port == 0:
            port = next(self._ports)
        key = f"{host}:{port}"
        if key in self._listeners:
            raise OSError(98, f"simnet address already in use: {key}")
        node = self._addr_node.get(key, CURRENT_NODE.get())
        self._listeners[key] = _Listener(
            cb, limit, node, contextvars.copy_context()
        )
        return SimServer(self, host, port)

    def _unbind(self, key: str) -> None:
        self._listeners.pop(key, None)

    async def open_connection(self, host: str, port: int, *, limit: int):
        key = f"{host}:{port}"
        listener = self._listeners.get(key)
        src = CURRENT_NODE.get()
        dst = self._addr_node.get(key)
        if src is not None and src in self._down:
            # A crashed node's still-cancelling tasks must not reach out.
            raise ConnectionRefusedError(f"{src} is down")
        if listener is None or (dst is not None and dst in self._down):
            raise ConnectionRefusedError(f"no simnet listener on {key}")
        if self._cut(src, dst):
            raise ConnectionRefusedError(f"partition cuts {src}->{key}")
        link = self._link_for(src, dst)
        # One connect RTT under the link's conditions before the streams
        # exist, like a SYN exchange. The dial is logged at DRAW time so the
        # seeded rng stream is fully reconstructible from the event log.
        self.log.append("dial", src or "client", key)
        self.counters["dials"] += 1
        delay = link.latency + (
            self.rng.uniform(0.0, link.jitter) if link.jitter else 0.0
        )
        if delay > 0:
            await asyncio.sleep(delay)
        conn = _SimConnection(self, src, dst or key, key, limit)
        self._conns.add(conn)
        if len(self._conns) > self.counters["peak_conns"]:
            self.counters["peak_conns"] = len(self._conns)
        self.log.append("connect", conn.id, src or "client", key)
        self.counters["connects"] += 1
        server_writer = _SimWriter(conn, 1)
        client_writer = _SimWriter(conn, 0)
        # The handler task runs in the LISTENER's captured context so the
        # server side is attributed to its owning node (dispatch tasks it
        # spawns inherit that context, exactly like a real accept loop).
        listener.ctx.run(
            asyncio.ensure_future, listener.cb(conn.readers[0], server_writer)
        )
        return conn.readers[1], client_writer

    # -- chunk movement -----------------------------------------------------
    def _transmit(self, conn: _SimConnection, direction: int, data: bytes) -> None:
        src, dst = conn.endpoints(direction)
        if self._cut(conn.src, conn.dst):
            conn.reset("partitioned")
            raise ConnectionResetError("partitioned")
        link = self._link_for(conn.src, conn.dst)
        loop = asyncio.get_event_loop()
        now = loop.time()
        if link.drop and self.rng.random() < link.drop:
            # A lost segment on a framed AEAD stream is unrecoverable:
            # model it as the connection dying mid-flight.
            self.log.append("drop", conn.id, src, dst, len(data))
            self.counters["drops"] += 1
            deliver_t = max(
                now + link.latency, conn._next_deliver[direction]
            )
            self._schedule(loop, deliver_t, _RESET, conn, direction, "chunk dropped")
            return
        jitter = self.rng.uniform(0.0, link.jitter) if link.jitter else 0.0
        deliver_t = now + link.latency + jitter
        # Non-decreasing per direction (the TCP-like ordering cursor). The
        # pending queue breaks equal-deadline ties by enqueue sequence, so
        # chunks sharing a virtual instant still deliver in send order —
        # and share one timer flush instead of one timer each (the old
        # design needed a strictly-increasing nanosecond bump because
        # asyncio's timer heap is not FIFO for equal deadlines).
        prev = conn._next_deliver[direction]
        if deliver_t < prev:
            deliver_t = prev
        conn._next_deliver[direction] = deliver_t
        self.log.append(
            "xmit", conn.id, src, dst, len(data),
            round(now, 9), round(deliver_t, 9),
        )
        self.counters["transmits"] += 1
        self.counters["bytes_sent"] += len(data)
        self._schedule(loop, deliver_t, _DATA, conn, direction, data)

    def _schedule(self, loop, when: float, kind: int, conn, direction: int, payload) -> None:
        heapq.heappush(
            self._pending,
            (when, next(self._pending_seq), kind, conn, direction, payload),
        )
        if self._timer is None or when < self._timer_when:
            if self._timer is not None:
                self._timer.cancel()
            self._timer_when = when
            self._timer = loop.call_at(when, self._flush)

    def _flush(self) -> None:
        """Drain every pending entry due at (or before) the current virtual
        instant, in (deliver_t, seq) order, coalescing consecutive chunks
        of one stream into a single feed_data; then re-arm the timer for
        the next head deadline."""
        self._timer = None
        loop = asyncio.get_event_loop()
        # Tiny epsilon so float drift in the virtual clock can never leave
        # the head entry perpetually "one tick in the future" (which would
        # re-arm a zero-delay timer forever).
        now = loop.time() + 1e-9
        pending = self._pending
        cur_conn = None
        cur_dir = 0
        chunks: list[bytes] = []
        while pending and pending[0][0] <= now:
            _t, _seq, kind, conn, direction, payload = heapq.heappop(pending)
            if kind == _DATA and conn is cur_conn and direction == cur_dir:
                chunks.append(payload)
                continue
            if chunks:
                self._feed(cur_conn, cur_dir, chunks)
                chunks = []
            cur_conn = None
            if kind == _DATA:
                cur_conn, cur_dir = conn, direction
                chunks = [payload]
            elif kind == _EOF:
                conn._feed_eof(direction)
            else:  # _RESET (dropped chunk)
                conn.reset(payload)
        if chunks:
            self._feed(cur_conn, cur_dir, chunks)
        if pending:
            self._timer_when = pending[0][0]
            self._timer = loop.call_at(self._timer_when, self._flush)

    def _feed(self, conn: _SimConnection, direction: int, chunks: list) -> None:
        if conn.reset_exc is not None:
            return
        reader = conn.readers[direction]
        # at_eof() is False while buffered bytes remain, so check the flag
        # itself: once EOF is fed, nothing more may enter the stream.
        if reader.exception() is None and not getattr(reader, "_eof", False):
            data = chunks[0] if len(chunks) == 1 else b"".join(chunks)
            self.counters["delivers"] += len(chunks)
            self.counters["bytes_delivered"] += len(data)
            reader.feed_data(data)
