"""Per-peer-pair connection pool — ONE multiplexed stream per node pair.

Port copy of `narwhal_tpu/network/pool.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: anemo keeps a single QUIC connection per peer and multiplexes
every RPC over it (SURVEY.md network layer); our per-role×lane TCP mesh
instead opened O(N^2 * (1+W)) sockets — real-socket N=100 died at ~19.8k
fds against RLIMIT_NOFILE 20000.

The LanePool is the node-level owner of that one connection per peer:

- **Lanes.** Every role plane of a node pair — primary<->primary (lane 0)
  and each worker mesh lane (lane 1+worker_id) — shares the pooled stream;
  the u8 lane byte of the frame header (rpc.py) routes each frame to the
  lane's registered RpcServer handler table, and the FrameSender drains
  lane queues round-robin so bulk lanes cannot starve votes.

- **Bidirectional.** The accepting side ADOPTS an inbound pool connection
  (announced by the POOL_HELLO marker frame) as a PeerLink of its own and
  sends its requests back over it: one socket per UNORDERED node pair, not
  per direction. That halves the mesh again — the difference between
  ~19.8k and ~10k fds at N=100 under a 20k rlimit.

- **Crossed dials.** Two nodes may dial each other simultaneously at boot.
  The canonical connection is the one dialed by the LOWER network key
  (evaluated identically at both ends); the higher side defers its dial by
  `pool_passive_dial_delay` to make the race rare, and when it still
  happens the loser is linger-closed (`pool_linger`) so in-flight
  responses drain.

- **Reconnect.** One dead socket now takes out every lane to that peer.
  The pool owns re-establishment: a torn link deregisters itself and fails
  its in-flight rids, the caller's retry policy (NetworkClient.send)
  re-acquires `link_for()` which dials fresh — the in-flight retry
  handoff. Nothing is silently resent; exactly-once-per-ack semantics stay
  with the application retry layer.

- **Split deployments.** The pool assumes a node's roles are co-hosted
  behind its primary address (cluster.py runs them in one process). A
  pooled endpoint that does NOT co-host a lane answers LANE_UNAVAILABLE
  and the caller permanently falls back to a direct legacy connection for
  that address, so physically split primary/worker deployments keep
  working — they just keep their dedicated sockets.
"""

from __future__ import annotations

import asyncio
import logging

from . import transport
from .auth import AuthError, Credentials, Peer, client_handshake
from .rpc import (
    KIND_ERR,
    LANE_PRIMARY,
    LANE_UNAVAILABLE,
    MAX_FRAME,
    PeerLink,
    RpcError,
    WireCounters,
    _read_frame,
    _write_frame,
    worker_lane,
)

logger = logging.getLogger("narwhal.network")


class LanePool:
    """One node's end of the pooled mesh: the live PeerLink per peer node,
    the lane -> RpcServer dispatch table, dial/adopt/reconnect policy."""

    def __init__(
        self,
        own_key,
        credentials: Credentials,
        get_committee,
        get_worker_cache=None,
        counters: WireCounters | None = None,
        passive_dial_delay: float = 0.2,
        linger: float = 1.0,
    ):
        # `own_key` is the node's NETWORK public key — the identity the
        # handshake proves, and the key links are indexed by.
        self.own_key = own_key
        self._credentials = credentials
        self._get_committee = get_committee
        self._get_worker_cache = get_worker_cache
        self._counters = counters
        self._passive_delay = passive_dial_delay
        self._linger = linger
        self._lanes: dict[int, object] = {}  # lane -> RpcServer
        self._links: dict[bytes, PeerLink] = {}  # peer network key -> link
        self._dial_locks: dict[bytes, asyncio.Lock] = {}
        self._adopted: dict[bytes, asyncio.Event] = {}
        self._map_cache = None
        self._closed = False
        # Observability for the O(N) claim: how many pooled links this
        # node ever held at once, and how many it established in total.
        self.peak_links = 0
        self.links_opened = 0

    # -- lane registry ----------------------------------------------------

    def register_lane(self, lane: int, server) -> None:
        """Attach a co-hosted role's RpcServer as the handler table for
        `lane`. Frames arriving on pooled links with this lane id dispatch
        here (same-lane responses)."""
        self._lanes[lane] = server

    def unregister_lane(self, lane: int) -> None:
        self._lanes.pop(lane, None)

    def has_lane(self, lane: int) -> bool:
        return lane in self._lanes

    # -- address placement ------------------------------------------------

    def _maps(self):
        """(address -> (peer network key, lane), network key -> pooled dial
        address) for the CURRENT committee/worker-cache — identity-keyed
        memo, rebuilt when an epoch change swaps the config objects."""
        committee = self._get_committee()
        worker_cache = (
            self._get_worker_cache() if self._get_worker_cache is not None else None
        )
        cached = self._map_cache
        if cached is None or cached[0] is not committee or cached[1] is not worker_cache:
            by_addr: dict[str, tuple[bytes, int]] = {}
            dial: dict[bytes, str] = {}
            for auth in committee.authorities.values():
                by_addr[auth.primary_address] = (auth.network_key, LANE_PRIMARY)
                dial[auth.network_key] = auth.primary_address
            if worker_cache is not None:
                for auth_pk, workers in worker_cache.workers.items():
                    auth = committee.authorities.get(auth_pk)
                    if auth is None:
                        continue
                    for wid, info in workers.items():
                        # Only the validator mesh address — the transaction
                        # ingest endpoint stays on the public plane.
                        by_addr[info.worker_address] = (
                            auth.network_key,
                            worker_lane(wid),
                        )
            cached = self._map_cache = (committee, worker_cache, by_addr, dial)
        return cached[2], cached[3]

    def lookup(self, address: str) -> tuple[bytes, int] | None:
        """(peer network key, lane) when `address` is a committee role the
        pool can place behind the peer node's one connection; None routes
        the caller to a legacy dedicated connection."""
        return self._maps()[0].get(address)

    def dial_address(self, peer_key) -> str | None:
        return self._maps()[1].get(peer_key)

    # -- link lifecycle ---------------------------------------------------

    async def link_for(self, peer_key) -> PeerLink:
        """The live link to `peer_key`, establishing one if needed. The
        higher-keyed side of a pair first waits `pool_passive_dial_delay`
        for the peer's inbound connection (the canonical one) before
        dialing itself."""
        if self._closed:
            raise RpcError("connection pool closed")
        link = self._links.get(peer_key)
        if link is not None and not link.closed:
            return link
        lock = self._dial_locks.setdefault(peer_key, asyncio.Lock())
        async with lock:
            link = self._links.get(peer_key)
            if link is not None and not link.closed:
                return link
            if (
                self._passive_delay > 0
                and peer_key != self.own_key
                and bytes(self.own_key) > bytes(peer_key)
            ):
                event = self._adopted.setdefault(peer_key, asyncio.Event())
                event.clear()
                try:
                    await asyncio.wait_for(event.wait(), self._passive_delay)
                except asyncio.TimeoutError:  # lint: allow(no-silent-except)
                    pass  # grace period expired: the peer never dialed, we do
                link = self._links.get(peer_key)
                if link is not None and not link.closed:
                    return link
            return await self._dial(peer_key)

    async def _dial(self, peer_key) -> PeerLink:
        address = self.dial_address(peer_key)
        if address is None:
            raise RpcError("peer has no pooled address in the current committee")
        host, port = address.rsplit(":", 1)
        reader, writer = await transport.open_connection(
            host, int(port), limit=MAX_FRAME + 1024
        )
        try:
            session = await client_handshake(
                reader, writer, self._credentials, peer_key, _read_frame, _write_frame
            )
        except (AuthError, asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
            writer.close()
            raise RpcError(f"pool handshake with {address} failed: {e}") from e
        link = PeerLink(
            self, peer_key, address, writer, session, self._counters, dialed=True
        )
        link.send_pool_hello()
        link.start(reader)
        self._register(peer_key, link)
        return link

    def _register(self, peer_key, link: PeerLink) -> None:
        old = self._links.get(peer_key)
        self._links[peer_key] = link
        self.links_opened += 1
        self.peak_links = max(self.peak_links, len(self._links))
        event = self._adopted.setdefault(peer_key, asyncio.Event())
        event.set()
        if old is not None and not old.closed and old is not link:
            # Crossed dial (or stale link superseded by a reconnect): give
            # responses already in flight on the loser a moment to drain,
            # then tear it down. Its pending rids fail into the callers'
            # retry paths, which re-acquire THIS link.
            try:
                asyncio.get_running_loop().call_later(self._linger, old.close)
            except RuntimeError:
                old.close()

    def adopt(self, peer: Peer, reader, writer, session, sender):
        """Take over an inbound pool connection from RpcServer's accept
        path. Returns the link's demux-loop coroutine for the accept task
        to await (tying the connection's lifetime to it), or None when the
        peer's key is not a committee node (the server then keeps serving
        it as a legacy connection)."""
        peer_key = peer.key
        if peer_key != self.own_key and self.dial_address(peer_key) is None:
            return None
        link = PeerLink(
            self,
            peer_key,
            peer.addr,
            writer,
            session,
            self._counters,
            dialed=False,
            sender=sender,
        )
        if peer_key == self.own_key:
            # Self-link: the node pools to itself (worker -> own primary,
            # primary -> own worker). The DIALED end is the send path and
            # is already registered by the dialer; this accepted end only
            # serves dispatch — registering it would make the node talk to
            # itself over two half-links.
            pass
        else:
            existing = self._links.get(peer_key)
            crossed_loser = (
                existing is not None
                and not existing.closed
                and existing.dialed
                and bytes(self.own_key) < bytes(peer_key)
            )
            if not crossed_loser:
                # Either no link yet (use the peer's), or ours must yield:
                # the canonical connection is the one dialed by the lower
                # key, and the peer's key is lower (or our existing link is
                # itself a stale adoption superseded by this reconnect).
                self._register(peer_key, link)
            # else: our own dial is canonical; serve this inbound link's
            # dispatch until the peer (the loser's dialer) closes it.
        return link.run(reader)

    def discard(self, link: PeerLink) -> None:
        """Called from the link's teardown: forget it if it is the
        registered one (a superseded loser just disappears)."""
        if self._links.get(link.peer_pk) is link:
            del self._links[link.peer_pk]
            event = self._adopted.get(link.peer_pk)
            if event is not None:
                event.clear()

    # -- inbound dispatch -------------------------------------------------

    async def dispatch(
        self, link: PeerLink, lane: int, rid: int, tag: int, body: bytes, oneway: bool
    ) -> None:
        """Route one inbound frame to the lane's co-hosted server. A lane
        nobody registered (split deployment) answers LANE_UNAVAILABLE so
        the caller falls back to a direct connection."""
        server = self._lanes.get(lane)
        if server is None:
            if oneway:
                logger.debug(
                    "dropping oneway frame for non-co-hosted lane %d from %s",
                    lane,
                    link.address,
                )
            else:
                try:
                    link.respond(KIND_ERR, rid, 0, LANE_UNAVAILABLE, lane)
                except RpcError:  # lint: allow(no-silent-except)
                    pass  # link died under the reply; the caller's rid fails
            return
        await server.dispatch_frame(
            link.sender, rid, tag, body, link.peer, oneway, lane
        )

    def close(self) -> None:
        self._closed = True
        for link in list(self._links.values()):
            link.close()
        self._links.clear()
        self._lanes.clear()


# Process-global registry of co-hosted node pools, keyed by AUTHORITY
# public key (the protocol identity both Primary and Worker know): the
# Primary — holder of the node's network keypair — creates and registers
# the pool; co-hosted Workers look it up at spawn and register their lanes.
# A Worker that finds no pool (standalone/split deployment, pooling off)
# runs legacy dedicated connections.
_NODE_POOLS: dict[bytes, LanePool] = {}


def register_node_pool(name, pool: LanePool) -> None:
    # Overwrite is deliberate: a restarted node (NodeRestarter) registers
    # its fresh pool over the dead one.
    _NODE_POOLS[name] = pool


def node_pool(name) -> LanePool | None:
    return _NODE_POOLS.get(name)


def unregister_node_pool(name, pool: LanePool) -> None:
    """Remove `pool` from the registry — only if it is still the current
    one (a restarted node's fresh pool must survive the old one's late
    shutdown)."""
    if _NODE_POOLS.get(name) is pool:
        del _NODE_POOLS[name]
