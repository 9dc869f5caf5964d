"""Primary assembly: channels, RPC routing, and actor spawning.

Port copy of `narwhal_tpu/primary/primary.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/primary.rs:71-470 — creates the metered
channels, binds the primary network address with the PrimaryToPrimary and
WorkerToPrimary services, and spawns Core, Proposer, HeaderWaiter,
CertificateWaiter, PayloadReceiver, Helper (mounted as RPC handlers here) and
StateHandler. Consensus channels (tx_new_certificates in, rx_committed
certificates back) are handed in by the node assembly, like the reference's
spawn signature.
"""

from __future__ import annotations

import asyncio
import logging

from ..channels import Channel, Watch, drain_cancelled, metered_channel
from ..config import (
    Committee,
    Parameters,
    WorkerCache,
    connection_pool_effective,
    env_float,
    header_wire_effective,
    pacing_enabled,
    relay_fanout_effective,
)
from ..crypto import SignatureService
from ..messages import (
    CertificateDeltaMsg,
    CertificatesBatchRequest,
    CertificatesRangeRequest,
    CertificateMsg,
    DeltaHeaderMsg,
    HeaderMsg,
    HeaderResyncRequest,
    HeaderResyncResponse,
    OthersBatchMsg,
    OurBatchMsg,
    PayloadAvailabilityRequest,
    ReconfigureMsg,
    RelayAckMsg,
    RelayMsg,
    VoteMsg,
)
from ..metrics import Registry
from ..network import NetworkClient, RpcServer, WireCounters, cached_allow_sets
from ..stores import NodeStorage
from ..types import Certificate, PublicKey, ReconfigureNotification
from .certificate_waiter import CertificateWaiter
from .core import Core
from .fanout import FanoutBroadcaster
from .header_waiter import HeaderWaiter
from .helper import Helper
from .metrics import PrimaryMetrics
from .payload_receiver import PayloadReceiver
from .proposer import NetworkModel, Proposer
from .state_handler import StateHandler
from .synchronizer import Synchronizer

logger = logging.getLogger("narwhal.primary")


class Primary:
    def __init__(
        self,
        name: PublicKey,
        signature_service: SignatureService,
        committee: Committee,
        worker_cache: WorkerCache,
        parameters: Parameters,
        storage: NodeStorage,
        tx_new_certificates: Channel,  # -> consensus
        rx_committed_certificates: Channel,  # <- consensus
        network_model: NetworkModel = NetworkModel.PARTIALLY_SYNCHRONOUS,
        registry: Registry | None = None,
        crypto_pool=None,  # AsyncVerifierPool: enables the pre-verify stage
        network_keypair=None,
        tracer=None,  # tracing.Tracer: the node's span/flight recorder
    ):
        self.name = name
        self.committee = committee
        self.worker_cache = worker_cache
        self.parameters = parameters
        self.storage = storage
        self.registry = registry or Registry()
        if tracer is None:
            from ..tracing import Tracer

            tracer = Tracer(node=f"primary-{name.hex()[:8]}")
        self.tracer = tracer
        self.metrics = PrimaryMetrics(self.registry, tracer=tracer)

        # Transport identity (the anemo PeerId model, p2p.rs:26-158): with a
        # network keypair the primary mesh requires the mutual handshake;
        # without one (bare component tests) it runs open.
        self.network_keypair = network_keypair
        credentials = None
        if network_keypair is not None:
            from ..network import Credentials, committee_resolver

            credentials = Credentials(
                network_keypair,
                committee_resolver(lambda: self.committee, lambda: self.worker_cache),
            )
        # Per-link wire accounting: every frame this primary writes/reads,
        # by message type and lane (wire_bytes_{sent,received}_total
        # {msg_type=,lane=}) — the measurement plane for the fanout/delta
        # wire diet and the pool's lane interleaving.
        self.wire_counters = WireCounters(self.registry)
        # Connection pool: ONE multiplexed authenticated stream per peer
        # node pair, shared by every co-hosted lane (network/pool.py). The
        # primary — holder of the node's network keypair — owns the pool
        # and registers it for the node's workers to join at spawn.
        # Pooling needs the authenticated handshake (the link identity IS
        # the verified network key), so bare unauthenticated assemblies run
        # legacy dedicated connections.
        self.pool = None
        if credentials is not None and connection_pool_effective(parameters):
            from ..network import LanePool, register_node_pool

            self.pool = LanePool(
                network_keypair.public,
                credentials,
                lambda: self.committee,
                lambda: self.worker_cache,
                counters=self.wire_counters,
                passive_dial_delay=parameters.pool_passive_dial_delay,
                linger=parameters.pool_linger,
            )
            register_node_pool(self.name, self.pool)
        self.network = NetworkClient(
            credentials=credentials, counters=self.wire_counters, pool=self.pool
        )
        self.server = RpcServer(
            parameters.max_concurrent_requests,
            auth_keypair=network_keypair,
            counters=self.wire_counters,
            pool=self.pool,
            dedup_cache_bytes=parameters.relay_dedup_cache_bytes,
        )
        if self.pool is not None:
            from ..network import LANE_PRIMARY

            self.pool.register_lane(LANE_PRIMARY, self.server)
        self._tasks: list[asyncio.Task] = []

        # Channels (primary.rs:104-151), each with a depth gauge — SURVEY
        # §5.6 "every inter-task channel is a gauge"
        # (types/src/metered_channel.rs:15-259, PrimaryChannelMetrics).
        def chan(name: str, capacity: int) -> Channel:
            return metered_channel(self.registry, "primary", name, capacity)

        self.tx_primary_messages = chan("primary_messages", 1_000)
        self.tx_headers_loopback = chan("headers_loopback", 1_000)
        self.tx_certificates_loopback = chan("certificates_loopback", 1_000)
        self.tx_sync_headers = chan("sync_headers", 1_000)  # SyncBatches|Parents
        self.tx_sync_certificates = chan("sync_certificates", 1_000)  # suspended
        self.tx_headers = chan("headers", 1_000)  # proposer -> core
        self.tx_parents = chan("parents", 1_000)  # core -> proposer
        self.tx_our_digests = chan("our_digests", 10_000)  # workers -> proposer
        self.tx_others_digests = chan("others_digests", 10_000)  # -> payload recv
        self.tx_state_handler = chan("state_handler", 100)
        self.tx_new_certificates = tx_new_certificates
        self.rx_committed_certificates = rx_committed_certificates

        # Watches.
        self.tx_reconfigure: Watch = Watch(ReconfigureNotification("boot"))
        self.tx_consensus_round_updates: Watch = Watch(0)

        self.header_store = storage.header_store
        self._ref_tasks: set[asyncio.Task] = set()  # certificate-ref resolvers

        genesis = {c.digest: c for c in Certificate.genesis(committee)}
        genesis_digests = frozenset(genesis)
        self.synchronizer = Synchronizer(
            name,
            storage.certificate_store,
            storage.payload_store,
            self.tx_sync_headers,
            genesis,
        )
        self.helper = Helper(
            committee, storage.certificate_store, storage.payload_store
        )
        # Fanout-tree dissemination (degenerates to direct broadcast when
        # the committee is too small for the tree to have depth >= 2, and
        # under the NARWHAL_RELAY=0 kill-switch).
        self.fanout = FanoutBroadcaster(
            name,
            committee,
            self.network,
            fanout=relay_fanout_effective(parameters),
            fallback_timeout=parameters.relay_fallback_timeout,
            metrics=self.metrics,
        )
        self.core = Core(
            name,
            committee,
            worker_cache,
            storage.header_store,
            storage.certificate_store,
            storage.vote_digest_store,
            self.synchronizer,
            signature_service,
            self.network,
            self.tx_primary_messages,
            self.tx_headers_loopback,
            self.tx_certificates_loopback,
            self.tx_headers,
            self.tx_new_certificates,
            self.tx_parents,
            self.tx_consensus_round_updates,
            parameters.gc_depth,
            self.tx_reconfigure,
            self.metrics,
            cert_format=getattr(parameters, "cert_format", "full"),
            fanout=self.fanout,
            header_wire=header_wire_effective(parameters),
            wire_counters=self.wire_counters,
        )
        self.core.tx_certificate_waiter = self.tx_sync_certificates
        # Adaptive header pacing: the proposer's effective delay tracks the
        # EWMA occupancy of the digest/ingest/consensus channels between
        # header_delay_floor and max_header_delay — short rounds when the
        # pipeline is shallow, full-sized headers at the configured cadence
        # under load. NARWHAL_PACING=0 pins the ceiling (seed behavior).
        proposer_pacing = None
        if pacing_enabled():
            from ..pacing import PacingController

            proposer_pacing = PacingController(
                ceiling=parameters.max_header_delay,
                floor=env_float(
                    "NARWHAL_HEADER_DELAY_FLOOR", parameters.header_delay_floor
                ),
                low_occupancy=parameters.pacing_low_occupancy,
                high_occupancy=parameters.pacing_high_occupancy,
                ewma_alpha=parameters.pacing_ewma_alpha,
                sources=[
                    self.tx_our_digests.occupancy,
                    self.tx_primary_messages.occupancy,
                    self.tx_new_certificates.occupancy,
                ],
                gauge=self.metrics.pacing_occupancy,
            )
        self.proposer = Proposer(
            name,
            committee,
            signature_service,
            parameters.header_size,
            parameters.max_header_delay,
            network_model,
            self.tx_parents,
            self.tx_our_digests,
            self.tx_headers,
            self.tx_reconfigure,
            self.metrics,
            pacing=proposer_pacing,
        )
        # A peer's payload-bearing header keeps our proposer on the pacing
        # floor: round advance is quorum-gated, so the whole committee must
        # hurry for anyone's payload to commit fast.
        self.core.on_payload_header = self.proposer.note_payload
        self.header_waiter = HeaderWaiter(
            name,
            committee,
            worker_cache,
            storage.certificate_store,
            storage.payload_store,
            parameters,
            self.network,
            self.tx_sync_headers,
            self.tx_headers_loopback,
            self.tx_primary_messages,
            self.tx_consensus_round_updates,
            self.tx_reconfigure,
            self.metrics,
        )
        self.certificate_waiter = CertificateWaiter(
            storage.certificate_store,
            genesis_digests,
            self.tx_sync_certificates,
            self.tx_certificates_loopback,
            self.tx_consensus_round_updates,
            self.tx_reconfigure,
            parameters.gc_depth,
            self.metrics,
        )
        self.payload_receiver = PayloadReceiver(
            storage.payload_store, self.tx_others_digests
        )
        if crypto_pool is not None:
            from .verifier_stage import VerifierStage

            self.verifier_stage = VerifierStage(
                committee,
                worker_cache,
                crypto_pool,
                self.tx_primary_messages,
                rx_reconfigure=self.tx_reconfigure,
            )
        else:
            self.verifier_stage = None
        self.state_handler = StateHandler(
            name,
            committee,
            worker_cache,
            self.network,
            self.rx_committed_certificates,
            self.tx_state_handler,
            self.tx_consensus_round_updates,
            self.tx_reconfigure,
            self.metrics,
        )

    async def spawn(self) -> None:
        address = self.committee.primary_address(self.name)
        host, port = address.rsplit(":", 1)
        bound = await self.server.start(host, int(port))
        self.address = f"{host}:{bound}"

        # PrimaryToPrimary plane: any committee primary's network identity.
        # WorkerToPrimary plane (digests + reconfigure): ONLY our own workers
        # (worker/src/primary_connector.rs; state path state_handler.rs).
        allow_peer_primary = self._allow_peer_primary if self.network_keypair else None
        allow_own_worker = self._allow_own_worker if self.network_keypair else None
        self.server.route(HeaderMsg, self._on_header, allow=allow_peer_primary)
        self.server.route(VoteMsg, self._on_vote, allow=allow_peer_primary)
        self.server.route(CertificateMsg, self._on_certificate, allow=allow_peer_primary)
        from ..messages import CertificateRefMsg

        self.server.route(
            CertificateRefMsg, self._on_certificate_ref, allow=allow_peer_primary
        )
        # Wire-diet plane: relay envelopes + delta announcements + resync.
        # Relay envelopes are forwarded UNCHANGED hop to hop, so duplicate
        # copies arriving from different relayers are byte-identical: the
        # dedup= shortcut answers all but the first from the server's
        # digest cache — ack/forward bookkeeping still runs, but the codec
        # decode and the core's sanitize path are paid once per payload,
        # not once per copy (the N=200 per-copy decode tax).
        self.server.route(
            RelayMsg, self._on_relay, allow=allow_peer_primary,
            dedup=self._on_relay_dup,
        )
        self.server.route(RelayAckMsg, self._on_relay_ack, allow=allow_peer_primary)
        from ..messages import Relay2Msg, RelayAck2Msg, Vote2Msg

        self.server.route(
            Relay2Msg, self._on_relay2, allow=allow_peer_primary,
            dedup=self._on_relay2_dup,
        )
        self.server.route(
            RelayAck2Msg, self._on_relay_ack2, allow=allow_peer_primary
        )
        self.server.route(Vote2Msg, self._on_vote2, allow=allow_peer_primary)
        self.server.route(
            DeltaHeaderMsg, self._on_delta_header, allow=allow_peer_primary
        )
        # CertificateDeltaMsg shares CertificateRefMsg's resolution path:
        # identical field names + rebuild(header) signature.
        self.server.route(
            CertificateDeltaMsg, self._on_certificate_ref, allow=allow_peer_primary
        )
        self.server.route(
            HeaderResyncRequest, self._on_header_resync, allow=allow_peer_primary
        )
        self.server.route(
            CertificatesBatchRequest,
            self.helper.on_certificates_batch,
            allow=allow_peer_primary,
        )
        self.server.route(
            CertificatesRangeRequest,
            self.helper.on_certificates_range,
            allow=allow_peer_primary,
        )
        self.server.route(
            PayloadAvailabilityRequest,
            self.helper.on_payload_availability,
            allow=allow_peer_primary,
        )
        self.server.route(OurBatchMsg, self._on_our_batch, allow=allow_own_worker)
        self.server.route(OthersBatchMsg, self._on_others_batch, allow=allow_own_worker)
        self.server.route(ReconfigureMsg, self._on_reconfigure, allow=allow_own_worker)

        self._tasks = [
            self.core.spawn(),
            self.proposer.spawn(),
            self.header_waiter.spawn(),
            self.certificate_waiter.spawn(),
            self.payload_receiver.spawn(),
            self.state_handler.spawn(),
        ]
        # Benchmark-parsed boot line (primary.rs:442-450).
        logger.info(
            "Primary %s successfully booted on %s", self.name.hex()[:16], self.address
        )

    # -- authorization predicates ------------------------------------------
    def _auth_sets(self) -> tuple[frozenset, frozenset]:
        def build():
            primaries = frozenset(
                a.network_key for a in self.committee.authorities.values()
            )
            workers = frozenset(
                info.name
                for info in self.worker_cache.our_workers(self.name).values()
            )
            # Pooled links authenticate with the NODE identity (the
            # authority network key) rather than per-worker keys, so our
            # own workers' traffic over the self-link presents our own
            # network key — the anemo node-granularity trust model.
            own = self.committee.authorities.get(self.name)
            if own is not None:
                workers = workers | {own.network_key}
            return primaries, workers

        return cached_allow_sets(self, self.committee, self.worker_cache, build)

    def _allow_peer_primary(self, peer) -> bool:
        """Any committee authority's primary network identity."""
        return peer.key is not None and peer.key in self._auth_sets()[0]

    def _allow_own_worker(self, peer) -> bool:
        """Only our own authority's workers."""
        return peer.key is not None and peer.key in self._auth_sets()[1]

    # -- handlers ----------------------------------------------------------
    async def _ingest(self, msg) -> None:
        """Protocol messages go through the async verification stage when a
        crypto pool is configured (signatures batched off the Core's loop),
        else straight to the Core."""
        if self.verifier_stage is not None:
            await self.verifier_stage.submit(msg)
        else:
            await self.tx_primary_messages.send(msg)

    async def _on_header(self, msg: HeaderMsg, peer: str):
        await self._ingest(msg.header)
        return None

    async def _on_vote(self, msg: VoteMsg, peer: str):
        await self._ingest(msg.vote)
        return None

    async def _on_certificate(self, msg: CertificateMsg, peer: str):
        await self._ingest(msg.certificate)
        return None

    async def _on_vote2(self, msg, peer: str):
        """Slim vote: reconstruct the full Vote from the header it
        endorses — our current header in the common case, the header store
        for a late one. A vote can OUTRUN our own proposal processing (the
        broadcast leaves before the core stores the header; on a loaded
        1-core host the voter's round trip can win that race), so a miss
        WAITS on the store instead of dropping: the RPC ack tells the
        voter's reliable send the vote landed, so a silent drop here would
        lose the vote forever — fatal in a committee whose quorum needs
        every survivor. The reconstructed fields are covered by the vote
        signature, so a forged rebuild can only fail verification."""
        # Atomic read of Core's latest proposed header (Core.run replaces
        # the whole reference between awaits, never mutates in place); a
        # mismatch just falls through to the store/waiter path below.
        header = self.core.current_header  # lint: allow(multi-task-mutation)
        if header is None or header.digest != msg.header_digest:
            header = self.header_store.read(msg.header_digest)
        if header is None:
            try:
                header = await asyncio.wait_for(
                    self.header_store.notify_read(msg.header_digest), timeout=3.0
                )
            except asyncio.TimeoutError:
                return None  # genuinely unknown header: stale/forged vote
        if header.author != self.name:
            return None
        await self._ingest(msg.rebuild(header))
        return None

    async def _on_relay(self, msg: RelayMsg, peer: str):
        """Fanout-tree envelope: forward to our children in the origin's
        tree + ack the origin (both non-blocking), then deliver the inner
        announcement through the same ingest path a direct send takes."""
        try:
            inner = msg.inner()
        except ValueError as e:
            logger.warning("relay with undecodable inner message: %s", e)
            return None
        self.fanout.on_relay(msg)
        await self._deliver_announcement(inner, peer)
        return None

    async def _deliver_announcement(self, inner, peer) -> None:
        if isinstance(inner, HeaderMsg):
            await self._ingest(inner.header)
        elif isinstance(inner, DeltaHeaderMsg):
            await self._on_delta_header(inner, peer)
        elif isinstance(inner, CertificateMsg):
            await self._ingest(inner.certificate)
        elif hasattr(inner, "rebuild"):  # CertificateDeltaMsg | CertificateRefMsg
            await self._on_certificate_ref(inner, peer)
        else:
            logger.warning("relay carried unexpected %r", type(inner))

    async def _on_relay_dup(self, msg: RelayMsg, peer: str):
        """Duplicate copy of a relay envelope already decoded (the server's
        digest cache hit before the codec ran): only the bookkeeping —
        forward to our tree children if we have not yet, ack the origin so
        its fallback timer stands down. The inner announcement was already
        delivered by the first copy; re-ingesting it would just re-pay
        sanitize/verify for a no-op."""
        self.fanout.on_relay(msg)
        return None

    async def _on_relay2_dup(self, msg, peer: str):
        """Slim-envelope duplicate: ack/forward bookkeeping without the
        decode_relay2 reconstruction or re-delivery (see _on_relay_dup)."""
        if msg.epoch != self.committee.epoch:
            return None
        origin = self.committee.key_of(msg.origin_index)
        self.fanout.on_relay2(msg, origin)
        return None

    async def _on_relay_ack(self, msg: RelayAckMsg, peer):
        self.fanout.on_ack(msg, getattr(peer, "key", None))
        return None

    async def _on_relay2(self, msg, peer: str):
        """Slim fanout-tree envelope: reconstitute the fat announcement
        (purpose-built compact body -> DeltaHeaderMsg/CertificateRefMsg),
        forward + ack one-way, then deliver through the identical ingest
        path the fat forms take."""
        from .fanout import decode_relay2

        if msg.epoch != self.committee.epoch:
            # Slim bodies are keyed to the SENDER's committee (origin and
            # bitmap positions are dense indices): across an epoch boundary
            # our index->key mapping may differ, so decoding would
            # reconstitute the announcement under the WRONG authorities.
            # Drop it — the origin's fallback delivers the fat form, which
            # the Core's next-epoch buffer then handles (the epoch-change
            # deadlock fix stays intact, one fallback deadline later).
            logger.debug(
                "dropping cross-epoch relay2 (epoch %s != %s); origin "
                "fallback covers delivery",
                msg.epoch,
                self.committee.epoch,
            )
            return None
        try:
            inner = decode_relay2(self.committee, msg)
        except Exception as e:
            logger.warning("relay2 with undecodable body: %s", e)
            return None
        origin = self.committee.key_of(msg.origin_index)
        self.fanout.on_relay2(msg, origin)
        await self._deliver_announcement(inner, peer)
        return None

    async def _on_relay_ack2(self, msg, peer):
        self.fanout.on_ack2(msg, getattr(peer, "key", None))
        return None

    async def _on_delta_header(self, msg: DeltaHeaderMsg, peer: str):
        """Delta header announcement: reconstruct from the recent-certificate
        index (self-verifying against the carried digest), else retry once
        shortly — the missing parent certificate is usually in flight on
        another link — and finally resync the full header from the author."""
        header = self.core.delta_codec.decode_header(msg)
        if header is not None:
            self.metrics.delta_headers_rebuilt.inc()
            await self._ingest(header)
            return None
        task = asyncio.ensure_future(self._resync_header(msg))
        self._ref_tasks.add(task)
        task.add_done_callback(self._ref_tasks.discard)
        return None

    async def _resync_header(self, msg: DeltaHeaderMsg) -> None:
        # Grace for in-flight parent certificates: the core drains its
        # queue in arrival order, so one short beat usually resolves the
        # reconstruction without paying the resync round trip.
        await asyncio.sleep(0.15)
        header = self.core.delta_codec.decode_header(msg)
        if header is not None:
            self.metrics.delta_headers_rebuilt.inc()
            await self._ingest(header)
            return
        self.metrics.delta_resyncs.inc()
        try:
            address = self.committee.primary_address(msg.author)
            resp: HeaderResyncResponse = await self.network.request(
                address,
                HeaderResyncRequest(
                    msg.header_digest,
                    msg.author,
                    self.core.delta_codec.last_seen_round(msg.author),
                    self.name,
                ),
                timeout=5.0,
            )
        except Exception as e:
            logger.debug("header resync from author failed: %s", e)
            return
        for header in getattr(resp, "headers", ()) or ():
            # Full sanitize path: a byzantine responder can only send
            # headers that fail verification.
            await self._ingest(header)

    async def _on_header_resync(self, msg: HeaderResyncRequest, peer: str):
        headers = []
        wanted = self.header_store.read(msg.header_digest)
        if wanted is not None:
            headers.append(wanted)
        if msg.author == self.name:
            headers.extend(
                self.core.delta_codec.own_headers_since(
                    msg.since_round, exclude=msg.header_digest
                )
            )
        return HeaderResyncResponse(tuple(headers))

    async def _on_certificate_ref(self, msg, peer: str):
        """Compact-certificate announcement: rebuild from our header store
        (we voted on the header, so the common case is a local hit), or
        fetch the full certificate from the origin on miss via the Helper's
        batch route. Runs as a task so a fetch RTT never blocks the
        connection's dispatch loop."""
        header = self.header_store.read(msg.header_digest)
        if header is None:
            task = asyncio.ensure_future(self._resolve_certificate_ref(msg))
            self._ref_tasks.add(task)
            task.add_done_callback(self._ref_tasks.discard)
            return None
        if (
            header.round == msg.round
            and header.epoch == msg.epoch
            and header.author == msg.origin
        ):
            await self._ingest(msg.rebuild(header))
        return None

    async def _resolve_certificate_ref(self, msg) -> None:
        from ..crypto import digest256
        from ..messages import CertificatesBatchRequest

        # Brief grace for the in-flight HeaderMsg to land before paying a
        # fetch round trip.
        try:
            header = await asyncio.wait_for(
                self.header_store.notify_read(msg.header_digest), timeout=0.5
            )
        except asyncio.TimeoutError:
            header = None
        if header is not None:
            if (
                header.round == msg.round
                and header.epoch == msg.epoch
                and header.author == msg.origin
            ):
                await self._ingest(msg.rebuild(header))
            return
        # The certificate digest is derived from the header digest alone
        # (types.Certificate.digest), so the fetch key is computable.
        cert_digest = digest256(b"CERT" + msg.header_digest)
        try:
            address = self.committee.primary_address(msg.origin)
            resp = await self.network.request(
                address,
                CertificatesBatchRequest((cert_digest,), self.name),
                timeout=5.0,
            )
        except Exception as e:
            logger.debug("certificate-ref fetch from origin failed: %s", e)
            return
        for _, cert in getattr(resp, "certificates", ()) or ():
            if cert is not None:
                await self._ingest(cert)

    async def _on_our_batch(self, msg: OurBatchMsg, peer: str):
        await self.tx_our_digests.send((msg.digest, msg.worker_id))
        return None

    async def _on_others_batch(self, msg: OthersBatchMsg, peer: str):
        await self.tx_others_digests.send((msg.digest, msg.worker_id))
        return None

    async def _on_reconfigure(self, msg: ReconfigureMsg, peer: str):
        await self.tx_state_handler.send(
            ReconfigureNotification(msg.kind, msg.committee())
        )
        return None

    # -- lifecycle ---------------------------------------------------------
    async def shutdown(self) -> None:
        self.tx_reconfigure.send(ReconfigureNotification("shutdown"))
        self.fanout.shutdown()
        if self.verifier_stage is not None:
            self.verifier_stage.shutdown()
        for t in list(self._ref_tasks):
            t.cancel()
        for t in self._tasks:
            t.cancel()
        await drain_cancelled(self._tasks, who="primary")
        await self.server.stop()
        if self.pool is not None:
            from ..network import unregister_node_pool

            unregister_node_pool(self.name, self.pool)
            self.pool.close()
        self.network.close()
