"""Worker assembly: networks, tx ingest, and the batch pipeline actors.

Port copy of `narwhal_tpu/worker/worker.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/worker/src/worker.rs:57-211 (spawn),
TxReceiverHandler :352-423, WorkerReceiverHandler :426-466,
PrimaryReceiverHandler (Synchronize/Cleanup/RequestBatch/DeleteBatches/
Reconfigure) routed through the synchronizer.

One RPC server on `worker_address` carries both the worker<->worker plane and
the primary->worker plane; a second server on `transactions` is the
client-facing tx ingest (the tonic Transactions service analog). A design
delta: RequestBatch and DeleteBatches are served as direct RPC responses
instead of loose WorkerToPrimary messages — same capability, one less round
trip (the reference's BlockWaiter matches responses manually,
primary/src/block_waiter.rs:549-).
"""

from __future__ import annotations

import asyncio
import logging
import os

from ..channels import Channel, Watch, drain_cancelled, metered_channel
from ..config import Committee, Parameters, WorkerCache, env_float, pacing_enabled
from ..messages import (
    BackpressureMsg,
    CleanupMsg,
    DeleteBatchesMsg,
    DeletedBatchesMsg,
    ReconfigureMsg,
    RequestBatchesMsg,
    RequestBatchMsg,
    RequestedBatchesMsg,
    RequestedBatchMsg,
    SubmitTransactionMsg,
    SubmitTransactionStreamMsg,
    SynchronizeMsg,
    WorkerBatchMsg,
    WorkerBatchRequest,
    WorkerBatchResponse,
)
from ..metrics import Registry
from ..network import NetworkClient, RpcServer, WireCounters, cached_allow_sets
from ..pacing import BackpressureState, IngestGate, PacingController
from ..stores import BatchStore
from ..types import (
    Batch,
    PublicKey,
    ReconfigureNotification,
    WorkerId,
    validate_tx_frames,
)
from .batch_maker import BatchMaker
from .metrics import WorkerMetrics
from .primary_connector import PrimaryConnector
from .processor import Processor
from .quorum_waiter import QuorumWaiter
from .synchronizer import WorkerSynchronizer

logger = logging.getLogger("narwhal.worker")


class Worker:
    def __init__(
        self,
        name: PublicKey,
        worker_id: WorkerId,
        committee: Committee,
        worker_cache: WorkerCache,
        parameters: Parameters,
        store: BatchStore,
        registry: Registry | None = None,
        benchmark: bool = False,
        network_keypair=None,
        tracer=None,  # tracing.Tracer: the node's span/flight recorder
    ):
        self.name = name
        self.worker_id = worker_id
        self.committee = committee
        self.worker_cache = worker_cache
        self.parameters = parameters
        self.store = store
        self.registry = registry or Registry()
        if tracer is None:
            from ..tracing import Tracer

            tracer = Tracer(node=f"worker-{name.hex()[:8]}-{worker_id}")
        self.tracer = tracer
        self.metrics = WorkerMetrics(self.registry, tracer=tracer)
        self.benchmark = benchmark

        # Transport identity (worker.rs:137-146 registers worker network keys
        # as known anemo peers). With a keypair the mesh server requires the
        # mutual handshake and the client authenticates to peers; without one
        # (bare component tests) the mesh runs open.
        self.network_keypair = network_keypair
        credentials = None
        if network_keypair is not None:
            from ..network import Credentials, committee_resolver

            credentials = Credentials(
                network_keypair,
                committee_resolver(lambda: self.committee, lambda: self.worker_cache),
            )
        # Per-link wire accounting for the payload plane (batch
        # dissemination is the data-plane bulk of MB/round).
        self.wire_counters = WireCounters(self.registry)
        # Join the co-hosted node's connection pool (network/pool.py): the
        # Primary — holder of the node's network keypair — creates and
        # registers it under the authority name; this worker's mesh lane
        # then rides the node pair's ONE multiplexed connection. Absent
        # pool (standalone worker, split deployment, NARWHAL_POOL=0) the
        # worker keeps legacy dedicated connections.
        from ..network import node_pool

        self.pool = node_pool(self.name) if network_keypair is not None else None
        self.network = NetworkClient(
            credentials=credentials, counters=self.wire_counters, pool=self.pool
        )
        self.server = RpcServer(
            parameters.max_concurrent_requests,
            auth_keypair=network_keypair,
            counters=self.wire_counters,
        )
        self.tx_server = RpcServer(
            parameters.max_concurrent_requests, counters=self.wire_counters
        )
        self.rx_reconfigure: Watch = Watch(ReconfigureNotification("boot"))
        self._tasks: list[asyncio.Task] = []

        # Channels (worker/src/worker.rs:229-346 wiring), depth-gauged
        # (SURVEY §5.6; types/src/metered_channel.rs:15-259).
        def chan(name: str, capacity: int) -> Channel:
            return metered_channel(self.registry, "worker", name, capacity)

        self.tx_batch_maker = chan("batch_maker", 10_000)
        self.tx_quorum_waiter = chan("quorum_waiter", 1_000)
        self.tx_processor = chan("processor", 1_000)
        self.tx_others_processor = chan("others_processor", 1_000)
        self.tx_digest = chan("digest", 10_000)
        self.tx_sync_command = chan("sync_command", 1_000)

        # End-to-end admission control: the primary pushes its downstream
        # (consensus/executor) backlog level here (BackpressureMsg), and the
        # client-facing ingest handlers gate on the max of that level and
        # the local ingest-queue occupancy. Past the high watermark the
        # gate sheds (RESOURCE_EXHAUSTED) or blocks per ingest_policy, so
        # overload degrades to bounded latency instead of unbounded backlog.
        self.backpressure = BackpressureState(
            high=parameters.backpressure_high_watermark,
            low=parameters.backpressure_low_watermark,
            stale_after=parameters.backpressure_stale_after,
            gauge=self.metrics.backpressure_level,
        )
        self.ingest_gate = IngestGate(
            policy=os.environ.get("NARWHAL_INGEST_POLICY", parameters.ingest_policy),
            local_sources=[
                self.tx_batch_maker.occupancy,
                self.tx_quorum_waiter.occupancy,
                self.tx_processor.occupancy,
            ],
            downstream=self.backpressure,
            high=parameters.backpressure_high_watermark,
            low=parameters.backpressure_low_watermark,
            metrics=self.metrics,
        )
        # Adaptive seal pacing: the batch maker's effective delay tracks
        # the EWMA occupancy of the batch pipeline's channels between
        # batch_delay_floor and max_batch_delay. NARWHAL_PACING=0 pins the
        # configured ceiling (the fixed-timer seed behavior).
        self.batch_pacing: PacingController | None = None
        if pacing_enabled():
            self.batch_pacing = PacingController(
                ceiling=parameters.max_batch_delay,
                floor=env_float(
                    "NARWHAL_BATCH_DELAY_FLOOR", parameters.batch_delay_floor
                ),
                low_occupancy=parameters.pacing_low_occupancy,
                high_occupancy=parameters.pacing_high_occupancy,
                ewma_alpha=parameters.pacing_ewma_alpha,
                sources=[
                    self.tx_batch_maker.occupancy,
                    self.tx_quorum_waiter.occupancy,
                    self.tx_processor.occupancy,
                ],
                gauge=self.metrics.pacing_occupancy,
            )

    async def spawn(self) -> None:
        # The node pool may have been registered after our construction
        # (assembly order is harness-specific); re-check before binding so
        # this worker's lane joins it either way.
        if self.pool is None and self.network_keypair is not None:
            from ..network import node_pool

            self.pool = node_pool(self.name)
            if self.pool is not None:
                self.network.attach_pool(self.pool)
        if self.pool is not None:
            from ..network import worker_lane

            self.pool.register_lane(worker_lane(self.worker_id), self.server)
        me = self.worker_cache.worker(self.name, self.worker_id)
        host, port = me.worker_address.rsplit(":", 1)
        bound = await self.server.start(host, int(port))
        self.worker_address = f"{host}:{bound}"
        thost, tport = me.transactions.rsplit(":", 1)
        tbound = await self.tx_server.start(thost, int(tport))
        self.transactions_address = f"{thost}:{tbound}"
        # Interoperable gRPC ingest (the reference's tonic Transactions
        # service, worker.rs:369-423) alongside the high-throughput typed
        # ingest; ephemeral port, surfaced via grpc_transactions_address.
        # grpc.aio binds a REAL socket, so it is skipped under the simnet
        # transport (simulated committees are zero-socket by contract; the
        # typed ingest above already rides the fabric).
        from ..network import transport as _transport

        if _transport.simnet_active():
            self.grpc_transactions_address = ""
        else:
            from ..grpc_api import GrpcTransactions

            self.grpc_transactions = GrpcTransactions(
                self.tx_batch_maker, self.metrics, gate=self.ingest_gate
            )
            self.grpc_transactions_address = await self.grpc_transactions.spawn(
                f"{thost}:0"
            )

        # Route the three planes with the authorization matrix: batch planes
        # accept same-lane workers of any committee member, the control plane
        # (sync/cleanup/delete/reconfigure — worker/src/worker.rs:137-146,
        # synchronizer.rs:215-282) ONLY our own primary. Predicates read
        # self.committee/worker_cache live, so epoch changes apply.
        allow_peer_worker = self._allow_peer_worker if self.network_keypair else None
        allow_own_primary = self._allow_own_primary if self.network_keypair else None
        self.server.route(WorkerBatchMsg, self._on_peer_batch, allow=allow_peer_worker)
        self.server.route(
            WorkerBatchRequest, self._on_batch_request, allow=allow_peer_worker
        )
        self.server.route(SynchronizeMsg, self._on_synchronize, allow=allow_own_primary)
        self.server.route(CleanupMsg, self._on_cleanup, allow=allow_own_primary)
        self.server.route(
            RequestBatchMsg, self._on_request_batch, allow=allow_own_primary
        )
        self.server.route(
            RequestBatchesMsg, self._on_request_batches, allow=allow_own_primary
        )
        self.server.route(
            DeleteBatchesMsg, self._on_delete_batches, allow=allow_own_primary
        )
        self.server.route(ReconfigureMsg, self._on_reconfigure, allow=allow_own_primary)
        self.server.route(
            BackpressureMsg, self._on_backpressure, allow=allow_own_primary
        )
        self.tx_server.route(SubmitTransactionMsg, self._on_tx)
        self.tx_server.route(SubmitTransactionStreamMsg, self._on_tx_stream)

        primary_address = self.committee.primary_address(self.name)

        self._tasks = [
            BatchMaker(
                self.parameters.batch_size,
                self.parameters.max_batch_delay,
                self.tx_batch_maker,
                self.tx_quorum_waiter,
                self.rx_reconfigure,
                self.metrics,
                self.benchmark,
                pacing=self.batch_pacing,
            ).spawn(),
            QuorumWaiter(
                self.name,
                self.worker_id,
                self.committee,
                self.worker_cache,
                self.network,
                self.tx_quorum_waiter,
                self.tx_processor,
                self.rx_reconfigure,
            ).spawn(),
            Processor(
                self.worker_id,
                self.store,
                self.tx_processor,
                self.tx_digest,
                self.rx_reconfigure,
                self.metrics,
            ).spawn(),
            Processor(
                self.worker_id,
                self.store,
                self.tx_others_processor,
                self.tx_digest,
                self.rx_reconfigure,
                self.metrics,
            ).spawn(),
            PrimaryConnector(
                primary_address, self.network, self.tx_digest, self.rx_reconfigure
            ).spawn(),
            WorkerSynchronizer(
                self.name,
                self.worker_id,
                self.committee,
                self.worker_cache,
                self.parameters,
                self.store,
                self.network,
                self.tx_sync_command,
                self.tx_others_processor,
                self.rx_reconfigure,
                self.metrics,
            ).spawn(),
        ]
        # Benchmark-parsed boot line (worker/src/worker.rs:194-204).
        logger.info(
            "Worker %d successfully booted on %s", self.worker_id,
            self.transactions_address,
        )

    # -- handlers ---------------------------------------------------------
    # -- authorization predicates (handshake-verified peer identity) -------
    def _auth_sets(self) -> tuple[frozenset, frozenset]:
        def build():
            lane = frozenset(
                {self.worker_cache.worker(self.name, self.worker_id).name}
                | {
                    info.name
                    for _, info in self.worker_cache.others_workers(
                        self.name, self.worker_id
                    )
                }
                # Pooled links authenticate with the peer NODE's identity
                # (its authority network key), not the per-worker key —
                # the anemo node-granularity trust model: any committee
                # node may reach the batch plane, exactly the set whose
                # same-lane workers could anyway.
                | {a.network_key for a in self.committee.authorities.values()}
            )
            own_primary = frozenset({self.committee.network_key(self.name)})
            return lane, own_primary

        return cached_allow_sets(self, self.committee, self.worker_cache, build)

    def _allow_peer_worker(self, peer) -> bool:
        """Same-lane workers of any committee authority (incl. ourselves)."""
        return peer.key is not None and peer.key in self._auth_sets()[0]

    def _allow_own_primary(self, peer) -> bool:
        """Control-plane frames: only our own authority's primary."""
        return peer.key is not None and peer.key in self._auth_sets()[1]

    async def _on_peer_batch(self, msg: WorkerBatchMsg, peer: str):
        self.metrics.batches_received.inc()
        await self.tx_others_processor.send((msg.serialized_batch, False))
        return None

    async def _on_batch_request(self, msg: WorkerBatchRequest, peer: str):
        found = []
        for d in msg.digests:
            raw = self.store.read(d)
            if raw is not None:
                found.append(raw)
        return WorkerBatchResponse(tuple(found))

    async def _on_synchronize(self, msg: SynchronizeMsg, peer: str):
        await self.tx_sync_command.send(msg)
        return None

    async def _on_cleanup(self, msg: CleanupMsg, peer: str):
        await self.tx_sync_command.send(msg.round)
        return None

    async def _on_request_batch(self, msg: RequestBatchMsg, peer: str):
        raw = self.store.read(msg.digest)
        if raw is None:
            return RequestedBatchMsg(msg.digest, b"", found=False)
        # Serve the stored wire bytes as-is; decoding is the requester's.
        return RequestedBatchMsg(msg.digest, raw)

    async def _on_request_batches(self, msg: RequestBatchesMsg, peer: str):
        # One coalesced store read answers the whole group; entries are
        # byte-identical to the per-digest RequestBatchMsg responses.
        raws = self.store.read_all(msg.digests)
        return RequestedBatchesMsg(
            tuple(
                (d, raw is not None, raw if raw is not None else b"")
                for d, raw in zip(msg.digests, raws)
            )
        )

    async def _on_delete_batches(self, msg: DeleteBatchesMsg, peer: str):
        self.store.delete_all(msg.digests)
        return DeletedBatchesMsg(msg.digests)

    async def _on_reconfigure(self, msg: ReconfigureMsg, peer: str):
        committee = msg.committee()
        if committee is not None:
            self.committee = committee
        self.rx_reconfigure.send(ReconfigureNotification(msg.kind, committee))
        return None

    async def _on_backpressure(self, msg: BackpressureMsg, peer: str):
        self.backpressure.update(msg.level)
        return None

    async def _on_tx(self, msg: SubmitTransactionMsg, peer: str):
        # Admission control first: shedding raises IngestOverloadError,
        # which the RPC server surfaces to the client as an ERR frame whose
        # text carries the RESOURCE_EXHAUSTED prefix verbatim.
        await self.ingest_gate.admit()
        self.metrics.tx_received.inc()
        tx = msg.transaction
        frame = len(tx).to_bytes(4, "little") + tx
        await self.tx_batch_maker.send((1, frame))
        return None

    async def _on_tx_stream(self, msg: SubmitTransactionStreamMsg, peer: str):
        # Bursts stay in wire form: validate the frame structure (the only
        # per-tx work, two unpacks each, no copies) and forward the whole
        # chunk as one channel item straight into batch sealing.
        count = msg.count
        if count == 0:
            return None  # empty submission: no-op, never an empty batch
        await self.ingest_gate.admit()
        frames = msg.frames
        validate_tx_frames(frames, count)
        self.metrics.tx_received.inc(count)
        await self.tx_batch_maker.send((count, frames))
        return None

    # -- lifecycle --------------------------------------------------------
    async def shutdown(self) -> None:
        self.rx_reconfigure.send(ReconfigureNotification("shutdown"))
        for t in self._tasks:
            t.cancel()
        await drain_cancelled(self._tasks, who="worker")
        if self.pool is not None:
            from ..network import worker_lane

            self.pool.unregister_lane(worker_lane(self.worker_id))
        await self.server.stop()
        await self.tx_server.stop()
        if hasattr(self, "grpc_transactions"):
            await self.grpc_transactions.shutdown()
        self.network.close()
