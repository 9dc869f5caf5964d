"""Node assembly: wire storage, primary, consensus, executor and workers.

Port copy of `narwhal_tpu/node.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.
What differs is the device plane:

- the backends are `cpu | pool | cuda` (crypto) and `cpu | cuda` (DAG),
  where the JAX node has `tpu`, and both default to `cuda` (the JAX node's
  default is `cpu`); `PrimaryNode(device=...)` names the device
  the `cuda` backends run on: None means the card, and a missing card
  raises; the tests pass "cpu", which runs the kernels' plain versions;
- the boot rules and their ConfigErrors are the reference's, with "cuda"
  for "tpu";
- there is no fallback from the card to the host. Under `cuda`, every
  error raised while building the card's `VerifyService` ends the boot,
  under either verify rule, as the original error (a missing card is a
  RuntimeError, a mis-sized `--verify-shards` a ConfigError): the JAX node
  degrades a strict-rule node to the host pool instead, which would run a
  committee member on the CPU while it claims the card;
- an unknown backend name (the JAX node's `tpu` among them) is a
  ConfigError, where the JAX node runs any crypto backend it does not
  know as `cpu`;
- `--dag-shards k` takes `gpu.mesh.auth_mesh(k)`, the first k cards (or
  k copies of an explicit `device`), and raises ConfigError with fewer,
  where the JAX node falls back to virtual CPU devices;
- shutdown has no prewarm threads to join (the CUDA kernels take no
  shape-specific compile).

Reference: narwhal/node/src/lib.rs — NodeStorage::reopen :43-124,
Node::spawn_primary :134-282 (internal_consensus=true => Bullshark + executor
under partial synchrony; false => the external Dag service under asynchrony),
spawn_consensus :284-370, spawn_workers :373-407; NodeRestarter
(node/src/restarter.rs:18-) tears the node down and respawns it on committee
change with a fresh store per epoch.
"""

from __future__ import annotations

import asyncio
import logging
import os

from .channels import Channel, drain_cancelled, metered_channel
from .config import Committee, ConfigError, Parameters, WorkerCache
from .consensus import Bullshark, Consensus, Dag, Tusk
from .consensus.metrics import ConsensusMetrics
from .crypto import KeyPair, SignatureService
from .executor import (
    ExecutionIndices,
    ExecutionState,
    Executor,
    get_restored_consensus_output,
)
from .metrics import Registry
from .primary import NetworkModel, Primary
from .primary.api_server import ConsensusApi
from .primary.block_remover import BlockRemover
from .primary.block_synchronizer import BlockSynchronizer
from .primary.block_waiter import BlockWaiter
from .stores import NodeStorage
from .tracing import Tracer
from .types import ConsensusOutput, PublicKey
from .worker import Worker

logger = logging.getLogger("narwhal.node")


class SimpleExecutionState(ExecutionState):
    """No-op application persisting its execution cursor in the node's store
    (narwhal/node/src/execution_state.rs:9-60)."""

    def __init__(self, storage: NodeStorage | None = None):
        self._cf = (
            storage.engine.column_family("execution_indices")
            if storage is not None
            else None
        )
        self._indices = ExecutionIndices()

    async def handle_consensus_transaction(self, output, indices, transaction):
        self._indices = indices
        if self._cf is not None:
            self._cf.put(b"indices", indices.to_bytes())
        return b""

    async def load_execution_indices(self) -> ExecutionIndices:
        if self._cf is not None:
            raw = self._cf.get(b"indices")
            if raw is not None:
                self._indices = ExecutionIndices.from_bytes(raw)
        return self._indices


class PrimaryNode:
    """One authority's primary role: Primary + Consensus + Executor
    (Node::spawn_primary, node/src/lib.rs:134-282)."""

    def __init__(
        self,
        keypair: KeyPair,
        committee: Committee,
        worker_cache: WorkerCache,
        parameters: Parameters,
        storage: NodeStorage,
        execution_state: ExecutionState | None = None,
        internal_consensus: bool = True,
        consensus_protocol: str = "bullshark",
        registry: Registry | None = None,
        crypto_backend: str = "cuda",  # cpu | pool | cuda
        dag_backend: str = "cuda",  # cpu | cuda
        dag_shards: int = 1,  # devices on the mesh's 'auth' axis (cuda backend)
        verify_shards: int = 1,  # devices on the verifier's 'data' axis (cuda)
        network_keypair: KeyPair | None = None,
        commit_tap=None,  # callable(ConsensusOutput): simnet oracle hook
        device=None,  # the cuda backends' device: None = the card; "cpu" for tests
        crypto_pool=None,  # replaces the backend's pool (simnet's card pool)
    ):
        self.keypair = keypair
        self.name: PublicKey = keypair.public
        self.committee = committee
        self.worker_cache = worker_cache
        self.parameters = parameters
        self.storage = storage
        self.registry = registry or Registry()
        self.internal_consensus = internal_consensus
        # One tracer + flight recorder per node, shared by every role-level
        # metrics object (worker seal spans live on the WorkerNode's own
        # tracer): span emission is keyed on the same causal digests on
        # every node, so cross-stage waterfalls stitch without new wire
        # bytes. Off (zero-overhead ring of instants only) unless
        # NARWHAL_TRACE=1.
        self.tracer = Tracer(node=f"primary-{self.name.hex()[:8]}")
        # Group-commit instruments (fused-WAL group size / flush latency).
        storage.engine.attach_metrics(self.registry)
        # Registered at assembly (not inside the monitor coroutine) so the
        # metrics catalog extractor sees the full surface without spawning.
        self._backpressure_gauge = self.registry.gauge(
            "node_backpressure_level",
            "Downstream backlog level pushed to our workers (max of channel "
            "occupancy, commit-latency-vs-target, and commit-stall signals)",
        )

        # Channels between the three subsystems (node/src/lib.rs:150-192),
        # depth-gauged like the reference's porcelain metrics (lib.rs:168-192).
        def chan(name: str, capacity: int) -> Channel:
            return metered_channel(self.registry, "node", name, capacity)

        self.tx_new_certificates = chan("new_certificates", 10_000)
        self.tx_committed_certificates = chan("committed_certificates", 10_000)
        self.tx_consensus_output = chan("consensus_output", 10_000)
        self.tx_execution_output = chan("execution_output", 10_000)
        # Accepted-certificate tap -> speculative payload prefetcher: batch
        # digests are known at DAG acceptance, rounds before commit, so the
        # executor can warm its temp batch store off the critical path.
        # NARWHAL_PREFETCH_BUDGET (bytes) overrides the committee file;
        # budget 0 disables the prefetcher and the tap entirely.
        prefetch_budget = int(
            os.environ.get(
                "NARWHAL_PREFETCH_BUDGET",
                getattr(parameters, "prefetch_budget", 64 << 20),
            )
        )
        self.tx_accepted_certificates = (
            chan("accepted_certificates", 10_000)
            if internal_consensus and prefetch_budget > 0
            else None
        )

        # Crypto backend (the --crypto-backend flag of SURVEY §7.8c):
        #   cpu  — inline host verification in the Core (reference
        #          behavior) for full-format committees; under the compact
        #          default it gains the async stage below so certificate
        #          proofs batch (see the cert_format branch)
        #   pool — async coalescing stage over the host library
        #   cuda — the process-wide VerifyService over the card's kernels
        # The accept set is a COMMITTEE-WIDE parameter (Parameters.
        # verify_rule), validated here at startup: the host library is
        # cofactorless ("strict"), the card's msm batch kernel is RFC-8032
        # cofactored — a committee mixing the two can permanently disagree
        # on adversarially crafted torsion signatures.
        # Committee-wide knobs are validated here at assembly with
        # ConfigError — operator mistakes must stop the boot symmetrically
        # (a verify_rule typo used to fall through to backend-specific
        # errors while cert_format failed fast).
        rule = getattr(parameters, "verify_rule", "strict")
        if rule not in ("strict", "cofactored"):
            raise ConfigError(
                f"parameters.verify_rule must be strict|cofactored, got {rule!r}"
            )
        # cert_format is committee-wide wire format: a typo silently
        # behaving as the non-default form would mix certificate wire forms
        # instead of failing fast (advisor r4). Compact is the default on
        # EVERY backend (each has a batched cofactored proof-verify path);
        # 'full' is the opt-out, and all nodes accept both forms on the
        # wire regardless.
        cert_format = getattr(parameters, "cert_format", "compact")
        if cert_format not in ("full", "compact"):
            raise ConfigError(
                f"parameters.cert_format must be full|compact, got {cert_format!r}"
            )
        # header_wire only selects what WE send (every node accepts both
        # forms), but a typo silently behaving as "full" would quietly
        # forfeit the wire diet — fail fast like cert_format.
        header_wire = getattr(parameters, "header_wire", "full")
        if header_wire not in ("full", "delta"):
            raise ConfigError(
                f"parameters.header_wire must be full|delta, got {header_wire!r}"
            )
        if rule == "cofactored" and crypto_backend != "cuda":
            raise ConfigError(
                "parameters.verify_rule=cofactored: only the cuda crypto "
                f"backend implements the cofactored PER-ITEM accept set (got "
                f"crypto_backend={crypto_backend!r}). Use --crypto-backend "
                "cuda on every node, or set verify_rule=strict. (Compact "
                "certificate proofs are cofactored on every backend and do "
                "not require this rule.)"
            )
        if verify_shards > 1 and crypto_backend != "cuda":
            raise ConfigError(
                f"--verify-shards {verify_shards} requires --crypto-backend "
                f"cuda (got {crypto_backend!r})"
            )
        # A pool the caller built takes the place of the one the backend
        # would build, after the same rule checks: simnet's card pool
        # (`simnet.SimCluster._crypto_pool`) launches on the loop's thread,
        # where the shared VerifyService's threads would race the virtual
        # clock.
        given_pool, crypto_pool = crypto_pool, None
        if crypto_backend not in ("cpu", "pool", "cuda"):
            raise ConfigError(
                f"--crypto-backend must be cpu|pool|cuda, got {crypto_backend!r}"
            )
        if given_pool is not None:
            crypto_pool = given_pool
        elif crypto_backend == "cuda":
            from .gpu.verifier import VerifyService

            if rule == "cofactored":
                logger.warning(
                    "verify_rule=cofactored: EVERY node in this "
                    "committee must run --crypto-backend cuda; a cpu/pool "
                    "node (strict rule) in the same committee is a "
                    "consensus-split hazard on crafted torsion signatures"
                )
            mode = "msm" if rule == "cofactored" else "item"
            # ONE pipelined service per process (and mode, shard count and
            # device): every node on this host shares flushes, so a launch
            # carries the merged items of every protocol hop of every
            # co-hosted node. --verify-shards N spreads every flush over an
            # N-device 'data' mesh (verifier.data_mesh); bucket
            # divisibility is validated inside the GpuVerifier constructor,
            # so a mis-sized mesh fails the boot, not the first dispatch.
            # Whatever this raises ends the boot: no host fallback.
            crypto_pool = VerifyService.shared(
                mode,
                shards=verify_shards,
                device=device,
                devices=(
                    [device] * verify_shards
                    if verify_shards > 1 and device is not None
                    else None
                ),
            )
        elif crypto_backend == "pool":
            from .gpu.verifier import AsyncVerifierPool

            crypto_pool = AsyncVerifierPool()
        elif cert_format == "compact":
            # cpu backend under the compact default: certificate proofs
            # must ride the batched aggregate lane, not per-certificate
            # inline host verification in the Core — the verifier stage's
            # concurrent submissions coalesce into one
            # host_batch_verify_aggregates MSM per flush (certificate
            # GROUPS per dispatch, the host analog of the device group
            # lane). Headers/votes share the stage's host batch path, same
            # strict accept set as inline verification.
            from .gpu.verifier import AsyncVerifierPool

            crypto_pool = AsyncVerifierPool()
        self.crypto_pool = crypto_pool

        self.primary = Primary(
            self.name,
            SignatureService(keypair),
            committee,
            worker_cache,
            parameters,
            storage,
            self.tx_new_certificates,
            self.tx_committed_certificates,
            network_model=(
                NetworkModel.PARTIALLY_SYNCHRONOUS
                if internal_consensus
                else NetworkModel.ASYNCHRONOUS
            ),
            registry=self.registry,
            crypto_pool=crypto_pool,
            network_keypair=network_keypair,
            tracer=self.tracer,
        )

        self.consensus: Consensus | None = None
        self.executor: Executor | None = None
        self.dag: Dag | None = None
        self.execution_state = execution_state or SimpleExecutionState(storage)
        if dag_shards > 1 and dag_backend != "cuda":
            raise ConfigError(
                f"--dag-shards {dag_shards} requires --dag-backend cuda "
                f"(got {dag_backend!r})"
            )
        if dag_backend not in ("cpu", "cuda"):
            raise ConfigError(f"--dag-backend must be cpu|cuda, got {dag_backend!r}")
        if internal_consensus:
            # --dag-backend cuda: the commit walk runs on the card via the
            # window kernels (the reference's consensus/src/utils.rs:11-101
            # hot loop, vectorized).
            if dag_backend == "cuda":
                from .gpu.dag_kernels import GpuBullshark, GpuTusk

                protocol_cls = {"bullshark": GpuBullshark, "tusk": GpuTusk}[
                    consensus_protocol
                ]
                # --dag-shards > 1: shard the committee axis of the window
                # over an 'auth' mesh of cards. Too few cards raise
                # ConfigError (never a silent CPU mesh); an explicit device
                # repeats it k times (the tests' CPU mesh, one card twice).
                mesh = None
                if dag_shards > 1:
                    from .gpu.mesh import auth_mesh

                    mesh = auth_mesh(
                        dag_shards,
                        devices=None if device is None else [device] * dag_shards,
                    )
                protocol = protocol_cls(
                    committee, storage.consensus_store, parameters.gc_depth,
                    device=None if mesh is not None else device, mesh=mesh,
                )
            else:
                protocol_cls = {"bullshark": Bullshark, "tusk": Tusk}[
                    consensus_protocol
                ]
                protocol = protocol_cls(
                    committee, storage.consensus_store, parameters.gc_depth
                )
            self.consensus_metrics = ConsensusMetrics(
                self.registry, tracer=self.tracer
            )
            self.consensus = Consensus(
                committee,
                protocol,
                storage.consensus_store,
                storage.certificate_store,
                self.tx_new_certificates,
                self.tx_committed_certificates,
                self.tx_consensus_output,
                self.primary.tx_reconfigure,
                parameters.gc_depth,
                self.consensus_metrics,
                tx_accepted=self.tx_accepted_certificates,
                commit_tap=commit_tap,
            )
            self.executor = Executor(
                self.name,
                worker_cache,
                storage,
                self.execution_state,
                self.primary.network,
                self.tx_consensus_output,
                self.tx_execution_output,
                registry=self.registry,
                rx_accepted=self.tx_accepted_certificates,
                gc_depth=parameters.gc_depth,
                prefetch_budget=prefetch_budget,
                tracer=self.tracer,
            )
        else:
            # External consensus: the Dag service consumes the certificate
            # stream and serves causal queries (node/src/lib.rs:198-213).
            # With --dag-backend cuda, ReadCausal/NodeReadCausal run as one
            # reach_many launch over the dense window on the card.
            self.dag = Dag(
                committee,
                self.tx_new_certificates,
                backend=dag_backend,
                metrics=ConsensusMetrics(self.registry),
                device=device,
            )

        # Block services + the public consensus API (primary/src/grpc_server).
        self.block_synchronizer = BlockSynchronizer(
            self.name,
            committee,
            worker_cache,
            storage.certificate_store,
            storage.payload_store,
            self.primary.network,
            parameters,
            tx_loopback=self.primary.tx_primary_messages,
            # Catch-up verification rides the same batched lane as live
            # traffic (compact-certificate catch-up must not fall back to
            # pure-Python aggregate verification on cuda-backend nodes).
            crypto_pool=crypto_pool,
        )
        self.block_waiter = BlockWaiter(
            self.name,
            worker_cache,
            storage.certificate_store,
            self.primary.network,
            self.block_synchronizer,
        )
        self.block_remover = BlockRemover(
            self.name,
            worker_cache,
            storage.certificate_store,
            storage.header_store,
            storage.payload_store,
            self.primary.network,
            dag=self.dag,
        )
        self.api = ConsensusApi(
            self.name,
            committee,
            self.block_waiter,
            self.block_remover,
            dag=self.dag,
            registry=self.registry,
            tracer=self.tracer,
        )
        # The interoperable public edge (tonic parity): gRPC services over
        # the same seams, mounted on consensus_api_grpc_address.
        from .grpc_api import GrpcPublicApi

        self.grpc_api = GrpcPublicApi(
            self.name,
            committee,
            self.block_waiter,
            self.block_remover,
            dag=self.dag,
            registry=self.registry,
            tracer=self.tracer,
        )
        self.api_address: str = ""
        self.grpc_api_address: str = ""
        self._tasks: list[asyncio.Task] = []

    @property
    def address(self) -> str:
        return self.primary.address

    async def spawn(self) -> None:
        restored: list[ConsensusOutput] = []
        if self.internal_consensus:
            restored = await get_restored_consensus_output(
                self.storage.consensus_store,
                self.storage.certificate_store,
                self.execution_state,
            )
            if restored:
                logger.info("Replaying %d consensus outputs after restart", len(restored))
        await self.primary.spawn()
        if self.consensus is not None:
            self._tasks.append(self.consensus.spawn())
        if self.executor is not None:
            self._tasks.extend(await self.executor.spawn(restored))
        if self.dag is not None:
            self._tasks.append(self.dag.spawn())
        if self.internal_consensus:
            # End-to-end admission control: sample the commit/execution
            # backlog and push the level to our own workers so their
            # client-facing ingest can shed/block before the backlog grows
            # without bound (the worker fails open if these pushes stop).
            self._tasks.append(asyncio.ensure_future(self._backpressure_monitor()))
        # gRPC owns the configured public address (tonic parity); the typed
        # TCP api binds an ephemeral port for in-framework clients. Under
        # the simnet transport the typed api rides the fabric like every
        # other RpcServer, but grpc.aio binds REAL sockets — skipped there,
        # keeping simulated committees at zero sockets (the interop edge is
        # meaningless inside a simulation anyway).
        from .network import transport as _transport

        self.api.set_primary_address(self.primary.address)
        self.api_address = await self.api.spawn("127.0.0.1:0")
        if _transport.simnet_active():
            self.grpc_api_address = ""
        else:
            self.grpc_api.set_primary_address(self.primary.address)
            self.grpc_api_address = await self.grpc_api.spawn(
                self.parameters.consensus_api_grpc_address
            )
        # Restart catch-up (block_synchronizer/mod.rs:75-83 SynchronizeRange):
        # collect certificates peers accumulated while we were down.
        last_round = self.storage.certificate_store.last_round()
        if last_round > 0:
            async def catch_up() -> None:
                try:
                    fetched = await self.block_synchronizer.synchronize_range(
                        last_round
                    )
                    if fetched:
                        logger.info(
                            "Catch-up: fetched %d certificates past round %d",
                            len(fetched),
                            last_round,
                        )
                except Exception:
                    logger.debug("restart catch-up failed", exc_info=True)

            self._tasks.append(asyncio.ensure_future(catch_up()))

    async def _backpressure_monitor(self) -> None:
        """Executor backlog -> consensus runner -> primary -> worker ingest:
        the push leg of the admission-control loop. The level folds channel
        occupancy, the commit-stage latency EWMA vs commit_latency_target,
        and a commit-stall detector (pacing.backpressure_level — measured
        overload on this class of host is service-time saturation with
        shallow channels, so depth alone is blind). Delivery is best-effort
        unreliable_send every poll interval — workers treat a silent
        primary as level 0 after backpressure_stale_after (fail open), so
        this task can die without wedging client ingest."""
        from . import clock
        from .config import env_float
        from .messages import BackpressureMsg
        from .pacing import backpressure_level

        gauge = self._backpressure_gauge
        interval = self.parameters.backpressure_poll_interval
        target = env_float(
            "NARWHAL_COMMIT_LATENCY_TARGET", self.parameters.commit_latency_target
        )
        channels = [
            self.tx_new_certificates,
            self.tx_consensus_output,
            self.tx_execution_output,
            # Primary-side saturation: a deep protocol-ingest or
            # pending-digest queue means the core/proposer can't keep up
            # even before consensus output backs up.
            self.primary.tx_primary_messages,
            self.primary.tx_our_digests,
        ]
        if self.executor is not None:
            channels.append(self.executor.tx_executor)
        channel_names = (
            "new_certificates",
            "consensus_output",
            "execution_output",
            "primary_messages",
            "our_digests",
            "executor_core",
        )
        commit_counter = self.consensus_metrics.committed_certificates
        commit_timer = self.consensus_metrics.commit_timer
        last_committed = commit_counter.get()
        last_commit_t = clock.now()
        # Dump-on-anomaly: the first poll that sees the commit pipeline
        # silent for stall_after seconds snapshots every live flight
        # recorder (re-armed when commits resume, so a long outage yields
        # one dump per stall episode, not one per poll).
        stall_after = env_float(
            "NARWHAL_COMMIT_STALL_AFTER", max(5.0, 10.0 * target)
        )
        stall_armed = True
        while True:
            committed = commit_counter.get()
            if committed != last_committed:
                last_committed, last_commit_t = committed, clock.now()
                stall_armed = True
            stale = (clock.now() - last_commit_t) if committed > 0 else None
            level = backpressure_level(
                (ch.occupancy() for ch in channels),
                # Monitoring read of the stage timers' EWMA: a one-tick
                # stale value only delays the admission level by one poll
                # interval — racy-read-tolerant by design.
                commit_timer.ewma,  # lint: allow(multi-task-mutation)
                stale,
                target,
                self.parameters.backpressure_high_watermark,
            )
            gauge.set(level)
            # Flight-recorder breadcrumb: channel occupancy + admission
            # level each poll, always on (instants ride the bounded ring
            # regardless of NARWHAL_TRACE).
            self.tracer.instant(
                "backpressure",
                level=round(level, 4),
                committed=committed,
                occupancy={
                    n: ch.qsize() for n, ch in zip(channel_names, channels)
                },
            )
            if stall_armed and stale is not None and stale > stall_after:
                stall_armed = False
                from . import tracing

                tracing.on_anomaly(
                    f"commit_stall node={self.name.hex()[:8]} "
                    f"stale={stale:.1f}s committed={committed}"
                )
            msg = BackpressureMsg.from_level(level)
            workers = self.worker_cache.our_workers(self.name).values()
            await asyncio.gather(
                *(
                    self.primary.network.unreliable_send(
                        info.worker_address, msg, timeout=interval
                    )
                    for info in workers
                )
            )
            await asyncio.sleep(interval)

    async def shutdown(self) -> None:
        # Park this node's flight recorder in the module archive first:
        # post-mortem dumps (test hooks, scenario teardown) must survive
        # the tracer's owner being garbage collected.
        self.tracer.archive()
        for t in self._tasks:
            t.cancel()
        await drain_cancelled(self._tasks, who="primary-node")
        await self.api.shutdown()
        await self.grpc_api.shutdown()
        await self.primary.shutdown()
        if self.crypto_pool is not None:
            # AsyncVerifierPool drains its in-flight batch tasks; the
            # process-shared VerifyService makes this a deliberate no-op
            # (other co-hosted nodes, and the next in-process cluster, keep
            # using it): close(), never shutdown().
            await self.crypto_pool.close()
        self.storage.close()


class WorkerNode:
    """One authority's worker role (Node::spawn_workers, lib.rs:373-407)."""

    def __init__(
        self,
        name: PublicKey,
        worker_id: int,
        committee: Committee,
        worker_cache: WorkerCache,
        parameters: Parameters,
        storage: NodeStorage,
        registry: Registry | None = None,
        benchmark: bool = False,
        network_keypair: KeyPair | None = None,
    ):
        self.registry = registry or Registry()
        self.storage = storage
        self.tracer = Tracer(node=f"worker-{name.hex()[:8]}-{worker_id}")
        self.worker = Worker(
            name,
            worker_id,
            committee,
            worker_cache,
            parameters,
            storage.batch_store,
            registry=self.registry,
            benchmark=benchmark,
            network_keypair=network_keypair,
            tracer=self.tracer,
        )

    async def spawn(self) -> None:
        await self.worker.spawn()

    async def shutdown(self) -> None:
        self.tracer.archive()
        await self.worker.shutdown()
        self.storage.close()


class NodeRestarter:
    """Tear down and respawn a primary on committee change
    (narwhal/node/src/restarter.rs:18-): each epoch gets a fresh
    in-memory store unless a store factory is provided. Every epoch's node
    takes PrimaryNode's default backends (the card)."""

    def __init__(
        self,
        keypair: KeyPair,
        worker_cache: WorkerCache,
        parameters: Parameters,
        store_factory=None,
        execution_state_factory=None,
        network_keypair: KeyPair | None = None,
    ):
        self.keypair = keypair
        self.worker_cache = worker_cache
        self.parameters = parameters
        self.network_keypair = network_keypair
        self.store_factory = store_factory or (lambda epoch: NodeStorage(None))
        self.execution_state_factory = execution_state_factory
        self.node: PrimaryNode | None = None

    async def start(self, committee: Committee) -> PrimaryNode:
        storage = self.store_factory(committee.epoch)
        execution_state = (
            self.execution_state_factory(storage)
            if self.execution_state_factory
            else None
        )
        self.node = PrimaryNode(
            self.keypair,
            committee,
            self.worker_cache,
            self.parameters,
            storage,
            execution_state=execution_state,
            network_keypair=self.network_keypair,
        )
        await self.node.spawn()
        return self.node

    async def restart(self, new_committee: Committee) -> PrimaryNode:
        if self.node is not None:
            await self.node.shutdown()
        return await self.start(new_committee)
