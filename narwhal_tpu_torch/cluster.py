"""In-process multi-node cluster for integration tests and local benchmarks.

Port copy of `narwhal_tpu/cluster.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.
Its backends are the port node's (`cpu | pool | cuda`, `cpu | cuda`, both
`cuda` by default where the JAX cluster's are `cpu`), and
`Cluster(device=...)` names the device the `cuda` backends of every node run
on: None means the card, checked when the cluster is built (a missing card
raises before any port is bound); the tests pass "cpu".

Reference: narwhal/test_utils/src/cluster.rs:31-793 — a whole
committee in one process: every authority runs a real primary (with consensus
and executor) plus workers as asyncio tasks over real loopback TCP, with
per-node registries; progress is asserted by scraping metrics
(assert_progress, cluster.rs:210-269).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import replace

from . import clock, tracing
from .config import (
    Authority,
    Committee,
    Parameters,
    WorkerCache,
    WorkerInfo,
    get_available_port,
)
from .fixtures import CommitteeFixture
from .metrics import Registry
from .node import PrimaryNode, SimpleExecutionState, WorkerNode
from .stores import NodeStorage
from .types import PublicKey

logger = logging.getLogger("narwhal.cluster")


class AuthorityDetails:
    """Handles for one authority's roles (cluster.rs AuthorityDetails)."""

    def __init__(self, cluster: "Cluster", index: int, name: PublicKey):
        self.cluster = cluster
        self.index = index
        self.name = name
        self.primary: PrimaryNode | None = None
        self.workers: dict[int, WorkerNode] = {}
        self.store_path: str | None = None

    @property
    def registry(self) -> Registry | None:
        return self.primary.registry if self.primary else None

    def metric(self, name: str) -> float:
        """Scrape one gauge/counter from the primary's registry
        (cluster.rs:315 PrimaryNodeDetails::metric)."""
        return self.primary.registry.value(name)

    def worker_transactions_address(self, worker_id: int = 0) -> str:
        return self.cluster.worker_cache.worker(self.name, worker_id).transactions

    def worker_transactions_addresses(self) -> list[str]:
        """All W client-facing lanes of this validator, in worker-id order —
        what a sharding client round-robins across."""
        return [
            self.cluster.worker_cache.worker(self.name, wid).transactions
            for wid in sorted(self.workers)
        ]

    async def stop_worker(self, worker_id: int) -> None:
        """Kill ONE worker lane (the worker-loss fault of ROADMAP item 3's
        scenario axis); the primary and the other W-1 pipelines keep
        running."""
        w = self.workers.pop(worker_id, None)
        if w is not None:
            await w.shutdown()

    async def stop(self) -> None:
        if self.primary is not None:
            await self.primary.shutdown()
            self.primary = None
        for w in self.workers.values():
            await w.shutdown()
        self.workers.clear()


class Cluster:
    def __init__(
        self,
        size: int = 4,
        workers: int = 1,
        parameters: Parameters | None = None,
        internal_consensus: bool = True,
        benchmark: bool = False,
        store_base: str | None = None,
        crypto_backend: str = "cuda",
        dag_backend: str = "cuda",
        dag_shards: int = 1,
        consensus_protocol: str = "bullshark",
        max_header_delay: float = 0.05,
        max_batch_delay: float = 0.05,
        auth: bool = True,
        device=None,  # the cuda backends' device: None = the card; "cpu" for tests
    ):
        if "cuda" in (crypto_backend, dag_backend):
            from .gpu import resolve_device

            resolve_device(device)  # no card: raise before binding a port
        # Each cluster is a fresh tracer incarnation: successive in-process
        # clusters reuse node labels and (seeded fixtures) certificate
        # digests, so without the bump `tracing.live_dumps()` would merge a
        # prior cluster's spans into this one's waterfalls.
        tracing.new_generation()
        self.fixture = CommitteeFixture(size=size, workers=workers)
        # The delay kwargs override the fixture defaults (fast rounds for
        # tests) but an explicitly passed Parameters wins outright — latency
        # tests/benches can exercise real configurations either way.
        self.parameters = parameters or replace(
            self.fixture.parameters,
            max_header_delay=max_header_delay,
            max_batch_delay=max_batch_delay,
        )
        if crypto_backend == "cuda" and parameters is None:
            # Default only: every node in this in-process cluster runs the
            # cuda backend, so the committee can uniformly use the
            # cofactored accept set (the msm batch kernel). An explicitly
            # passed Parameters keeps its verify_rule — callers may want
            # the strict per-item kernel on the cuda backend.
            self.parameters = replace(self.parameters, verify_rule="cofactored")
        self.internal_consensus = internal_consensus
        self.benchmark = benchmark
        self.store_base = store_base
        self.crypto_backend = crypto_backend
        self.dag_backend = dag_backend
        self.dag_shards = dag_shards
        self.consensus_protocol = consensus_protocol
        self.device = device
        # auth=False skips the transport handshake/AEAD layer: servers run
        # open and clients connect plain. Only for harnesses where the
        # medium itself is trusted (simnet's in-memory fabric at large N,
        # where 2·N·(N-1) pure-Python X25519 handshakes dominate boot).
        self.auth = auth
        self._assign_addresses()
        self.committee: Committee = self.fixture.committee
        self.worker_cache: WorkerCache = self.fixture.worker_cache
        self.authorities: list[AuthorityDetails] = [
            AuthorityDetails(self, i, a.public)
            for i, a in enumerate(self.fixture.authorities)
        ]

    def _assign_addresses(self) -> None:
        """Pre-assign real loopback ports so no early broadcast targets a
        placeholder. The simnet cluster overrides this with fabric-owned
        synthetic addresses (zero sockets, zero fds)."""
        committee = self.fixture.committee
        for pk, auth in committee.authorities.items():
            committee.authorities[pk] = replace(
                auth, primary_address=f"127.0.0.1:{get_available_port()}"
            )
        for pk, ws in self.fixture.worker_cache.workers.items():
            for wid, info in ws.items():
                ws[wid] = WorkerInfo(
                    name=info.name,
                    transactions=f"127.0.0.1:{get_available_port()}",
                    worker_address=f"127.0.0.1:{get_available_port()}",
                )

    def _commit_tap(self, index: int):
        """Per-node commit observation hook handed to Consensus; the simnet
        cluster records (epoch, round, digest) sequences for the oracles."""
        return None

    def _crypto_pool(self, index: int):
        """Per-node crypto pool in place of the one the backend builds;
        None keeps the backend's. The simnet cluster's card pool launches
        on the loop's thread (`simnet.SimCluster._crypto_pool`)."""
        return None

    def _store(self, index: int, role: str) -> NodeStorage:
        if self.store_base is None:
            return NodeStorage(None)
        return NodeStorage(f"{self.store_base}/node-{index}-{role}")

    async def start_node(self, index: int) -> AuthorityDetails:
        """(cluster.rs start_node): boot one authority's primary + workers."""
        details = self.authorities[index]
        fixture_auth = self.fixture.authorities[index]
        storage = self._store(index, "primary")
        details.primary = PrimaryNode(
            fixture_auth.keypair,
            self.committee,
            self.worker_cache,
            self.parameters,
            storage,
            internal_consensus=self.internal_consensus,
            consensus_protocol=self.consensus_protocol,
            crypto_backend=self.crypto_backend,
            dag_backend=self.dag_backend,
            dag_shards=self.dag_shards,
            network_keypair=fixture_auth.network_keypair if self.auth else None,
            commit_tap=self._commit_tap(index),
            device=self.device,
            crypto_pool=self._crypto_pool(index),
        )
        await details.primary.spawn()
        for wid in range(self.fixture.workers_per_authority):
            wn = WorkerNode(
                fixture_auth.public,
                wid,
                self.committee,
                self.worker_cache,
                self.parameters,
                self._store(index, f"worker-{wid}"),
                benchmark=self.benchmark,
                network_keypair=(
                    fixture_auth.worker_keypairs[wid] if self.auth else None
                ),
            )
            await wn.spawn()
            details.workers[wid] = wn
        return details

    async def start(self, nodes: int | None = None) -> None:
        n = nodes if nodes is not None else len(self.authorities)
        for i in range(n):
            await self.start_node(i)

    async def stop_node(self, index: int) -> None:
        await self.authorities[index].stop()

    async def restart_node(self, index: int) -> AuthorityDetails:
        await self.stop_node(index)
        return await self.start_node(index)

    async def shutdown(self) -> None:
        for a in self.authorities:
            await a.stop()

    async def assert_progress(
        self,
        expected_nodes: int | None = None,
        commit_threshold: int = 1,
        timeout: float = 30.0,
    ) -> dict[PublicKey, float]:
        """Wait until every running node's last committed round reaches
        commit_threshold (cluster.rs assert_progress via metric scraping)."""
        expected = expected_nodes or sum(
            1 for a in self.authorities if a.primary is not None
        )
        deadline = clock.now() + timeout
        while True:
            rounds = {
                a.name: a.metric("consensus_last_committed_round")
                for a in self.authorities
                if a.primary is not None
            }
            ok = [r for r in rounds.values() if r >= commit_threshold]
            if len(ok) >= expected:
                return rounds
            if clock.now() > deadline:
                raise AssertionError(
                    f"no progress: committed rounds {rounds} < {commit_threshold}"
                )
            await asyncio.sleep(0.1)
