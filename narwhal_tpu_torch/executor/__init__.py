"""The executor: pulls ordered certificates and applies them to the app.

Port copy of `narwhal_tpu/executor/__init__.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference crate: narwhal/executor/ (see SURVEY §2.10). Assembly
mirrors Executor::spawn (executor/src/lib.rs:89-145): a Subscriber staging
payloads in consensus order feeding an ExecutorCore that applies transactions
exactly-once over crashes.
"""

from __future__ import annotations

import asyncio

from ..channels import Channel, metered_channel
from ..config import WorkerCache
from ..network import NetworkClient
from ..stores import CertificateStore, ConsensusStore, NodeStorage
from ..types import ConsensusOutput, PublicKey
from .metrics import ExecutorMetrics
from .core import (
    ClientExecutionError,
    ExecutionState,
    ExecutionStateError,
    ExecutorCore,
)
from .prefetcher import Prefetcher
from .state import ExecutionIndices
from .subscriber import Subscriber

__all__ = [
    "ClientExecutionError",
    "ExecutionIndices",
    "ExecutionState",
    "ExecutionStateError",
    "Executor",
    "ExecutorCore",
    "Prefetcher",
    "Subscriber",
    "get_restored_consensus_output",
]


async def get_restored_consensus_output(
    consensus_store: ConsensusStore,
    certificate_store: CertificateStore,
    execution_state: ExecutionState,
) -> list[ConsensusOutput]:
    """Crash recovery (narwhal/executor/src/lib.rs:147-185): replay
    every sequenced certificate at or past the executor's certificate cursor."""
    indices = await execution_state.load_execution_indices()
    out: list[ConsensusOutput] = []
    for index, digest in consensus_store.read_sequenced_digests_after(
        indices.next_certificate_index
    ):
        certificate = certificate_store.read(digest)
        if certificate is not None:
            out.append(ConsensusOutput(certificate, index))
    return out


class Executor:
    """Subscriber + ExecutorCore pair (executor/src/lib.rs:89-145)."""

    def __init__(
        self,
        name: PublicKey,
        worker_cache: WorkerCache,
        storage: NodeStorage,
        execution_state: ExecutionState,
        network: NetworkClient,
        rx_consensus: Channel,
        tx_output: Channel | None = None,
        registry=None,
        rx_accepted: Channel | None = None,  # accepted-certificate tap
        gc_depth: int = 50,
        prefetch_budget: int | None = None,  # bytes; 0/None w/o tap disables
        tracer=None,
    ):
        metrics = (
            ExecutorMetrics(registry, tracer=tracer)
            if registry is not None
            else None
        )
        # Staged-payload hand-off (subscriber -> core), depth-gauged like
        # every other inter-actor edge: its occupancy is one of the signals
        # the node's backpressure monitor folds into the admission level.
        self.tx_executor = (
            metered_channel(registry, "executor", "core", 1_000)
            if registry is not None
            else Channel(1_000)
        )
        self.prefetcher: Prefetcher | None = None
        if rx_accepted is not None and (prefetch_budget is None or prefetch_budget > 0):
            self.prefetcher = Prefetcher(
                name,
                worker_cache,
                network,
                storage.temp_batch_store,
                rx_accepted,
                gc_depth=gc_depth,
                **(
                    {"budget_bytes": prefetch_budget}
                    if prefetch_budget is not None
                    else {}
                ),
                metrics=metrics,
            )
        self.subscriber = Subscriber(
            name,
            worker_cache,
            network,
            storage.temp_batch_store,
            rx_consensus,
            self.tx_executor,
            metrics=metrics,
            prefetcher=self.prefetcher,
        )
        self.core = ExecutorCore(
            execution_state,
            storage.temp_batch_store,
            self.tx_executor,
            tx_output,
            metrics=metrics,
        )
        self._tasks: list[asyncio.Task] = []

    async def spawn(
        self, restored: list[ConsensusOutput] | None = None
    ) -> list[asyncio.Task]:
        self._tasks = [self.subscriber.spawn(), self.core.spawn()]
        if self.prefetcher is not None:
            self._tasks.append(self.prefetcher.spawn())
        # Re-inject restored outputs ahead of live traffic (lib.rs:120-135).
        for output in restored or []:
            await self.subscriber.rx_consensus.send(output)
        return self._tasks

    def shutdown(self) -> None:
        for t in self._tasks:
            t.cancel()
