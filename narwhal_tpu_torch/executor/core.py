"""The execution Core: exactly-once transaction application across crashes.

Port copy of `narwhal_tpu/executor/core.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/executor/src/core.rs:30-260 — for each ordered
certificate, executes its batches transaction by transaction, skipping
anything at or before the persisted ExecutionIndices (crash replay),
distinguishing client errors (bad transaction: skip and advance) from node
errors (halt), and cleaning the temp batch store per certificate.

Batching delta from the reference: a staged batch's transactions drain as
one burst — application results buffer locally and flush to the output
channel with a single `send_many` per batch instead of one awaited channel
hop per transaction. The replay cursor still advances per transaction
(`ExecutionIndices.next` after every applied tx), so the skip-below-watermark
crash-replay semantics are byte-for-byte those of the per-tx loop.
"""

from __future__ import annotations

import asyncio
import logging

from ..channels import Channel
from ..stores import BatchStore
from ..types import Batch, ConsensusOutput
from .state import ExecutionIndices

logger = logging.getLogger("narwhal.executor")


class ExecutionStateError(Exception):
    """Node-level execution failure: halt (core.rs:86-127 node errors)."""


class ClientExecutionError(Exception):
    """Transaction-level failure: skip the transaction and advance."""


class ExecutionState:
    """The application interface (narwhal/executor/src/lib.rs:47-78).

    Implementations persist ExecutionIndices atomically with their own state
    inside handle_consensus_transaction."""

    async def handle_consensus_transaction(
        self, output: ConsensusOutput, indices: ExecutionIndices, transaction: bytes
    ):
        raise NotImplementedError

    async def load_execution_indices(self) -> ExecutionIndices:
        raise NotImplementedError

    def ask_consensus_write_lock(self) -> bool:
        return False

    def release_consensus_write_lock(self) -> None:
        pass


class ExecutorCore:
    def __init__(
        self,
        execution_state: ExecutionState,
        temp_batch_store: BatchStore,
        rx_subscriber: Channel,  # (output, batches, t_commit) staged
        tx_output: Channel | None = None,  # (outcome, transaction) to the app
        metrics=None,  # ExecutorMetrics (repo-specific progress counters)
    ):
        self.metrics = metrics
        self.execution_state = execution_state
        self.temp_batch_store = temp_batch_store
        self.rx_subscriber = rx_subscriber
        self.tx_output = tx_output
        self.execution_indices = ExecutionIndices()
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    async def run(self) -> None:
        self.execution_indices = await self.execution_state.load_execution_indices()
        try:
            while True:
                output, batches, t_commit = await self.rx_subscriber.recv()
                await self.execute_certificate(output, batches)
                if self.metrics is not None and t_commit is not None:
                    # Span-unified close: one call emits both the execute
                    # stage histogram sample and (when tracing) the span
                    # terminating this certificate's waterfall.
                    dt = self.metrics.execute_timer.close(
                        output.certificate.digest, t_commit
                    )
                    self.metrics.commit_to_exec_latency.observe(dt)
        except asyncio.CancelledError:
            raise
        except Exception:
            # Node-level failure (core.rs:86-127): execution halts while the
            # rest of the node keeps running — make that loudly visible.
            logger.critical("execution halted on node error", exc_info=True)
            raise

    async def execute_certificate(
        self, output: ConsensusOutput, batches: dict[bytes, Batch] | None = None
    ) -> None:
        """(core.rs:129-259). `batches` is the subscriber's in-memory staging;
        the temp store is only a fallback (e.g. crash replay paths)."""
        certificate = output.certificate
        # Sorted by batch digest: matches the canonical wire order so every
        # node (author included, before and after a crash) executes batches
        # identically regardless of local dict insertion order.
        payload = sorted(certificate.header.payload.items())
        total_batches = len(payload)
        for batch_index, (digest, _worker_id) in enumerate(payload):
            if batch_index < self.execution_indices.next_batch_index:
                continue  # crash replay: batch already fully executed
            batch = (batches or {}).get(digest)
            if batch is None:
                raw = self.temp_batch_store.read(digest)
                if raw is None:
                    raise ExecutionStateError(
                        f"staged batch {digest.hex()[:16]} missing from temp store"
                    )
                batch = Batch.from_bytes(raw)
            await self._execute_batch(output, batch, total_batches)
        if total_batches == 0:
            # Empty certificate: still advances the certificate cursor.
            self.execution_indices = ExecutionIndices(
                next_certificate_index=self.execution_indices.next_certificate_index + 1
            )
        if self.metrics is not None:
            self.metrics.executed_certificates.inc()
        self.temp_batch_store.delete_all(d for d, _ in payload)

    async def _execute_batch(
        self, output: ConsensusOutput, batch: Batch, total_batches: int
    ) -> None:
        """Burst drain: apply the whole batch in one tight loop, buffering
        (result, transaction) pairs and flushing them with one send_many.
        The cursor advances per applied transaction, so a crash anywhere
        mid-batch replays from exactly the next unapplied transaction —
        and the flush runs in a finally so results applied before a crash
        still reach the output channel exactly once (replay skips them
        below the watermark and never re-emits)."""
        total_transactions = len(batch.transactions)
        outbox: list | None = [] if self.tx_output is not None else None
        try:
            for tx_index, transaction in enumerate(batch.transactions):
                if tx_index < self.execution_indices.next_transaction_index:
                    continue  # crash replay
                next_indices = self.execution_indices.next(
                    total_batches, total_transactions
                )
                try:
                    result = await self.execution_state.handle_consensus_transaction(
                        output, next_indices, transaction
                    )
                    if outbox is not None:
                        outbox.append((result, transaction))
                    if self.metrics is not None:
                        self.metrics.executed_transactions.inc()
                except ClientExecutionError as e:
                    logger.debug("skipping bad transaction: %s", e)
                self.execution_indices = next_indices
        finally:
            if outbox:
                await self.tx_output.send_many(outbox)
