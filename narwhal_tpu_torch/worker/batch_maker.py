"""BatchMaker: accumulate transactions into sealed batches.

Port copy of `narwhal_tpu/worker/batch_maker.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/worker/src/batch_maker.rs:48-193 — seal when the
pending bytes reach `batch_size` or `max_batch_delay` elapses; under the
benchmark feature it logs "Batch {digest} contains sample tx {id}" for sample
transactions (first byte 0, u64 id following) and "Batch {digest} contains
{n} B" — the log lines the benchmark harness parses for TPS/latency
(benchmark/benchmark/logs.py:171-244). We emit byte-compatible lines.
"""

from __future__ import annotations

import asyncio
import logging
import struct

from ..channels import Channel, Subscriber, Watch
from ..clock import now
from ..types import SealedBatch, assemble_serialized_batch, iter_serialized_batch_txs

logger = logging.getLogger("narwhal.worker")


class BatchMaker:
    def __init__(
        self,
        batch_size: int,
        max_batch_delay: float,
        rx_transaction: Channel,
        tx_message: Channel,
        rx_reconfigure: Watch,
        metrics=None,
        benchmark: bool = False,
        pacing=None,  # pacing.PacingController: adaptive seal delay
    ):
        self.batch_size = batch_size
        self.max_batch_delay = max_batch_delay
        self.rx_transaction = rx_transaction
        self.tx_message = tx_message
        self.rx_reconfigure = Subscriber(rx_reconfigure)
        self.metrics = metrics
        self.benchmark = benchmark
        self.pacing = pacing
        # Pending transactions stay in wire form: (frame chunks, tx count).
        self._pending: list[bytes] = []
        self._pending_count = 0
        self._pending_bytes = 0
        # Arrival of the first chunk since the last seal: the seal-stage
        # latency sample (worker_stage_latency_seconds{stage="seal"}),
        # closed through the span-unified seal timer — the batch digest is
        # the waterfall's root causal key and exists only at seal time.
        self._pending_t0: float | None = None
        self._seal_timer = metrics.seal_timer if metrics is not None else None

    def spawn(self) -> asyncio.Task:
        return asyncio.ensure_future(self.run())

    def _seal_delay(self) -> float:
        """The effective seal delay for this loop iteration. With a pacing
        controller the delay adapts between its floor and max_batch_delay on
        queue occupancy — but only while transactions are pending: an idle
        batch maker keeps the ceiling (there is nothing whose latency the
        floor could improve, and the timer with an empty pending set is a
        no-op anyway)."""
        if self.pacing is not None and self._pending:
            delay = self.pacing.delay()
        else:
            if self.pacing is not None:
                self.pacing.observe()  # keep the EWMA live across idle gaps
            delay = self.max_batch_delay
        if self.metrics is not None:
            self.metrics.effective_batch_delay.set(delay)
        return delay

    async def run(self) -> None:
        # Fixed deadline, NOT an idle timeout: the timer runs from the last
        # seal, so a steady sub-batch-size trickle still seals every
        # effective delay (batch_maker.rs:77-122 uses an interval timer).
        # The deadline is recomputed from `last_seal` each iteration so a
        # pacing change (queues draining/filling) takes effect mid-wait.
        last_seal = now()
        while True:
            deadline = last_seal + self._seal_delay()
            timeout = max(0.0, deadline - now())
            try:
                # Receives whole client bursts as (count, frames) chunks in
                # wire form: one channel hop and zero per-tx work per burst.
                count, frames = await asyncio.wait_for(
                    self.rx_transaction.recv(), timeout=timeout
                )
                if self.rx_reconfigure.peek().kind == "shutdown":
                    return
                if not self._pending:
                    self._pending_t0 = now()
                self._pending.append(frames)
                self._pending_count += count
                self._pending_bytes += len(frames) - 4 * count
                if self._pending_bytes >= self.batch_size:
                    await self._seal()
                    last_seal = now()
            except asyncio.TimeoutError:
                if self.rx_reconfigure.peek().kind == "shutdown":
                    return
                if self._pending:
                    await self._seal()
                last_seal = now()

    async def _seal(self) -> None:
        serialized = assemble_serialized_batch(self._pending_count, self._pending)
        batch = SealedBatch(serialized, self._pending_count)
        size = self._pending_bytes
        self._pending = []
        self._pending_count = 0
        self._pending_bytes = 0
        if self.benchmark:
            digest_hex = batch.digest.hex()
            for off, n in iter_serialized_batch_txs(serialized):
                # Sample txs: first byte 0, u64 counter follows (the
                # benchmark client's marker, node/src/benchmark_client.rs).
                if n >= 9 and serialized[off] == 0:
                    (sample_id,) = struct.unpack_from(">Q", serialized, off + 1)
                    logger.info(
                        "Batch %s contains sample tx %d", digest_hex, sample_id
                    )
            logger.info("Batch %s contains %d B", digest_hex, size)
        if self.metrics is not None:
            self.metrics.created_batch_size.observe(size)
            self.metrics.batches_made.inc()
        if self._seal_timer is not None and self._pending_t0 is not None:
            self._seal_timer.close(batch.digest, self._pending_t0)
        self._pending_t0 = None
        await self.tx_message.send(batch)
