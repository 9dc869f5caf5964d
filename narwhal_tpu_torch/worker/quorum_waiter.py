"""QuorumWaiter: reliably disseminate a batch and wait for 2f+1 stake.

Port copy of `narwhal_tpu/worker/quorum_waiter.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/worker/src/quorum_waiter.rs:39-157 — broadcast the
serialized batch to the same-id worker of every other authority via reliable
send, sum acked stake (own stake counts) until quorum_threshold, then forward
the batch onward to the Processor.
"""

from __future__ import annotations

import asyncio
import logging

from ..channels import BoundedFuturesOrdered, Channel, Subscriber, Watch
from ..config import Committee, WorkerCache
from ..messages import WorkerBatchMsg
from ..network import NetworkClient
from ..types import PublicKey, SealedBatch, WorkerId

logger = logging.getLogger("narwhal.worker")

# Batches disseminating concurrently. Sequential dissemination caps
# throughput at batch_size / quorum-RTT; pipelining hides the round-trip
# while BoundedFuturesOrdered keeps the processor seeing batches in seal
# order (the reference gets the same effect from cheap RTTs; here the
# in-flight window is explicit).
MAX_INFLIGHT_BATCHES = 64


class QuorumWaiter:
    def __init__(
        self,
        name: PublicKey,
        worker_id: WorkerId,
        committee: Committee,
        worker_cache: WorkerCache,
        network: NetworkClient,
        rx_message: Channel,
        tx_batch: Channel,
        rx_reconfigure: Watch,
    ):
        self.name = name
        self.worker_id = worker_id
        self.committee = committee
        self.worker_cache = worker_cache
        self.network = network
        self.rx_message = rx_message
        self.tx_batch = tx_batch
        self.rx_reconfigure = Subscriber(rx_reconfigure)

    def spawn(self) -> asyncio.Task:
        return asyncio.ensure_future(self.run())

    async def run(self) -> None:
        pool = BoundedFuturesOrdered(MAX_INFLIGHT_BATCHES)
        forwarder = asyncio.ensure_future(self._forward(pool))
        try:
            while True:
                batch: SealedBatch = await self.rx_message.recv()
                note = self.rx_reconfigure.peek()
                if note.kind == "shutdown":
                    return
                if note.committee is not None and note.committee is not self.committee:
                    # Adopt the reconfigured committee before counting stake.
                    self.committee = note.committee
                # Push blocks once MAX_INFLIGHT_BATCHES are disseminating:
                # backpressure flows to the batch maker's channel.
                await pool.push(self._disseminate(batch))
        finally:
            forwarder.cancel()
            pool.cancel_all()

    async def _forward(self, pool: BoundedFuturesOrdered) -> None:
        """Pop dissemination results in seal order and hand quorum-acked
        batches to the processor."""
        while True:
            try:
                batch, ok = await pool.next()
            except asyncio.CancelledError:
                raise
            except Exception:
                # A dissemination task died unexpectedly (e.g. a peer vanished
                # from a reconfigured committee). Dropping that one batch is
                # the quorum-failure outcome; dying here would silently stall
                # the whole pipeline once the pool fills.
                logger.exception("batch dissemination task failed")
                continue
            if ok:
                # The SealedBatch travels intact: its cached digest spares the
                # processor a re-hash of our own payload bytes.
                await self.tx_batch.send((batch, True))
            else:
                logger.warning("batch dissemination failed to reach quorum")

    async def _disseminate(self, batch: SealedBatch) -> tuple[SealedBatch, bool]:
        serialized = batch.serialized
        others = self.worker_cache.others_workers(self.name, self.worker_id)
        msg = WorkerBatchMsg(serialized)
        handles = [
            (self.committee.stake(pk), self.network.send(info.worker_address, msg))
            for pk, info in others
        ]
        total = self.committee.stake(self.name)  # our own vote
        threshold = self.committee.quorum_threshold()
        pending = {
            asyncio.ensure_future(self._wait(stake, h)) for stake, h in handles
        }
        try:
            while total < threshold and pending:
                done, _ = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                for t in done:
                    # asyncio.wait's done set — completed-task reads only.
                    total += t.result()  # lint: allow(no-blocking-in-async)
                    pending.discard(t)
        finally:
            # Remaining reliable sends keep retrying in the background
            # (the reference lets its CancelOnDrop handles continue until
            # the waiter future set is dropped after quorum).
            for t in pending:
                t.cancel()
        return batch, total >= threshold

    @staticmethod
    async def _wait(stake: int, handle) -> int:
        try:
            await handle
            return stake
        except asyncio.CancelledError:
            return 0
