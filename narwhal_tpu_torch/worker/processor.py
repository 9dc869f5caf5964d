"""Processor: hash, persist and report each batch to the primary.

Port copy of `narwhal_tpu/worker/processor.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/worker/src/processor.rs:22-73 — digest the
*serialized* batch (zero-copy, types/src/worker.rs:44-62), write it to the
batch store, and emit OurBatch (own dissemination path) or OthersBatch (peer
receive path) to the primary connector.
"""

from __future__ import annotations

import asyncio

from ..channels import Channel, Subscriber, Watch
from ..messages import OthersBatchMsg, OurBatchMsg
from ..stores import BatchStore
from ..types import SealedBatch, WorkerId, serialized_batch_digest


class Processor:
    def __init__(
        self,
        worker_id: WorkerId,
        store: BatchStore,
        rx_batch: Channel,
        tx_digest: Channel,
        rx_reconfigure: Watch,
        metrics=None,
    ):
        self.worker_id = worker_id
        self.store = store
        self.rx_batch = rx_batch
        self.tx_digest = tx_digest
        self.rx_reconfigure = Subscriber(rx_reconfigure)
        self.metrics = metrics

    def spawn(self) -> asyncio.Task:
        return asyncio.ensure_future(self.run())

    async def run(self) -> None:
        while True:
            payload, own = await self.rx_batch.recv()
            if self.rx_reconfigure.peek().kind == "shutdown":
                return
            if isinstance(payload, SealedBatch):
                # Own batch: the digest is cached on the sealed object.
                digest, serialized = payload.digest, payload.serialized
            else:
                # Peer bytes are untrusted: hash the wire form ourselves.
                serialized = payload
                digest = serialized_batch_digest(serialized)
            self.store.write(digest, serialized)
            msg = (
                OurBatchMsg(digest, self.worker_id)
                if own
                else OthersBatchMsg(digest, self.worker_id)
            )
            await self.tx_digest.send(msg)
