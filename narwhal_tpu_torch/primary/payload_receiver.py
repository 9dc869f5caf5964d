"""The PayloadReceiver: records availability of other authorities' batches.

Port copy of `narwhal_tpu/primary/payload_receiver.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/payload_receiver.rs:17-41 — our workers
report (digest, worker_id) for every peer batch they store; the token in the
payload store is what `Synchronizer.missing_payload` checks when voting on
headers.
"""

from __future__ import annotations

import asyncio

from ..channels import Channel
from ..stores import PayloadStore


class PayloadReceiver:
    MAX_BURST = 256

    def __init__(self, payload_store: PayloadStore, rx_workers: Channel):
        self.payload_store = payload_store
        self.rx_workers = rx_workers
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    async def run(self) -> None:
        while True:
            pairs = [await self.rx_workers.recv()]
            # Greedy bounded drain: a burst of worker reports becomes one
            # grouped availability commit (availability tokens are visible
            # via the memtable immediately; one fused flush covers all).
            while len(pairs) < self.MAX_BURST:
                extra = self.rx_workers.try_recv()
                if extra is None:
                    break
                pairs.append(extra)
            await self.payload_store.write_all_async(pairs)
