"""PrimaryConnector: forward worker->primary messages to our own primary.

Port copy of `narwhal_tpu/worker/primary_connector.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/worker/src/primary_connector.rs:15-75 — reliable
send of each WorkerPrimaryMessage digest notification, bounded in-flight.
"""

from __future__ import annotations

import asyncio

from ..channels import Channel, Subscriber, Watch
from ..network import NetworkClient

MAX_PENDING = 10_000


class PrimaryConnector:
    def __init__(
        self,
        primary_address: str,
        network: NetworkClient,
        rx_digest: Channel,
        rx_reconfigure: Watch,
    ):
        self.primary_address = primary_address
        self.network = network
        self.rx_digest = rx_digest
        self.rx_reconfigure = Subscriber(rx_reconfigure)
        self._inflight = asyncio.Semaphore(MAX_PENDING)

    def spawn(self) -> asyncio.Task:
        return asyncio.ensure_future(self.run())

    async def run(self) -> None:
        while True:
            msg = await self.rx_digest.recv()
            if self.rx_reconfigure.peek().kind == "shutdown":
                return
            await self._inflight.acquire()
            handle = self.network.send(self.primary_address, msg)
            handle.task.add_done_callback(lambda _t: self._inflight.release())
