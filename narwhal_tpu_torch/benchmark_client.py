"""Benchmark transaction client: fixed-rate submission with sample markers.

Port copy of `narwhal_tpu/benchmark_client.py` (the JAX package's
counterpart). The PyTorch port keeps its own copy so that it imports nothing
of `narwhal_tpu`.

Reference: narwhal/node/src/benchmark_client.rs:19- — submits
`size`-byte transactions at `rate` tx/s in 1s ticks (burst per tick), marking
one transaction per burst as a *sample* (first byte 0, big-endian u64 counter
following) so the log parser can compute end-to-end latency; all other
transactions carry first byte 1 and a random-ish payload. Logs the
benchmark-parsed lines "Sending sample transaction {id}" and warns when a
burst cannot keep rate.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time

from .messages import SubmitTransactionStreamMsg
from .network import NetworkClient, RpcError

logger = logging.getLogger("narwhal.benchmark_client")

PRECISION = 20  # bursts per second (reference uses 50ms sub-ticks)


class BenchmarkClient:
    def __init__(
        self,
        target,  # worker transactions address(es): str or sequence of str
        size: int = 512,
        rate: int = 1_000,
        nodes: tuple[str, ...] = (),
    ):
        # Payload-plane sharding: a validator running W workers exposes W
        # transaction endpoints; a client given several targets round-robins
        # its bursts across them (deterministic by burst counter — the
        # hash-shard analog for anonymous benchmark traffic), so every
        # worker pipeline carries rate/W and the validator's ingest scales
        # with W instead of serializing on one lane.
        self.targets: tuple[str, ...] = (
            (target,) if isinstance(target, str) else tuple(target)
        )
        if not self.targets:
            raise ValueError("benchmark client needs at least one target")
        self.target = self.targets[0]  # compat: single-lane callers
        self.size = max(size, 9)
        self.rate = rate
        self.nodes = nodes
        self.network = NetworkClient()
        self.counter = 0
        self._task: asyncio.Task | None = None
        self._inflight: set[asyncio.Task] = set()
        # Per-client nonce so filler transactions differ across clients and
        # no two authorities seal byte-identical batches (the reference uses
        # random filler bytes, benchmark_client.rs).
        import secrets

        # Load-generator CLI, not protocol code: the nonce only needs to be
        # unique per client process and is never replayed under a seed.
        self._nonce = secrets.token_bytes(8)  # lint: allow(raw-entropy)

    async def wait_for_nodes(self, timeout: float = 30.0) -> None:
        """Wait until every node's tx port accepts connections
        (benchmark_client.rs wait)."""
        deadline = time.monotonic() + timeout
        for address in (*self.targets, *self.nodes):
            host, port = address.rsplit(":", 1)
            while True:
                try:
                    _, w = await asyncio.open_connection(host, int(port))
                    w.close()
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"node {address} never came up")
                    await asyncio.sleep(0.5)

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    async def _submit(self, target: str, txs: tuple[bytes, ...]) -> None:
        try:
            await self.network.request(
                target, SubmitTransactionStreamMsg(txs), timeout=5.0
            )
        except (RpcError, OSError) as e:
            logger.warning("Failed to send transaction burst: %s", e)

    async def run(self) -> None:
        # Parameter lines the log parser reads (benchmark_client.rs logs).
        logger.info("Transactions size: %d B", self.size)
        logger.info("Transactions rate: %d tx/s", self.rate)
        logger.info("Start sending transactions")
        # At low rates fall back to 1-tx bursts at `rate` ticks/s so the
        # delivered rate matches the requested one instead of rounding up.
        precision = max(1, min(PRECISION, self.rate))
        burst = max(1, self.rate // precision)
        interval = 1.0 / precision
        next_tick = time.monotonic()
        while True:
            # One sample tx per burst, rest are filler (benchmark_client.rs).
            txs = []
            sample_id = self.counter
            for i in range(burst):
                if i == 0:
                    # Sample marker + id, then the nonce: low-rate clients
                    # (burst == 1) send only samples, which must still differ
                    # across clients or authorities seal identical batches.
                    tx = b"\0" + struct.pack(">Q", sample_id) + self._nonce
                else:
                    tx = b"\1" + struct.pack(">Q", self.counter * burst + i) + self._nonce
                txs.append(tx.ljust(self.size, b"\0"))
            logger.info("Sending sample transaction %d", sample_id)
            # Fire-and-forget: a slow ack must not stall the rate loop.
            target = self.targets[self.counter % len(self.targets)]
            task = asyncio.ensure_future(self._submit(target, tuple(txs)))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
            self.counter += 1
            next_tick += interval
            sleep = next_tick - time.monotonic()
            if sleep > 0:
                await asyncio.sleep(sleep)
            elif sleep < -1.0:
                logger.warning("Transaction rate too high for this client")
                next_tick = time.monotonic()

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        for task in list(self._inflight):
            task.cancel()
        self.network.close()
