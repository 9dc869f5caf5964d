"""Worker Synchronizer: fetch missing batches on the primary's behalf.

Port copy of `narwhal_tpu/worker/synchronizer.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/worker/src/synchronizer.rs:77-384 — executes the
primary's Synchronize command by asking the target authority's same-id worker
for the missing batches, retrying on a timer via lucky_broadcast to
`sync_retry_nodes` random peers; handles Cleanup(round) GC of stale requests
and DeleteBatches.
"""

from __future__ import annotations

import asyncio
import logging

from ..channels import Channel, Subscriber, Watch, drain_cancelled
from ..clock import now as clock_now
from ..config import Committee, Parameters, WorkerCache
from ..messages import SynchronizeMsg, WorkerBatchRequest, WorkerBatchResponse
from ..network import NetworkClient, RpcError
from ..stores import BatchStore
from ..types import Digest, PublicKey, Round, WorkerId, serialized_batch_digest

logger = logging.getLogger("narwhal.worker")


class WorkerSynchronizer:
    def __init__(
        self,
        name: PublicKey,
        worker_id: WorkerId,
        committee: Committee,
        worker_cache: WorkerCache,
        parameters: Parameters,
        store: BatchStore,
        network: NetworkClient,
        rx_command: Channel,
        tx_batch_processor: Channel,
        rx_reconfigure: Watch,
        metrics=None,
    ):
        self.name = name
        self.worker_id = worker_id
        self.committee = committee
        self.worker_cache = worker_cache
        self.parameters = parameters
        self.store = store
        self.network = network
        self.rx_command = rx_command
        self.tx_batch_processor = tx_batch_processor
        self.rx_reconfigure = Subscriber(rx_reconfigure)
        self.metrics = metrics
        # digest -> (deadline round, target authority, request time)
        self.pending: dict[Digest, tuple[Round, PublicKey, float]] = {}
        self.gc_round: Round = 0
        # In-flight fetch attempts. A dropped handle here is the shutdown
        # wedge class: a fetch parked on tx_batch_processor.send after the
        # processor stopped would never be cancelled.
        self._fetch_tasks: set[asyncio.Task] = set()

    def spawn(self) -> asyncio.Task:
        return asyncio.ensure_future(self.run())

    async def run(self) -> None:
        timer = asyncio.ensure_future(asyncio.sleep(self.parameters.sync_retry_delay))
        cmd = asyncio.ensure_future(self.rx_command.recv())
        try:
            while True:
                done, _ = await asyncio.wait(
                    {timer, cmd}, return_when=asyncio.FIRST_COMPLETED
                )
                note = self.rx_reconfigure.peek()
                if note.kind == "shutdown":
                    return
                if note.committee is not None and note.committee is not self.committee:
                    self.committee = note.committee
                if cmd in done:
                    msg = cmd.result()
                    cmd = asyncio.ensure_future(self.rx_command.recv())
                    if isinstance(msg, SynchronizeMsg):
                        await self._synchronize(msg)
                    else:  # Cleanup round
                        self._cleanup(msg)
                if timer in done:
                    timer = asyncio.ensure_future(
                        asyncio.sleep(self.parameters.sync_retry_delay)
                    )
                    await self._retry()
        finally:
            timer.cancel()
            cmd.cancel()
            for t in list(self._fetch_tasks):
                t.cancel()
            await drain_cancelled(self._fetch_tasks, who="worker synchronizer")

    async def _synchronize(self, msg: SynchronizeMsg) -> None:
        missing = [d for d in msg.digests if not self.store.contains(d)]
        t_now = clock_now()
        for d in missing:
            self.pending[d] = (self.gc_round, msg.target, t_now)
        if self.metrics is not None:
            self.metrics.pending_sync_batches.set(len(self.pending))
        if not missing:
            return
        try:
            info = self.worker_cache.worker(msg.target, self.worker_id)
        except KeyError:
            logger.warning("synchronize target has no worker %d", self.worker_id)
            return
        self._spawn_fetch(info.worker_address, tuple(missing))

    def _spawn_fetch(self, address: str, digests: tuple[Digest, ...]) -> None:
        task = asyncio.ensure_future(self._fetch(address, digests))
        self._fetch_tasks.add(task)
        task.add_done_callback(self._fetch_tasks.discard)

    async def _fetch(self, address: str, digests: tuple[Digest, ...]) -> None:
        """One fetch attempt; received batches flow through the others-batch
        processor path, which stores them and notifies the primary."""
        # Trim at send time, not just at spawn time: between the retry tick
        # that built this want-list and this task actually running, digests
        # may have arrived (another fetch's response, a peer's broadcast).
        # Re-requesting them re-ships whole batches for nothing.
        digests = tuple(
            d for d in digests if d in self.pending and not self.store.contains(d)
        )
        if not digests:
            return
        try:
            resp: WorkerBatchResponse = await self.network.request(
                address, WorkerBatchRequest(digests), timeout=5.0
            )
        except (RpcError, OSError):
            return  # the retry timer will lucky-broadcast
        for serialized in resp.batches:
            digest = serialized_batch_digest(serialized)
            # Pop is keyed by the digest THIS response delivered: a
            # concurrent fetch that re-registers at the yield point is
            # satisfied by the same arrival, so losing its entry is correct.
            self.pending.pop(digest, None)  # lint: allow(await-interleaved-rmw)
            await self.tx_batch_processor.send((serialized, False))
        if self.metrics is not None:
            self.metrics.pending_sync_batches.set(len(self.pending))

    async def _retry(self) -> None:
        still_missing = []
        for d in list(self.pending):
            if self.store.contains(d):
                self.pending.pop(d, None)
            else:
                still_missing.append(d)
        if not still_missing:
            if self.metrics is not None:
                self.metrics.pending_sync_batches.set(0)
            return
        # Lucky broadcast the whole want-list to a few random same-id workers
        # (synchronizer.rs:311-345).
        addresses = [
            info.worker_address
            for _, info in self.worker_cache.others_workers(self.name, self.worker_id)
        ]
        if not addresses:
            return
        import random

        # Deliberate draw from the scenario-seeded global stream: retry
        # fan-out choice replays under the same seed.
        chosen = random.sample(  # lint: allow(unseeded-random)
            addresses, min(self.parameters.sync_retry_nodes, len(addresses))
        )
        for addr in chosen:
            self._spawn_fetch(addr, tuple(still_missing))

    def _cleanup(self, round: Round) -> None:
        """Drop pending requests from before the GC round
        (synchronizer.rs:215-282)."""
        self.gc_round = max(self.gc_round, round)
        for d in [d for d, (r, _, _) in self.pending.items() if r < self.gc_round]:
            self.pending.pop(d, None)
        if self.metrics is not None:
            self.metrics.pending_sync_batches.set(len(self.pending))
