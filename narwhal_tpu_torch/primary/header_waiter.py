"""The HeaderWaiter: executes SyncBatches / SyncParents repair commands.

Port copy of `narwhal_tpu/primary/header_waiter.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/header_waiter.rs:44-406 — for each
suspended header it registers store waiters (`notify_read`) on the missing
dependencies, optimistically asks one node (own workers for batches, the
header author's primary for parent certificates), retries on a timer by
asking `sync_retry_nodes` random peers (the lucky-broadcast policy), and
loops the header back to the core once everything is local. Waiters are
cancelled by garbage collection.
"""

from __future__ import annotations

import asyncio
import logging
import random

from ..channels import Channel, Subscriber, Watch
from ..config import Committee, Parameters, WorkerCache
from ..messages import CertificatesBatchRequest, SynchronizeMsg
from ..network import NetworkClient, RpcError
from ..stores import CertificateStore, PayloadStore
from ..types import Digest, Header, PublicKey, Round
from .synchronizer import SyncBatches, SyncParents

logger = logging.getLogger("narwhal.primary")


class HeaderWaiter:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        worker_cache: WorkerCache,
        certificate_store: CertificateStore,
        payload_store: PayloadStore,
        parameters: Parameters,
        network: NetworkClient,
        rx_synchronizer: Channel,  # SyncBatches | SyncParents
        tx_core: Channel,  # replayed headers
        tx_primary_messages: Channel,  # fetched certificates -> core input
        rx_consensus_round_updates: Watch,
        rx_reconfigure: Watch,
        metrics=None,
    ):
        self.name = name
        self.committee = committee
        self.worker_cache = worker_cache
        self.certificate_store = certificate_store
        self.payload_store = payload_store
        self.parameters = parameters
        self.network = network
        self.rx_synchronizer = rx_synchronizer
        self.tx_core = tx_core
        self.tx_primary_messages = tx_primary_messages
        self.rx_consensus_round_updates = Subscriber(rx_consensus_round_updates)
        self.rx_reconfigure = Subscriber(rx_reconfigure)
        self.metrics = metrics

        self.gc_round: Round = 0
        # header digest -> (round, waiter task)
        self.pending: dict[Digest, tuple[Round, asyncio.Task]] = {}
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    # ------------------------------------------------------------------
    async def _sync_batches_once(self, missing: dict[Digest, int], author: PublicKey) -> None:
        """Group missing batch digests by worker id and send Synchronize to
        our own workers (header_waiter.rs:163-236). The worker synchronizer
        has its own retry loop, so one send per tick is enough."""
        by_worker: dict[int, list[Digest]] = {}
        for digest, worker_id in missing.items():
            by_worker.setdefault(worker_id, []).append(digest)
        sends = []
        for worker_id, digests in by_worker.items():
            try:
                address = self.worker_cache.worker(self.name, worker_id).worker_address
            except KeyError:
                logger.debug(
                    "no local worker %d to sync %d batches", worker_id, len(digests)
                )
                continue
            sends.append(
                self.network.unreliable_send(
                    address, SynchronizeMsg(tuple(digests), author)
                )
            )
            if self.metrics is not None:
                self.metrics.sync_batch_requests.inc()
        if sends:
            # Concurrent fan-out: one coalesced Synchronize per worker, all
            # workers in flight together.
            await asyncio.gather(*sends)

    async def _fetch_certificates(self, digests: list[Digest], address: str) -> None:
        """Request parent certificates and feed replies into the core's
        message stream (so they pass the usual sanitize path)."""
        try:
            response = await self.network.request(
                address,
                CertificatesBatchRequest(tuple(digests), self.name),
                timeout=self.parameters.block_synchronizer_certs_timeout,
            )
        except (RpcError, OSError):
            return
        for _, certificate in response.certificates:
            if certificate is not None:
                await self.tx_primary_messages.send(certificate)

    async def _wait_batches(self, msg: SyncBatches) -> None:
        header = msg.header
        waiters = [
            self.payload_store.notify_contains(digest, worker_id)
            for digest, worker_id in msg.missing.items()
        ]
        gathered = asyncio.gather(*waiters)
        try:
            while True:
                # Trim per tick: batches that arrived since the last tick
                # must not ride the next Synchronize — the worker would
                # re-fetch (and peers re-ship) payload we already hold.
                still_missing = {
                    digest: worker_id
                    for digest, worker_id in msg.missing.items()
                    if not self.payload_store.contains(digest, worker_id)
                }
                if still_missing:
                    await self._sync_batches_once(still_missing, header.author)
                try:
                    await asyncio.wait_for(
                        asyncio.shield(gathered), self.parameters.sync_retry_delay
                    )
                    break
                except asyncio.TimeoutError:  # lint: allow(no-silent-except)
                    continue  # retry tick: re-send sync requests by design
        except asyncio.CancelledError:
            gathered.cancel()
            raise
        await self.tx_core.send(header)

    async def _wait_parents(self, msg: SyncParents) -> None:
        header = msg.header
        waiters = [self.certificate_store.notify_read(d) for d in msg.missing]
        gathered = asyncio.gather(*waiters)
        author_address = self.committee.primary_address(header.author)
        others = [
            addr for _, addr, _ in self.committee.others_primaries(self.name)
        ]
        first = True
        try:
            while True:
                if first:
                    await self._fetch_certificates(msg.missing, author_address)
                    first = False
                else:
                    # Timer retry: ask sync_retry_nodes random peers
                    # (header_waiter.rs:292-321).
                    # Deliberate draw from the scenario-seeded global
                    # stream: retry-peer choice replays under the same seed.
                    for addr in random.sample(  # lint: allow(unseeded-random)
                        others, min(self.parameters.sync_retry_nodes, len(others))
                    ):
                        await self._fetch_certificates(msg.missing, addr)
                if self.metrics is not None:
                    self.metrics.sync_parent_requests.inc()
                try:
                    await asyncio.wait_for(
                        asyncio.shield(gathered), self.parameters.sync_retry_delay
                    )
                    break
                except asyncio.TimeoutError:  # lint: allow(no-silent-except)
                    continue  # retry tick: re-send sync requests by design
        except asyncio.CancelledError:
            gathered.cancel()
            raise
        await self.tx_core.send(header)

    # ------------------------------------------------------------------
    def _spawn_waiter(self, header: Header, coro) -> None:
        if header.digest in self.pending:
            coro.close()  # already being repaired; drop the duplicate quietly
            return
        task = asyncio.ensure_future(coro)
        self.pending[header.digest] = (header.round, task)

        def _done(t: asyncio.Task, digest=header.digest) -> None:
            self.pending.pop(digest, None)
            if self.metrics is not None:
                self.metrics.pending_header_waits.set(len(self.pending))
            if not t.cancelled() and t.exception() is not None:
                logger.warning("Header waiter failed: %r", t.exception())

        task.add_done_callback(_done)
        if self.metrics is not None:
            self.metrics.pending_header_waits.set(len(self.pending))

    async def run(self) -> None:
        cmd_task = asyncio.ensure_future(self.rx_synchronizer.recv())
        recon_task = asyncio.ensure_future(self.rx_reconfigure.changed())
        round_task = asyncio.ensure_future(self.rx_consensus_round_updates.changed())
        try:
            while True:
                done, _ = await asyncio.wait(
                    {cmd_task, recon_task, round_task},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if cmd_task in done:
                    msg = cmd_task.result()
                    cmd_task = asyncio.ensure_future(self.rx_synchronizer.recv())
                    if msg.header.round > self.gc_round:
                        if isinstance(msg, SyncBatches):
                            self._spawn_waiter(msg.header, self._wait_batches(msg))
                        elif isinstance(msg, SyncParents):
                            self._spawn_waiter(msg.header, self._wait_parents(msg))
                if round_task in done:
                    committed_round = round_task.result()
                    round_task = asyncio.ensure_future(
                        self.rx_consensus_round_updates.changed()
                    )
                    self._gc(committed_round)
                if recon_task in done:
                    note = recon_task.result()
                    if note.kind == "shutdown":
                        return
                    if note.committee is not None:
                        self.committee = note.committee
                        self.gc_round = 0
                        self._cancel_all()
                    recon_task = asyncio.ensure_future(self.rx_reconfigure.changed())
        finally:
            cmd_task.cancel()
            recon_task.cancel()
            round_task.cancel()
            self._cancel_all()

    def _gc(self, committed_round: Round) -> None:
        if committed_round <= self.parameters.gc_depth:
            return
        gc_round = committed_round - self.parameters.gc_depth
        if gc_round <= self.gc_round:
            return
        self.gc_round = gc_round
        for digest, (round_, task) in list(self.pending.items()):
            if round_ <= gc_round:
                task.cancel()
                self.pending.pop(digest, None)

    def _cancel_all(self) -> None:
        for _, task in self.pending.values():
            task.cancel()
        self.pending.clear()
