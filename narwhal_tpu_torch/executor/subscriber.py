"""The Subscriber: downloads payloads of ordered certificates, in order.

Port copy of `narwhal_tpu/executor/subscriber.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/executor/src/subscriber.rs:30-100 — receives
ConsensusOutput, fetches every batch of the certificate's payload with
infinite exponential backoff, stages the batches in the temp batch store, and
forwards outputs to the execution core strictly in consensus order
(BoundedFuturesOrdered).

Data-plane batching delta from the reference: all of a certificate's missing
digests that live on ONE worker ride a single coalesced RequestBatchesMsg
(one RPC + one coalesced store read on the worker) instead of one
RequestBatch round trip per digest, and the temp batch store doubles as the
prefetcher's warm cache — digests the Prefetcher staged while the certificate
was still climbing toward commit are local hits, taking payload RTT off the
commit->execution critical path entirely.
"""

from __future__ import annotations

import asyncio
import logging

from ..clock import now
from ..channels import BoundedFuturesOrdered, Channel
from ..config import WorkerCache
from ..messages import RequestBatchesMsg, RequestedBatchesMsg
from ..network import NetworkClient, RpcError
from ..stores import BatchStore
from ..types import Batch, ConsensusOutput, PublicKey, serialized_batch_digest

logger = logging.getLogger("narwhal.executor")

MAX_PENDING_PAYLOADS = 1_000
# Explicit backoff cap for the infinite fetch retry (subscriber.rs:65-72
# retries forever; the delay must not): doubling stops here.
MAX_FETCH_BACKOFF = 5.0
# After this many consecutive failed attempts for one fetch group the retry
# loop stops whispering at debug and escalates to a rate-limited warning —
# a misconfigured worker_id (KeyError) used to retry forever in silence.
ESCALATE_AFTER_ATTEMPTS = 5


class Subscriber:
    def __init__(
        self,
        name: PublicKey,
        worker_cache: WorkerCache,
        network: NetworkClient,
        temp_batch_store: BatchStore,
        rx_consensus: Channel,  # ConsensusOutput from the consensus runner
        tx_executor: Channel,  # (output, batches, t_commit) to the core
        metrics=None,  # ExecutorMetrics
        prefetcher=None,  # executor.prefetcher.Prefetcher (claim() on commit)
        fetch_timeout: float = 10.0,
        initial_backoff: float = 0.05,
        max_backoff: float = MAX_FETCH_BACKOFF,
    ):
        self.name = name
        self.worker_cache = worker_cache
        self.network = network
        self.temp_batch_store = temp_batch_store
        self.rx_consensus = rx_consensus
        self.tx_executor = tx_executor
        self.metrics = metrics
        self.prefetcher = prefetcher
        self.fetch_timeout = fetch_timeout
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    async def _fetch_group(
        self, worker_id: int, digests: list[bytes], stats: dict
    ) -> dict[bytes, Batch]:
        """Every digest this certificate is missing from ONE worker, fetched
        with a single coalesced RPC per attempt and infinite retry under a
        capped backoff (subscriber.rs:65-72). The temp store is a cache; the
        batches themselves are returned so the core never depends on store
        lifetime (two certificates may legitimately reference byte-identical
        batches, and the first one's cleanup must not starve the second)."""
        remaining: dict[bytes, None] = dict.fromkeys(digests)
        out: dict[bytes, Batch] = {}
        delay = self.initial_backoff
        attempt = 0
        while remaining:
            # Re-check the store every attempt: the prefetcher (or a sibling
            # certificate's fetch) may have landed a digest meanwhile.
            for d in list(remaining):
                raw = self.temp_batch_store.read(d)
                if raw is not None:
                    out[d] = Batch.from_bytes(raw)
                    del remaining[d]
            if not remaining:
                break
            attempt += 1
            failure: str | None = None
            try:
                info = self.worker_cache.worker(self.name, worker_id)
                resp: RequestedBatchesMsg = await self.network.request(
                    info.worker_address,
                    RequestBatchesMsg(tuple(remaining)),
                    timeout=self.fetch_timeout,
                )
                stats["rpcs"] += 1
                for digest, found, raw in resp.batches:
                    if (
                        digest in remaining
                        and found
                        and serialized_batch_digest(raw) == digest
                    ):
                        self.temp_batch_store.write(digest, raw)
                        out[digest] = Batch.from_bytes(raw)
                        del remaining[digest]
                        stats["bytes"] += len(raw)
                if remaining:
                    # Worker doesn't have them yet (miss) or corrupt: retry.
                    failure = f"{len(remaining)} digest(s) not yet available"
            except KeyError as e:
                # Unknown worker_id: a config/committee mismatch, not a
                # transient transport blip — it will never fix itself by
                # waiting, so it must not hide at debug level forever.
                failure = f"unknown worker id {worker_id}: {e}"
            except (RpcError, OSError) as e:
                stats["rpcs"] += 1
                failure = str(e)
            if failure is not None:
                if (
                    attempt >= ESCALATE_AFTER_ATTEMPTS
                    and attempt % ESCALATE_AFTER_ATTEMPTS == 0
                ):
                    logger.warning(
                        "batch fetch from worker %d still failing after "
                        "%d attempts (%s): %s",
                        worker_id,
                        attempt,
                        ", ".join(d.hex()[:16] for d in list(remaining)[:3]),
                        failure,
                    )
                else:
                    logger.debug(
                        "batch fetch retry (attempt %d, worker %d): %s",
                        attempt,
                        worker_id,
                        failure,
                    )
            if remaining:
                await asyncio.sleep(delay)
                delay = min(delay * 2, self.max_backoff)
        return out

    async def _stage(
        self, output: ConsensusOutput, t_commit: float
    ) -> tuple[ConsensusOutput, dict[bytes, Batch], float]:
        payload = output.certificate.header.payload
        batches: dict[bytes, Batch] = {}
        stats = {"rpcs": 0, "bytes": 0}
        if payload:
            # Local pass first: digests the prefetcher already staged (or a
            # previous certificate fetched) never touch the network.
            missing_by_worker: dict[int, list[bytes]] = {}
            hits = 0
            for digest, worker_id in payload.items():
                raw = self.temp_batch_store.read(digest)
                if raw is not None:
                    batches[digest] = Batch.from_bytes(raw)
                    hits += 1
                else:
                    missing_by_worker.setdefault(worker_id, []).append(digest)
            if self.metrics is not None:
                self.metrics.prefetch_hits.inc(hits)
                self.metrics.prefetch_misses.inc(len(payload) - hits)
            if missing_by_worker:
                fetched = await asyncio.gather(
                    *(
                        self._fetch_group(worker_id, digests, stats)
                        for worker_id, digests in missing_by_worker.items()
                    )
                )
                for group in fetched:
                    batches.update(group)
        if self.prefetcher is not None:
            # Ownership handoff: these digests now belong to the execution
            # path (the core deletes them after applying), so the prefetcher
            # must never budget-evict or GC them from under it.
            self.prefetcher.claim(payload.keys())
        if self.metrics is not None:
            self.metrics.fetch_rpcs_per_certificate.observe(stats["rpcs"])
            self.metrics.bytes_fetched.inc(stats["bytes"])
        return output, batches, t_commit

    async def run(self) -> None:
        pending = BoundedFuturesOrdered(MAX_PENDING_PAYLOADS)

        async def forward():
            while True:
                staged = await pending.next()
                await self.tx_executor.send(staged)

        forwarder = asyncio.ensure_future(forward())
        try:
            while True:
                output: ConsensusOutput = await self.rx_consensus.recv()
                await pending.push(self._stage(output, now()))
        finally:
            # Cancel staged fetches too: their infinite-backoff retry loops
            # would otherwise keep hitting workers (and writing into our
            # store) after the node shuts down or restarts.
            forwarder.cancel()
            pending.cancel_all()
