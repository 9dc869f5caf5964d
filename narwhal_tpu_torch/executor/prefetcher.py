"""Speculative payload prefetcher: warm the executor's temp batch store
rounds before commit.

Port copy of `narwhal_tpu/executor/prefetcher.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Narwhal's core property is that consensus orders *digests* while payload
dissemination is off the critical path — but the executor used to start
fetching payload only AFTER the commit, re-serializing that path as
`RTT x batches` of commit latency. Batch digests are already known when a
certificate is *accepted* into the DAG, typically rounds before Bullshark
commits it; this actor subscribes to that accepted-certificate stream (a
non-blocking tap off the consensus runner's ingest) and pulls the payload in
the background with the same coalesced RequestBatchesMsg the subscriber
uses. At commit time the subscriber's store read is then usually a local hit
and payload RTT leaves the commit->execution path entirely.

Speculation is bounded two ways (BoundedCache-style exact accounting):

* a byte budget — unclaimed speculative payload never holds more than
  `budget_bytes` of the temp store; over budget, the oldest unclaimed entry
  is evicted (the subscriber transparently falls back to the coalesced
  fetch on a miss, so eviction can cost a round trip but never correctness);
* `gc_depth` — payload of a certificate that never commits (e.g. its branch
  lost) is deleted once the accepted round-front moves `gc_depth` rounds
  past it, exactly the DAG's own garbage horizon.

`claim()` is the ownership handoff: at commit the subscriber claims the
certificate's digests, removing them from this actor's accounting so budget
eviction and GC can never delete a committed-but-unexecuted payload out from
under the core (the core deletes them itself after applying).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Iterable

from ..channels import Channel
from ..config import WorkerCache
from ..messages import RequestBatchesMsg, RequestedBatchesMsg
from ..network import NetworkClient, RpcError
from ..stores import BatchStore
from ..types import Batch, Certificate, PublicKey, serialized_batch_digest

logger = logging.getLogger("narwhal.executor")

DEFAULT_PREFETCH_BUDGET = 64 << 20  # bytes of unclaimed speculative payload
# Speculative fetches are best-effort: a bounded number of quick attempts,
# never the subscriber's infinite retry — a miss costs a fetch at commit
# time, nothing more.
PREFETCH_ATTEMPTS = 2
PREFETCH_TIMEOUT = 5.0
PREFETCH_RETRY_DELAY = 0.2
# How many accepted certificates to drain per wakeup: a round's worth of
# acceptances shares RPCs (one per worker) instead of one wakeup each.
MAX_BURST = 64


class Prefetcher:
    def __init__(
        self,
        name: PublicKey,
        worker_cache: WorkerCache,
        network: NetworkClient,
        temp_batch_store: BatchStore,
        rx_accepted: Channel,  # Certificate, tapped off consensus ingest
        gc_depth: int = 50,
        budget_bytes: int = DEFAULT_PREFETCH_BUDGET,
        metrics=None,  # ExecutorMetrics
        attempts: int = PREFETCH_ATTEMPTS,
        fetch_timeout: float = PREFETCH_TIMEOUT,
        retry_delay: float = PREFETCH_RETRY_DELAY,
    ):
        self.name = name
        self.worker_cache = worker_cache
        self.network = network
        self.temp_batch_store = temp_batch_store
        self.rx_accepted = rx_accepted
        self.gc_depth = gc_depth
        self.budget_bytes = budget_bytes
        self.metrics = metrics
        self.attempts = attempts
        self.fetch_timeout = fetch_timeout
        self.retry_delay = retry_delay
        # digest -> (round, bytes); dict order IS the FIFO eviction order.
        self._entries: dict[bytes, tuple[int, int]] = {}
        self._bytes = 0
        self._inflight: set[bytes] = set()
        self._front_round = 0  # highest accepted round seen
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    # -- accounting --------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    def claim(self, digests: Iterable[bytes]) -> None:
        """Commit-time ownership handoff (called by the Subscriber): the
        execution path owns these digests now — stop accounting for them so
        eviction/GC can never drop a committed-but-unexecuted payload."""
        for d in digests:
            entry = self._entries.pop(d, None)
            if entry is not None:
                self._bytes -= entry[1]
            self._inflight.discard(d)
        self._update_gauge()

    def _admit(self, digest: bytes, round: int, size: int) -> None:
        self._entries[digest] = (round, size)
        self._bytes += size
        while self._bytes > self.budget_bytes and self._entries:
            self._evict(next(iter(self._entries)))  # FIFO: oldest unclaimed

    def _evict(self, digest: bytes) -> None:
        round_, size = self._entries.pop(digest)
        self._bytes -= size
        self.temp_batch_store.delete_all([digest])
        if self.metrics is not None:
            self.metrics.prefetch_evicted.inc()

    def _gc(self) -> None:
        """Drop speculative payload of certificates that never committed
        once the accepted front is gc_depth rounds past them — the same
        horizon the DAG itself garbage-collects at."""
        if self._front_round <= self.gc_depth:
            return
        horizon = self._front_round - self.gc_depth
        for d in [d for d, (r, _) in self._entries.items() if r <= horizon]:
            self._evict(d)

    def _update_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.prefetch_resident_bytes.set(self._bytes)

    # -- the actor ---------------------------------------------------------

    async def run(self) -> None:
        while True:
            certs: list[Certificate] = [await self.rx_accepted.recv()]
            while len(certs) < MAX_BURST:
                extra = self.rx_accepted.try_recv()
                if extra is None:
                    break
                certs.append(extra)
            try:
                await self._prefetch_burst(certs)
            except asyncio.CancelledError:
                raise
            except Exception:
                # Speculation must never take the executor down; the
                # subscriber's commit-time fetch is the correctness path.
                logger.debug("prefetch burst failed", exc_info=True)

    async def _prefetch_burst(self, certs: list[Certificate]) -> None:
        by_worker: dict[int, list[tuple[bytes, int]]] = {}
        for cert in certs:
            self._front_round = max(self._front_round, cert.round)
            for digest, worker_id in cert.header.payload.items():
                if (
                    digest in self._entries
                    or digest in self._inflight
                    or self.temp_batch_store.read(digest) is not None
                ):
                    continue
                self._inflight.add(digest)
                by_worker.setdefault(worker_id, []).append((digest, cert.round))
        self._gc()
        if by_worker:
            await asyncio.gather(
                *(
                    self._fetch_group(worker_id, wanted)
                    for worker_id, wanted in by_worker.items()
                )
            )
        self._update_gauge()

    async def _fetch_group(
        self, worker_id: int, wanted: list[tuple[bytes, int]]
    ) -> None:
        """One coalesced RPC (bounded attempts) for everything a burst of
        accepted certificates needs from one worker."""
        rounds = dict(wanted)
        remaining = dict.fromkeys(rounds)
        try:
            for attempt in range(self.attempts):
                try:
                    info = self.worker_cache.worker(self.name, worker_id)
                    # Bounded per-ATTEMPT retry over one coalesced request,
                    # not a per-item round trip.
                    # lint: allow(no-per-item-rpc-in-loop)
                    resp: RequestedBatchesMsg = await self.network.request(
                        info.worker_address,
                        RequestBatchesMsg(tuple(remaining)),
                        timeout=self.fetch_timeout,
                    )
                except KeyError as e:
                    logger.debug(
                        "prefetch skipped: unknown worker id %d (%s)",
                        worker_id,
                        e,
                    )
                    return
                except (RpcError, OSError) as e:
                    logger.debug(
                        "prefetch attempt %d from worker %d failed: %s",
                        attempt + 1,
                        worker_id,
                        e,
                    )
                    await asyncio.sleep(self.retry_delay)
                    continue
                for digest, found, raw in resp.batches:
                    if (
                        digest not in remaining
                        or not found
                        or serialized_batch_digest(raw) != digest
                    ):
                        continue
                    del remaining[digest]
                    if len(raw) > self.budget_bytes:
                        continue  # can't fit even alone; let commit fetch it
                    self.temp_batch_store.write(digest, raw)
                    self._admit(digest, rounds[digest], len(raw))
                    if self.metrics is not None:
                        self.metrics.prefetched_batches.inc()
                if not remaining:
                    return
                # Worker hasn't seen the rest yet (dissemination still in
                # flight): give it one short beat, then give up — the
                # commit-time fetch covers whatever speculation missed.
                await asyncio.sleep(self.retry_delay)
        finally:
            for d in rounds:
                self._inflight.discard(d)
