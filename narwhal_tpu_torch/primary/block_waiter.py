"""BlockWaiter: fetch a certificate's payload ("block"/"collection") from our
own workers.

Port copy of `narwhal_tpu/primary/block_waiter.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/block_waiter.rs:45-845 — GetBlock /
GetBlocks commands resolve a certificate digest to its batches; concurrent
requests for the same block are deduplicated; batch requests time out after
10s. Used by the Validator gRPC API. Data-plane batching delta from the
reference: a block's batch fetches group by target worker and each group
rides ONE coalesced RequestBatchesMsg (one RPC, one coalesced store read on
the worker) instead of one RequestBatch round trip per batch; partial
responses map onto the same BlockError kinds (a deadline anywhere is
BatchTimeout, an authoritative miss or transport failure is BatchError).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass

from ..clock import now
from ..config import WorkerCache
from ..messages import RequestBatchesMsg, RequestedBatchesMsg
from ..network import NetworkClient, RpcError
from ..stores import CertificateStore
from ..types import Batch, Certificate, Digest, PublicKey, serialized_batch_digest

logger = logging.getLogger("narwhal.primary")

# Per-batch worker deadline (block_waiter.rs BATCH_RETRIEVE_TIMEOUT = 10s)
# and a short bounded retry for transient transport failures — a worker
# restarting mid-fetch should not fail the whole block.
BATCH_RETRIEVE_TIMEOUT = 10.0
BATCH_RETRY_ATTEMPTS = 3
BATCH_RETRY_DELAY = 0.25


class _BatchTimeout(Exception):
    """Internal: a worker held the connection but exceeded the per-batch
    deadline (distinct from transport errors, which map to BatchError)."""


class BlockError(Exception):
    def __init__(self, digest: Digest, kind: str):
        super().__init__(f"block {digest.hex()[:16]}: {kind}")
        self.digest = digest
        self.kind = kind  # "BlockNotFound" | "BatchTimeout" | "BatchError"


@dataclass
class BlockResponse:
    digest: Digest
    batches: list[tuple[Digest, Batch]]


class BlockWaiter:
    def __init__(
        self,
        name: PublicKey,
        worker_cache: WorkerCache,
        certificate_store: CertificateStore,
        network: NetworkClient,
        block_synchronizer=None,  # optional: fetch unknown certs from peers
        batch_timeout: float = BATCH_RETRIEVE_TIMEOUT,
        retry_attempts: int = BATCH_RETRY_ATTEMPTS,
        retry_delay: float = BATCH_RETRY_DELAY,
    ):
        self.name = name
        self.worker_cache = worker_cache
        self.certificate_store = certificate_store
        self.network = network
        self.block_synchronizer = block_synchronizer
        self.batch_timeout = batch_timeout
        self.retry_attempts = retry_attempts
        self.retry_delay = retry_delay
        # Dedup map: one in-flight fetch per block digest
        # (block_waiter.rs pending_get_block).
        self._pending: dict[Digest, asyncio.Future] = {}

    async def get_block(self, digest: Digest) -> BlockResponse:
        fut = self._pending.get(digest)
        if fut is None:
            fut = asyncio.ensure_future(self._fetch_block(digest))
            self._pending[digest] = fut
            fut.add_done_callback(lambda _: self._pending.pop(digest, None))
        return await asyncio.shield(fut)

    async def get_blocks(self, digests: list[Digest]) -> list[BlockResponse | BlockError]:
        results = await asyncio.gather(
            *(self.get_block(d) for d in digests), return_exceptions=True
        )
        out: list[BlockResponse | BlockError] = []
        for digest, res in zip(digests, results):
            if isinstance(res, BlockResponse):
                out.append(res)
            elif isinstance(res, BlockError):
                out.append(res)
            else:
                out.append(BlockError(digest, "BatchError"))
        return out

    async def _certificate(self, digest: Digest) -> Certificate | None:
        cert = self.certificate_store.read(digest)
        if cert is None and self.block_synchronizer is not None:
            certs = await self.block_synchronizer.synchronize_block_headers([digest])
            for c in certs:
                if c.digest == digest:
                    return c
        return cert

    async def _fetch_block(self, digest: Digest) -> BlockResponse:
        certificate = await self._certificate(digest)
        if certificate is None:
            raise BlockError(digest, "BlockNotFound")
        payload = list(certificate.header.payload.items())
        groups: dict[int, list[Digest]] = {}
        for d, w in payload:
            groups.setdefault(w, []).append(d)
        # One coalesced fetch per target worker; return_exceptions keeps
        # sibling worker fetches from running on unobserved after the first
        # failure. A deadline anywhere outranks transport errors in the
        # reported kind (block_waiter.rs maps the per-batch deadline to
        # BatchTimeout).
        results = await asyncio.gather(
            *(self._fetch_batches(w, ds) for w, ds in groups.items()),
            return_exceptions=True,
        )
        if any(isinstance(r, _BatchTimeout) for r in results):
            raise BlockError(digest, "BatchTimeout")
        fetched: dict[Digest, Batch] = {}
        for r in results:
            if isinstance(r, BaseException):
                logger.debug("block %s batch error: %s", digest.hex()[:16], r)
                raise BlockError(digest, "BatchError")
            fetched.update(r)
        return BlockResponse(digest, [(d, fetched[d]) for d, _ in payload])

    async def _fetch_batches(
        self, worker_id: int, digests: list[Digest]
    ) -> dict[Digest, Batch]:
        """Every batch one worker holds for this block, under the per-batch
        deadline, as one RequestBatchesMsg round trip; transient transport
        failures retry a bounded number of times so a restarting worker
        doesn't fail the block. Partial responses are authoritative: a
        found=False entry means the worker lacks the batch and retrying
        won't help (BatchError), exactly the single-fetch semantics."""
        info = self.worker_cache.worker(self.name, worker_id)
        last: Exception | None = None
        # One deadline covers ALL attempts: retries are for fast transport
        # failures (connection refused while a worker restarts) and must not
        # stretch the reference's hard per-batch bound.
        deadline = now() + self.batch_timeout
        for attempt in range(self.retry_attempts):
            remaining = deadline - now()
            if remaining <= 0:
                break
            try:
                resp: RequestedBatchesMsg = await asyncio.wait_for(
                    self.network.request(
                        info.worker_address, RequestBatchesMsg(tuple(digests)),
                        timeout=None,
                    ),
                    remaining,
                )
            except asyncio.TimeoutError:
                raise _BatchTimeout(
                    f"worker {worker_id} batches "
                    f"{[d.hex()[:16] for d in digests[:3]]} "
                    f"deadline ({self.batch_timeout}s)"
                ) from None
            except (RpcError, OSError) as e:
                last = e
                if attempt + 1 < self.retry_attempts:
                    await asyncio.sleep(
                        min(self.retry_delay * (attempt + 1),
                            max(0.0, deadline - now()))
                    )
                continue
            entries = {d: (found, raw) for d, found, raw in resp.batches}
            out: dict[Digest, Batch] = {}
            for d in digests:
                found, raw = entries.get(d, (False, b""))
                if not found or serialized_batch_digest(raw) != d:
                    # The worker answered authoritatively: retrying won't
                    # help (the reference's BatchError reply path).
                    raise RpcError(
                        f"worker {worker_id} lacks batch {d.hex()[:16]}"
                    )
                out[d] = Batch.from_bytes(raw)
            return out
        if last is not None:
            raise last
        raise _BatchTimeout(
            f"worker {worker_id} batches {[d.hex()[:16] for d in digests[:3]]} "
            f"deadline ({self.batch_timeout}s)"
        )
