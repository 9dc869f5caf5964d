"""BlockRemover: delete certificates and everything that hangs off them.

Port copy of `narwhal_tpu/primary/block_remover.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/block_remover.rs:39-648 — for a set of
certificate digests, instruct our workers to `DeleteBatches` for the grouped
payload, await their confirmations (with timeout), then clear the primary's
header/certificate/payload stores and the external Dag. Partial worker
failure aborts the store cleanup so a retry stays possible.
"""

from __future__ import annotations

import asyncio
import logging
from collections import defaultdict

from ..config import WorkerCache
from ..messages import DeleteBatchesMsg, DeletedBatchesMsg
from ..network import NetworkClient, RpcError
from ..stores import CertificateStore, HeaderStore, PayloadStore
from ..types import Certificate, Digest, PublicKey, WorkerId

logger = logging.getLogger("narwhal.primary")

REMOVE_TIMEOUT = 10.0


class BlockRemoverError(Exception):
    def __init__(self, digests: list[Digest], kind: str):
        super().__init__(f"remove failed ({kind}) for {len(digests)} blocks")
        self.digests = digests
        self.kind = kind  # "Timeout" | "Failed"


class BlockRemover:
    def __init__(
        self,
        name: PublicKey,
        worker_cache: WorkerCache,
        certificate_store: CertificateStore,
        header_store: HeaderStore,
        payload_store: PayloadStore,
        network: NetworkClient,
        dag=None,  # external consensus Dag, when running without internal
    ):
        self.name = name
        self.worker_cache = worker_cache
        self.certificate_store = certificate_store
        self.header_store = header_store
        self.payload_store = payload_store
        self.network = network
        self.dag = dag

    async def remove_blocks(self, digests: list[Digest]) -> None:
        certificates = [
            c for c in (self.certificate_store.read(d) for d in digests) if c is not None
        ]
        # Group payload per worker (block_remover.rs batches_by_worker).
        by_worker: dict[WorkerId, list[Digest]] = defaultdict(list)
        for cert in certificates:
            for batch_digest, worker_id in cert.header.payload.items():
                by_worker[worker_id].append(batch_digest)

        async def delete_at(worker_id: WorkerId, batch_digests: list[Digest]):
            info = self.worker_cache.worker(self.name, worker_id)
            resp: DeletedBatchesMsg = await self.network.request(
                info.worker_address, DeleteBatchesMsg(tuple(batch_digests))
            )
            return resp

        try:
            await asyncio.wait_for(
                asyncio.gather(*(delete_at(w, ds) for w, ds in by_worker.items())),
                REMOVE_TIMEOUT,
            )
        except asyncio.TimeoutError:
            raise BlockRemoverError(digests, "Timeout") from None
        except (RpcError, OSError, KeyError) as e:
            logger.warning("worker batch deletion failed: %s", e)
            raise BlockRemoverError(digests, "Failed") from None

        # Workers confirmed: now clean the primary stores + external Dag.
        if self.dag is not None:
            from ..consensus.dag import ValidatorDagError

            try:
                await self.dag.remove([c.digest for c in certificates])
            except ValidatorDagError as e:
                logger.debug("dag removal: %s", e)
        self.payload_store.delete_all(
            (bd, wid)
            for cert in certificates
            for bd, wid in cert.header.payload.items()
        )
        self.header_store.delete_all(c.header.digest for c in certificates)
        self.certificate_store.delete_all(c.digest for c in certificates)
