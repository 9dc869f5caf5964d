"""The CertificateWaiter: parks certificates until their parents are local.

Port copy of `narwhal_tpu/primary/certificate_waiter.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/certificate_waiter.rs:35-228 — each
parked certificate registers `notify_read` waiters on its missing parents in
the certificate store; once they all land (fetched by the header waiter's
repair of the embedded header, or broadcast by peers) the certificate is
looped back to the core for re-processing. GC cancels waiters below the
collection round.
"""

from __future__ import annotations

import asyncio
import logging

from ..channels import Channel, Subscriber, Watch
from ..stores import CertificateStore
from ..types import Certificate, Digest, Round

logger = logging.getLogger("narwhal.primary")


class CertificateWaiter:
    def __init__(
        self,
        certificate_store: CertificateStore,
        genesis_digests: frozenset[Digest],
        rx_synchronizer: Channel,  # suspended certificates from the core
        tx_core: Channel,  # replayed certificates
        rx_consensus_round_updates: Watch,
        rx_reconfigure: Watch,
        gc_depth: Round,
        metrics=None,
    ):
        self.certificate_store = certificate_store
        self.genesis_digests = genesis_digests
        self.rx_synchronizer = rx_synchronizer
        self.tx_core = tx_core
        self.rx_consensus_round_updates = Subscriber(rx_consensus_round_updates)
        self.rx_reconfigure = Subscriber(rx_reconfigure)
        self.gc_depth = gc_depth
        self.metrics = metrics

        self.gc_round: Round = 0
        self.pending: dict[Digest, tuple[Round, asyncio.Task]] = {}
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    async def _wait(self, certificate: Certificate) -> None:
        waiters = [
            self.certificate_store.notify_read(d)
            for d in certificate.header.parents
            if d not in self.genesis_digests and not self.certificate_store.contains(d)
        ]
        try:
            await asyncio.gather(*waiters)
        except asyncio.CancelledError:
            raise
        await self.tx_core.send(certificate)

    def _park(self, certificate: Certificate) -> None:
        if certificate.digest in self.pending:
            return
        task = asyncio.ensure_future(self._wait(certificate))
        self.pending[certificate.digest] = (certificate.round, task)

        def _done(t: asyncio.Task, digest=certificate.digest) -> None:
            self.pending.pop(digest, None)
            if self.metrics is not None:
                self.metrics.pending_certificate_waits.set(len(self.pending))
            if not t.cancelled() and t.exception() is not None:
                logger.warning("Certificate waiter failed: %r", t.exception())

        task.add_done_callback(_done)
        if self.metrics is not None:
            self.metrics.pending_certificate_waits.set(len(self.pending))

    async def run(self) -> None:
        cert_task = asyncio.ensure_future(self.rx_synchronizer.recv())
        recon_task = asyncio.ensure_future(self.rx_reconfigure.changed())
        round_task = asyncio.ensure_future(self.rx_consensus_round_updates.changed())
        try:
            while True:
                done, _ = await asyncio.wait(
                    {cert_task, recon_task, round_task},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if cert_task in done:
                    certificate = cert_task.result()
                    cert_task = asyncio.ensure_future(self.rx_synchronizer.recv())
                    if certificate.round > self.gc_round:
                        self._park(certificate)
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
                        self._cancel_all()
                        self.genesis_digests = frozenset(
                            c.digest for c in Certificate.genesis(note.committee)
                        )
                        self.gc_round = 0
                    recon_task = asyncio.ensure_future(self.rx_reconfigure.changed())
        finally:
            cert_task.cancel()
            recon_task.cancel()
            round_task.cancel()
            self._cancel_all()

    def _gc(self, committed_round: Round) -> None:
        if committed_round <= self.gc_depth:
            return
        gc_round = committed_round - self.gc_depth
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
