"""The Consensus actor: feeds certificates to the ordering engine.

Port copy of `narwhal_tpu/consensus/runner.py` (the JAX package's
counterpart). The PyTorch port keeps its own copy so that it imports nothing
of `narwhal_tpu`. Its device-backed protocols are
`gpu.dag_kernels.GpuBullshark` and `GpuTusk`: a burst goes to
`process_batch_async` (one `window_sync` launch a view, one `chain_commit`
launch a commit event), a lone certificate to `process_certificate_async`,
and `recover` rebuilds the card's window from the recovered host DAG.

Reference: narwhal/consensus/src/consensus.rs:175-361 — recover state
from the consensus/certificate stores, then loop: pull certificates from the
primary, run the protocol, forward ordered outputs to the executor
(tx_output) and committed certificates back to the primary (tx_primary, which
drives StateHandler GC), logging the benchmark-parsed "Committed ..." lines.
Epoch changes observed on the reconfigure watch reset the state.
"""

from __future__ import annotations

import asyncio
import logging

from ..channels import Channel, Subscriber, Watch
from ..config import Committee
from ..stores import CertificateStore, ConsensusStore
from ..types import Certificate, ConsensusOutput, ReconfigureNotification, Round
from .state import ConsensusState

logger = logging.getLogger("narwhal.consensus")


class Consensus:
    def __init__(
        self,
        committee: Committee,
        protocol,
        consensus_store: ConsensusStore,
        cert_store: CertificateStore,
        rx_new_certificates: Channel,
        tx_primary: Channel,
        tx_output: Channel,
        rx_reconfigure: Watch,
        gc_depth: Round,
        metrics=None,
        tx_accepted: Channel | None = None,  # non-blocking tap -> Prefetcher
        commit_tap=None,  # callable(ConsensusOutput): observation hook
    ):
        self.committee = committee
        self.protocol = protocol
        self.consensus_store = consensus_store
        self.cert_store = cert_store
        self.rx_new_certificates = rx_new_certificates
        self.tx_primary = tx_primary
        self.tx_output = tx_output
        self.rx_reconfigure = Subscriber(rx_reconfigure)
        self.gc_depth = gc_depth
        self.metrics = metrics
        self.tx_accepted = tx_accepted
        # Synchronous, non-blocking observation hook per committed output:
        # the simnet safety/liveness oracles read the exact commit sequence
        # here without adding a channel (and without racing the executor).
        self.commit_tap = commit_tap
        self.consensus_index = consensus_store.last_consensus_index()
        self.state = ConsensusState.new_from_store(
            Certificate.genesis(committee),
            consensus_store.read_last_committed(),
            cert_store,
            gc_depth,
            metrics,
        )
        # Device-backed protocols mirror the recovered host DAG into their
        # window tensors (GpuBullshark.recover); host engines need nothing.
        if hasattr(protocol, "recover"):
            protocol.recover(self.state)
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    async def run(self) -> None:
        recon_task = asyncio.ensure_future(self.rx_reconfigure.changed())
        cert_task = asyncio.ensure_future(self.rx_new_certificates.recv())
        try:
            while True:
                done, _ = await asyncio.wait(
                    {recon_task, cert_task}, return_when=asyncio.FIRST_COMPLETED
                )
                if recon_task in done:
                    note: ReconfigureNotification = recon_task.result()
                    if note.kind == "shutdown":
                        return
                    if note.committee is not None:
                        self.committee = note.committee
                        self.protocol.update_committee(note.committee)
                        self.state = ConsensusState(
                            Certificate.genesis(note.committee), self.metrics
                        )
                        self.consensus_index = 0
                        logger.info("Committee updated to epoch %s", note.committee.epoch)
                    recon_task = asyncio.ensure_future(self.rx_reconfigure.changed())
                if cert_task in done:
                    certs: list[Certificate] = [cert_task.result()]
                    # Greedy bounded drain: a burst of certificates from
                    # the primary is ordered in one pass instead of one
                    # select round-trip per certificate.
                    while len(certs) < 64:
                        extra = self.rx_new_certificates.try_recv()
                        if extra is None:
                            break
                        certs.append(extra)
                    cert_task = asyncio.ensure_future(self.rx_new_certificates.recv())
                    batch: list[Certificate] = []
                    for certificate in certs:
                        if certificate.epoch != self.committee.epoch:
                            continue  # stale epoch, drop
                        if self.metrics is not None:
                            # Stage tracing: acceptance -> sequenced in a
                            # committed causal history (_emit stops it).
                            self.metrics.commit_timer.start(certificate.digest)
                        if self.tx_accepted is not None:
                            # Speculative prefetch tap: batch digests are
                            # known NOW, rounds before this certificate can
                            # commit. Strictly non-blocking — speculation
                            # must never backpressure ordering, so a full
                            # channel just drops the hint (the commit-time
                            # fetch covers it).
                            if (
                                not self.tx_accepted.try_send(certificate)
                                and self.metrics is not None
                            ):
                                self.metrics.accepted_tap_dropped.inc()
                        batch.append(certificate)
                    if len(batch) > 1 and hasattr(
                        self.protocol, "process_batch_async"
                    ):
                        # Device-backed burst path: one batched window
                        # scatter + per-event dispatches with readbacks
                        # deferred one event (the fused pipeline), instead
                        # of one full dispatch round trip per certificate.
                        sequence = await self.protocol.process_batch_async(
                            self.state, self.consensus_index, batch
                        )
                        await self._emit(sequence)
                    else:
                        for certificate in batch:
                            await self._process(certificate)
        finally:
            recon_task.cancel()
            cert_task.cancel()

    async def _process(self, certificate: Certificate) -> None:
        if hasattr(self.protocol, "process_certificate_async"):
            # Device-backed protocols overlap their device->host readback
            # with the rest of the node's event loop.
            sequence = await self.protocol.process_certificate_async(
                self.state, self.consensus_index, certificate
            )
        else:
            sequence = self.protocol.process_certificate(
                self.state, self.consensus_index, certificate
            )
        await self._emit(sequence)

    async def _emit(self, sequence: list[ConsensusOutput]) -> None:
        if sequence:
            self.consensus_index = sequence[-1].consensus_index + 1
        for output in sequence:
            cert = output.certificate
            if cert.round % 10 == 0:
                logger.debug("Committed %s round %s", cert.digest.hex()[:16], cert.round)
            # The benchmark-parsed commit lines (consensus.rs:305-316): one
            # per payload batch, mirroring the Created lines.
            logger.info("Committed B%s(%s)", cert.round, cert.digest.hex())
            for batch_digest in cert.header.payload:
                logger.info(
                    "Committed B%s(%s) -> %s",
                    cert.round,
                    cert.digest.hex(),
                    batch_digest.hex(),
                )
            if self.metrics is not None:
                self.metrics.last_committed_round.set(self.state.last_committed_round)
                self.metrics.committed_certificates.inc()
                self.metrics.commit_timer.stop(cert.digest)
            if self.commit_tap is not None:
                self.commit_tap(output)
            await self.tx_primary.send(cert)
            await self.tx_output.send(output)
        if self.metrics is not None:
            self.metrics.consensus_dag_size.set(self.state.dag_size())
