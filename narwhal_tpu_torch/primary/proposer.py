"""The Proposer: advances rounds and builds signed headers.

Port copy of `narwhal_tpu/primary/proposer.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/proposer.rs:26-338. A new header needs a
quorum of round r-1 parent certificates (delivered as complete sets by the
core) plus either `header_size` bytes of batch digests or the
`max_header_delay` timer. Under partial synchrony, even rounds wait for the
leader's certificate and odd rounds for evidence that a quorum voted on the
leader (update_leader / enough_votes / ready, proposer.rs:131-217) so the
whole committee advances in lock-step with the leader when the network is
timely.
"""

from __future__ import annotations

import asyncio
import enum
import logging

from ..channels import Channel, Subscriber, Watch
from ..clock import now
from ..config import Committee
from ..crypto import SignatureService
from ..types import Certificate, Digest, Header, PublicKey, Round, WorkerId

logger = logging.getLogger("narwhal.primary")


class NetworkModel(enum.Enum):
    """(narwhal/node/src/lib.rs:198-222): external consensus runs the
    DAG asynchronously; Bullshark assumes partial synchrony."""

    ASYNCHRONOUS = "asynchronous"
    PARTIALLY_SYNCHRONOUS = "partially_synchronous"


class Proposer:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        signature_service: SignatureService,
        header_size: int,
        max_header_delay: float,
        network_model: NetworkModel,
        rx_core: Channel,  # (parent certificates, round, epoch) from the core
        rx_workers: Channel,  # (batch digest, worker id) from our workers
        tx_core: Channel,  # our new headers to the core
        rx_reconfigure: Watch,
        metrics=None,
        pacing=None,  # pacing.PacingController: adaptive header delay
    ):
        self.name = name
        self.committee = committee
        self.signature_service = signature_service
        self.header_size = header_size
        self.max_header_delay = max_header_delay
        self.network_model = network_model
        self.rx_core = rx_core
        self.rx_workers = rx_workers
        self.tx_core = tx_core
        self.rx_reconfigure = Subscriber(rx_reconfigure)
        self.metrics = metrics
        self.pacing = pacing

        self.round: Round = 0
        self.last_parents: list[Certificate] = Certificate.genesis(committee)
        self.last_leader: Certificate | None = None
        self.digests: list[tuple[Digest, WorkerId]] = []
        self.payload_size = 0
        # When payload was last sighted — our own digests, or (via the
        # core's note_payload hook) ANY peer's payload-bearing header. Two
        # reasons this must outlive the payload itself: a committed
        # transaction needs the NEXT ~2 rounds too (Bullshark commits the
        # round-r leader once round r+2 exists), and round advance is gated
        # by a QUORUM of proposers — a node whose own worker saw no
        # transactions must still hurry while its peers carry payload, or
        # its idle-ceiling cadence paces the whole committee's commits.
        self._payload_seen_t = float("-inf")
        self.payload_grace = max(0.5, 3.0 * max_header_delay)
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    # -- leader gating (proposer.rs:131-217) ------------------------------
    def _update_leader(self) -> bool:
        """Even round: did we receive the current leader's certificate among
        the parents?"""
        leader = self.committee.leader(self.round)
        self.last_leader = next(
            (c for c in self.last_parents if c.origin == leader), None
        )
        return self.last_leader is not None

    def _enough_votes(self) -> bool:
        """Odd round: does the parent set prove the leader will (or cannot)
        get f+1 support at the even round below?"""
        if self.last_leader is None:
            return True
        leader_digest = self.last_leader.digest
        votes_for_leader = 0
        no_votes = 0
        for certificate in self.last_parents:
            stake = self.committee.stake(certificate.origin)
            if leader_digest in certificate.header.parents:
                votes_for_leader += stake
            else:
                no_votes += stake
        return (
            votes_for_leader >= self.committee.validity_threshold()
            or no_votes >= self.committee.quorum_threshold()
        )

    def _ready(self) -> bool:
        if self.network_model is NetworkModel.ASYNCHRONOUS:
            return True
        if self.round % 2 == 0:
            return self._update_leader()
        return self._enough_votes()

    # -- header construction ----------------------------------------------
    async def _make_header(self) -> None:
        if self.digests:
            self._payload_seen_t = now()
        header = Header.build(
            self.name,
            self.round,
            self.committee.epoch,
            dict(self.digests),
            {c.digest for c in self.last_parents},
            self.signature_service,
        )
        if self.metrics is not None:
            # Stage tracing: digest arrival -> included in a header, and the
            # certify clock this header's certificate will stop in the core.
            # The causal key hops here — batch digests fold into the header
            # digest — so record the link edges the waterfall joins on.
            tracer = self.metrics.tracer
            trace = tracer is not None and tracer.enabled
            for digest, _ in self.digests:
                self.metrics.propose_timer.stop(digest)
                if trace and tracer.sampled(digest):
                    tracer.link("propose", digest, header.digest)
            self.metrics.certify_timer.start(header.digest)
        self.digests.clear()
        self.payload_size = 0
        self.last_parents = []
        # Benchmark-parsed creation lines (proposer.rs:110-121): one line per
        # payload batch so the harness can tie batches to proposals.
        logger.info("Created B%s(%s)", header.round, header.digest.hex())
        for batch_digest in header.payload:
            logger.info(
                "Created B%s(%s) -> %s",
                header.round,
                header.digest.hex(),
                batch_digest.hex(),
            )
        if self.metrics is not None:
            self.metrics.proposed_headers.inc()
        await self.tx_core.send(header)

    def note_payload(self) -> None:
        """Committee-wide payload sighting (wired by Primary to the core's
        header path): a peer's payload-bearing header keeps THIS node's
        proposer on the floor cadence so the quorum advances rounds fast
        enough to commit it."""
        self._payload_seen_t = now()

    def _header_delay(self) -> float:
        """The effective header delay for this loop iteration. With a
        pacing controller the delay adapts between its floor and
        max_header_delay on queue occupancy — while payload is pending OR
        within payload_grace of the last sighting (the rounds that complete
        the last payload's commit). A genuinely idle proposer keeps the
        configured ceiling, so an unloaded committee does not spin empty
        rounds at the floor cadence forever (every round costs a header
        broadcast plus a quorum of votes)."""
        payload_active = (
            bool(self.digests)
            or not self.rx_workers.empty()
            or now() - self._payload_seen_t < self.payload_grace
        )
        if self.pacing is not None and payload_active:
            delay = self.pacing.delay()
        else:
            if self.pacing is not None:
                self.pacing.observe()  # keep the EWMA live across idle gaps
            delay = self.max_header_delay
        if self.metrics is not None:
            self.metrics.effective_header_delay.set(delay)
        return delay

    async def run(self) -> None:
        last_header_t = now()
        parents_task = asyncio.ensure_future(self.rx_core.recv())
        digest_task = asyncio.ensure_future(self.rx_workers.recv())
        recon_task = asyncio.ensure_future(self.rx_reconfigure.changed())
        try:
            while True:
                # Fixed deadline measured from the last proposed header,
                # recomputed each iteration so pacing changes (queues
                # draining or filling) take effect mid-round.
                timer_deadline = last_header_t + self._header_delay()
                enough_parents = bool(self.last_parents)
                enough_digests = self.payload_size >= self.header_size
                timer_expired = now() >= timer_deadline
                # The timer overrides the leader gating so the DAG cannot
                # stall when the leader is slow or faulty (proposer.rs:219-252).
                if (timer_expired or (enough_digests and self._ready())) and enough_parents:
                    if timer_expired and self.network_model is NetworkModel.PARTIALLY_SYNCHRONOUS:
                        logger.debug("Timer expired for round %s", self.round)
                    self.round += 1
                    if self.metrics is not None:
                        self.metrics.current_round.set(self.round)
                    logger.debug("Dag moved to round %s", self.round)
                    await self._make_header()
                    last_header_t = now()
                    timer_deadline = last_header_t + self._header_delay()

                # Past the deadline nothing changes until a message lands:
                # wait un-timed instead of polling with timeout=0 (with
                # floor-level delays that poll would busy-yield the loop
                # for the whole parent-quorum wait).
                remaining = timer_deadline - now()
                timeout = None if remaining <= 0 else remaining
                done, _ = await asyncio.wait(
                    {parents_task, digest_task, recon_task},
                    timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if recon_task in done:
                    note = recon_task.result()
                    if note.kind == "shutdown":
                        return
                    if note.committee is not None:
                        self.committee = note.committee
                        self.round = 0
                        self.last_parents = Certificate.genesis(self.committee)
                        self.digests.clear()
                        self.payload_size = 0
                        logger.info("Proposer reset for epoch %s", self.committee.epoch)
                    recon_task = asyncio.ensure_future(self.rx_reconfigure.changed())
                if parents_task in done:
                    parents, round_, epoch = parents_task.result()
                    parents_task = asyncio.ensure_future(self.rx_core.recv())
                    if epoch == self.committee.epoch:
                        if round_ > self.round:
                            # Jump to the parents' round: propose on top of
                            # them (proposer.rs:254-282).
                            self.round = round_
                            self.last_parents = parents
                        elif round_ == self.round:
                            # Post-quorum stragglers for the current round
                            # (e.g. the leader's certificate) extend the
                            # parent set rather than replace it.
                            self.last_parents.extend(parents)
                if digest_task in done:
                    digest, worker_id = digest_task.result()
                    digest_task = asyncio.ensure_future(self.rx_workers.recv())
                    self.digests.append((digest, worker_id))
                    self.payload_size += len(digest)
                    if self.metrics is not None:
                        self.metrics.propose_timer.start(digest)
        finally:
            parents_task.cancel()
            digest_task.cancel()
            recon_task.cancel()
