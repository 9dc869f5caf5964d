"""The Core: header/vote/certificate protocol state machine.

Port copy of `narwhal_tpu/primary/core.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/core.rs:36-715 — processes our own
headers (store, broadcast, self-vote), peers' headers (sanitize → parents &
payload availability → equivocation-protected vote), votes (stake aggregation
→ certificate assembly → broadcast), and certificates (causal-completeness
check → store → per-round quorum aggregation feeding the proposer → feed to
consensus). Garbage collection follows consensus round updates.
"""

from __future__ import annotations

import asyncio
import logging

from ..channels import Channel, Subscriber, Watch
from ..config import Committee, WorkerCache
from ..crypto import SignatureService
from ..network import NetworkClient
from ..stores import CertificateStore, HeaderStore, VoteDigestStore
from ..types import (
    Certificate,
    DagError,
    Digest,
    Header,
    InvalidEpoch,
    PublicKey,
    Round,
    TooOld,
    Vote,
)
from .aggregators import CertificatesAggregator, VotesAggregator
from .delta import (
    HeaderDeltaCodec,
    encode_announcement,
    encode_certificate_announcement,
)
from .synchronizer import Synchronizer
from .verifier_stage import PreVerified

logger = logging.getLogger("narwhal.primary")


class Core:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        worker_cache: WorkerCache,
        header_store: HeaderStore,
        certificate_store: CertificateStore,
        vote_digest_store: VoteDigestStore,
        synchronizer: Synchronizer,
        signature_service: SignatureService,
        network: NetworkClient,
        rx_primaries: Channel,  # Header | Vote | Certificate from peers
        rx_header_waiter: Channel,  # replayed headers whose deps arrived
        rx_certificate_waiter: Channel,  # replayed certificates
        rx_proposer: Channel,  # our own freshly built headers
        tx_consensus: Channel,
        tx_proposer: Channel,  # (parent certs, round, epoch)
        rx_consensus_round_updates: Watch,  # committed round for GC
        gc_depth: Round,
        rx_reconfigure: Watch,
        metrics=None,
        cert_format: str = "full",  # full | compact (Parameters.cert_format)
        fanout=None,  # fanout.FanoutBroadcaster: tree dissemination
        header_wire: str = "full",  # full | delta (Parameters.header_wire)
        wire_counters=None,  # network.WireCounters: per-round egress gauge
    ):
        self.name = name
        self.committee = committee
        self.worker_cache = worker_cache
        self.header_store = header_store
        self.certificate_store = certificate_store
        self.vote_digest_store = vote_digest_store
        self.synchronizer = synchronizer
        self.signature_service = signature_service
        self.network = network
        self.rx_primaries = rx_primaries
        self.rx_header_waiter = rx_header_waiter
        self.rx_certificate_waiter = rx_certificate_waiter
        self.rx_proposer = rx_proposer
        self.tx_consensus = tx_consensus
        self.tx_proposer = tx_proposer
        self.rx_consensus_round_updates = Subscriber(rx_consensus_round_updates)
        self.gc_depth = gc_depth
        self.rx_reconfigure = Subscriber(rx_reconfigure)
        self.metrics = metrics

        self.gc_round: Round = 0
        self.highest_received_round: Round = 0
        self.current_header: Header | None = None
        self.cert_format = cert_format
        # Wire diet: fanout-tree dissemination + delta-encoded
        # header/certificate announcements (primary/fanout.py, delta.py).
        # The codec always runs (decoding must work whatever WE send);
        # header_wire only selects the form we broadcast.
        self.fanout = fanout
        self.header_wire = header_wire
        self.delta_codec = HeaderDeltaCodec(committee)
        self.wire_counters = wire_counters
        self._egress_at_last_header = (
            wire_counters.bytes_sent if wire_counters is not None else 0
        )
        self.votes_aggregator = VotesAggregator(cert_format)
        self.certificates_aggregators: dict[Round, CertificatesAggregator] = {}
        self.processing: dict[Round, set[Digest]] = {}
        # Reliable-send handles by round, dropped (cancelled) at GC so a dead
        # peer can't accumulate retry-forever tasks (core.rs cancel_handlers).
        self.cancel_handlers: dict[Round, list] = {}
        # Channel the certificate waiter listens on; set by the assembly.
        self.tx_certificate_waiter: Channel | None = None
        # Committee-wide payload sighting hook (set by the assembly to the
        # proposer's note_payload): a peer's payload-bearing header keeps
        # OUR round cadence on the pacing floor so the quorum commits it
        # promptly even when our own worker is idle.
        self.on_payload_header = None
        # Messages from a FUTURE epoch: our reconfigure notification races
        # the first new-epoch header over different channels, and dropping
        # the loser can deadlock the epoch change (every peer drops every
        # other peer's round-1 header and nobody re-requests it). Hold a
        # bounded buffer and replay it the moment we adopt the new epoch.
        self.pending_future_epoch: list[tuple[object, bool]] = []
        # Deferred group-commit futures: header/certificate store writes
        # enqueue onto the engine's commit group (immediately visible via
        # the memtable) and are awaited ONCE per run-loop iteration, so a
        # burst of K messages costs one fused WAL flush, not K.
        self._pending_commits: list = []
        # Bounded greedy drain of each input channel per loop iteration: a
        # burst of K queued certificates becomes one grouped store commit
        # and one batched consensus/proposer hand-off instead of K
        # interleaved awaits.
        self.max_burst = 64
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    # ------------------------------------------------------------------
    # Own-header path (core.rs:149-179)
    # ------------------------------------------------------------------
    async def process_own_header(self, header: Header) -> None:
        self.current_header = header
        self.votes_aggregator = VotesAggregator(self.cert_format)
        if self.wire_counters is not None and self.metrics is not None:
            # Per-round egress: everything this primary wrote to the wire
            # since its previous header (the quantity the fanout tree +
            # delta encodings exist to shrink; MB/round from metrics, not
            # log scraping).
            # WireCounters are monotonic add-only tallies bumped by every
            # sender task; a read interleaving with an add is off by one
            # frame's bytes at worst — metrics-grade, not protocol state.
            total = self.wire_counters.bytes_sent  # lint: allow(multi-task-mutation)
            self.metrics.round_egress_bytes.set(total - self._egress_at_last_header)
            self._egress_at_last_header = total
        self.delta_codec.note_own_header(header)
        msg = encode_announcement(self.delta_codec, header, self.header_wire)
        self._broadcast(header.round, msg)
        await self.process_header(header)

    def _broadcast(self, round: Round, msg) -> None:
        """Disseminate an announcement: through the fanout tree when one is
        wired (it owns + GCs the handles), else the reference's all-to-all
        reliable broadcast with round-keyed cancel handles."""
        if self.fanout is not None:
            self.fanout.broadcast(round, msg)
            return
        addresses = [
            addr for _, addr, _ in self.committee.others_primaries(self.name)
        ]
        handlers = self.network.broadcast(addresses, msg)
        self.cancel_handlers.setdefault(round, []).extend(handlers)

    # ------------------------------------------------------------------
    # Header path (core.rs:183-355)
    # ------------------------------------------------------------------
    async def process_header(self, header: Header) -> None:
        self.processing.setdefault(header.round, set()).add(header.digest)
        # Headers reach us a full round before their certificates: index
        # the DERIVED certificate digest now so peers' next-round delta
        # headers reconstruct without waiting on the certificate broadcast.
        self.delta_codec.note_header(header)
        if header.payload and self.on_payload_header is not None:
            self.on_payload_header()

        # Causal completeness: parents must be certified and local
        # (core.rs:200-231). The synchronizer queues repair + loopback.
        parents = await self.synchronizer.get_parents(header)
        if parents is None:
            logger.debug("Header %s suspended: missing parents", header.digest.hex()[:16])
            if self.metrics is not None:
                self.metrics.headers_suspended.inc()
            return
        # Always run the round-match and stake-quorum checks — genesis
        # certificates count toward the quorum like any parent
        # (synchronizer.rs:119-125, core.rs:214-231). An empty parent set
        # yields zero stake and is rejected here, never voted for.
        stake = sum(self.committee.stake(p.origin) for p in parents)
        if any(p.round + 1 != header.round for p in parents):
            raise DagError(f"header {header.digest.hex()[:16]} has malformed parents")
        if stake < self.committee.quorum_threshold():
            raise DagError(
                f"header {header.digest.hex()[:16]} lacks parent quorum"
            )

        # Payload availability (core.rs:233-246).
        if await self.synchronizer.missing_payload(header):
            logger.debug("Header %s suspended: missing payload", header.digest.hex()[:16])
            if self.metrics is not None:
                self.metrics.headers_suspended.inc()
            return

        # Group commit: the header is readable (and notify_read fires)
        # immediately via the memtable; durability is awaited once per
        # run-loop burst rather than per header.
        self._pending_commits.append(self.header_store.write_async(header))
        if self.metrics is not None:
            self.metrics.headers_processed.inc()

        # Equivocation-protected voting (core.rs:281-308): vote at most once
        # per (origin, round), persistently.
        last = self.vote_digest_store.read(header.author)
        if last is not None:
            last_round, last_digest = last
            if header.round < last_round:
                return
            if header.round == last_round and last_digest != header.digest:
                logger.warning(
                    "Authority %s equivocated at round %s",
                    header.author.hex()[:16],
                    header.round,
                )
                return
            if header.round == last_round and last_digest == header.digest and header.author != self.name:
                pass  # re-vote the same header is safe (vote may have been lost)
        # The equivocation guard must be durable BEFORE the vote leaves this
        # node (a crash in between could re-vote differently on restart), so
        # this one write awaits its commit group — concurrent writers across
        # the process share the flush.
        await self.vote_digest_store.write_async(
            header.author, header.round, header.digest
        )

        vote = Vote.for_header(header, self.name, self.signature_service)
        if header.author == self.name:
            await self.process_vote(vote)
        else:
            from ..messages import Vote2Msg

            # Slim wire form (the author reconstructs round/epoch/origin
            # from its own header); generous per-attempt deadline — a
            # deadline miss on a loaded committee means the author is slow,
            # and the resent 200-byte frames were measurable at N=50.
            address = self.committee.primary_address(header.author)
            handler = self.network.send(
                address, Vote2Msg.from_vote(vote), timeout=30.0
            )
            self.cancel_handlers.setdefault(header.round, []).append(handler)
            if self.metrics is not None:
                self.metrics.votes_sent.inc()

    # ------------------------------------------------------------------
    # Vote path (core.rs:359-396)
    # ------------------------------------------------------------------
    async def process_vote(self, vote: Vote) -> None:
        if self.fanout is not None:
            # A vote proves the voter received our header broadcast — the
            # implicit receipt that replaces explicit relay acks on the
            # slim header lane (fanout.note_vote).
            self.fanout.note_vote(vote.round, vote.author)
        if self.current_header is None or vote.header_digest != self.current_header.digest:
            return  # vote for an old header of ours
        certificate = self.votes_aggregator.append(
            vote, self.committee, self.current_header
        )
        if self.metrics is not None:
            self.metrics.votes_processed.inc()
        if certificate is not None:
            logger.debug(
                "Assembled certificate %s round %s",
                certificate.digest.hex()[:16],
                certificate.round,
            )
            if self.metrics is not None:
                self.metrics.certificates_created.inc()
                # Stage tracing: the proposer started this clock when it
                # proposed the header this certificate certifies. The causal
                # key hops header -> certificate here, so record the link
                # edge the waterfall joins on.
                self.metrics.certify_timer.stop(certificate.header.digest)
                tracer = self.metrics.tracer
                if (
                    tracer is not None
                    and tracer.enabled
                    and tracer.sampled(certificate.header.digest)
                ):
                    tracer.link(
                        "certify", certificate.header.digest, certificate.digest
                    )
            # Compact certificates broadcast by reference (peers hold the
            # header already — they voted on it); full-format ones shed the
            # embedded header body the same way under header_wire="delta".
            msg = encode_certificate_announcement(certificate, self.header_wire)
            self._broadcast(certificate.round, msg)
            await self.process_certificate(certificate)

    # ------------------------------------------------------------------
    # Certificate path (core.rs:400-494)
    # ------------------------------------------------------------------
    async def process_certificate(self, certificate: Certificate) -> None:
        # Process the embedded header if we haven't seen it: its quorum of
        # signers proves the data exists, but we still want our local copy of
        # payload/parents fetched (core.rs:404-417).
        if certificate.header.digest not in self.processing.get(
            certificate.header.round, set()
        ):
            await self.process_header(certificate.header)

        # Ancestry must be locally complete before the DAG accepts it; the
        # certificate waiter replays it once parents arrive (core.rs:419-431).
        if not certificate.is_genesis() and not self.synchronizer.deliver_certificate(
            certificate
        ):
            logger.debug(
                "Certificate %s suspended: missing ancestors",
                certificate.digest.hex()[:16],
            )
            if self.metrics is not None:
                self.metrics.certificates_suspended.inc()
            if self.tx_certificate_waiter is not None:
                await self.tx_certificate_waiter.send(certificate)
            return

        self._pending_commits.append(
            self.certificate_store.write_async(certificate)
        )
        # Accepted certificates feed the delta codec's recent index: the
        # encoder resolves its own parents from here, the decoder any delta
        # header the core drains after this certificate.
        self.delta_codec.note_certificate(certificate)
        if self.metrics is not None:
            self.metrics.certificates_processed.inc()

        # Enough certificates at this round => next-round parents for the
        # proposer (core.rs:445-461).
        aggregator = self.certificates_aggregators.setdefault(
            certificate.round, CertificatesAggregator()
        )
        parents = aggregator.append(certificate, self.committee)
        if parents is not None:
            # Wait-cycle with the proposer (core -> tx_parents -> proposer
            # -> tx_headers -> core), justified: the protocol itself bounds
            # the in-flight count far below either capacity — the
            # aggregator emits at most ONE parent set per round, the
            # proposer at most one header per round, and neither side can
            # advance a round until the other consumed the previous item
            # (round advance is parent-quorum-gated). narwhal-topo flags
            # the shape; this argument is why it cannot fill.
            # lint: allow(bounded-channel-cycle)
            await self.tx_proposer.send(
                (parents, certificate.round, certificate.epoch)
            )

        await self.tx_consensus.send(certificate)

    # ------------------------------------------------------------------
    # Sanitization (core.rs:497-573)
    # ------------------------------------------------------------------
    def sanitize_header(self, header: Header, preverified: bool = False) -> None:
        if header.epoch != self.committee.epoch:
            raise InvalidEpoch(f"header from epoch {header.epoch}")
        if header.round <= self.gc_round:
            raise TooOld(f"header round {header.round} <= gc {self.gc_round}")
        header.verify(self.committee, self.worker_cache, check_signature=not preverified)

    def sanitize_vote(self, vote: Vote, preverified: bool = False) -> None:
        if vote.epoch != self.committee.epoch:
            raise InvalidEpoch(f"vote from epoch {vote.epoch}")
        if self.current_header is None or vote.round < self.current_header.round:
            raise TooOld(f"vote for stale round {vote.round}")
        vote.verify(self.committee, check_signature=not preverified)

    def sanitize_certificate(
        self, certificate: Certificate, preverified: bool = False
    ) -> None:
        if certificate.epoch != self.committee.epoch:
            raise InvalidEpoch(f"certificate from epoch {certificate.epoch}")
        if certificate.round < self.gc_round:
            raise TooOld(
                f"certificate round {certificate.round} < gc {self.gc_round}"
            )
        if preverified:
            # Signatures checked by the verifier stage; re-run only the
            # structural/stake checks (no message/weight recomputation).
            certificate.structural_verify(self.committee)
        else:
            # Terminal no-pool fallback (full-format cpu committees and the
            # block-synchronizer loopback): Certificate.verify itself rides
            # the cached single-group MSM for compact proofs, so the
            # loopback re-check of an already-pool-verified fetch is a
            # process-wide cache hit.
            # lint: allow(no-per-item-cert-verify)
            certificate.verify(self.committee, self.worker_cache)

    def _observe_round(self, round: Round) -> None:
        """Track the highest round seen for metrics (core.rs:434-443)."""
        if round > self.highest_received_round:
            self.highest_received_round = round

    # ------------------------------------------------------------------
    # Main loop (core.rs:615-715)
    # ------------------------------------------------------------------
    async def _handle_message(self, msg) -> None:
        preverified = isinstance(msg, PreVerified)
        if preverified:
            msg = msg.inner
        try:
            if isinstance(msg, Header):
                self.sanitize_header(msg, preverified)
                self._observe_round(msg.round)
                await self.process_header(msg)
            elif isinstance(msg, Vote):
                self.sanitize_vote(msg, preverified)
                await self.process_vote(msg)
            elif isinstance(msg, Certificate):
                self.sanitize_certificate(msg, preverified)
                self._observe_round(msg.round)
                await self.process_certificate(msg)
            else:
                logger.warning("Core received unexpected %r", type(msg))
        except (InvalidEpoch, TooOld) as e:
            if (
                isinstance(e, InvalidEpoch)
                and getattr(msg, "epoch", 0) == self.committee.epoch + 1
            ):
                # Exactly one epoch ahead: our own reconfigure notification
                # is in flight, not a byzantine replay (anything further
                # ahead IS dropped — a peer cannot legitimately outrun our
                # reconfigure by more than one epoch, and a bigger horizon
                # would let an adversary squat the buffer).
                if len(self.pending_future_epoch) < 128:
                    self.pending_future_epoch.append((msg, preverified))
                logger.debug("Buffered next-epoch message: %s", e)
            else:
                logger.debug("Dropped stale message: %s", e)
        except DagError as e:
            logger.warning("Rejected message: %s", e)

    async def _gc(self, committed_round: Round) -> None:
        if committed_round <= self.gc_depth:
            return
        gc_round = committed_round - self.gc_depth
        if gc_round <= self.gc_round:
            return
        self.gc_round = gc_round
        for r in [r for r in self.processing if r <= gc_round]:
            del self.processing[r]
        for r in [r for r in self.certificates_aggregators if r <= gc_round]:
            del self.certificates_aggregators[r]
        for r in [r for r in self.cancel_handlers if r <= gc_round]:
            for handler in self.cancel_handlers.pop(r):
                handler.cancel()
        self.delta_codec.gc(gc_round)
        if self.fanout is not None:
            self.fanout.gc(gc_round)
        if self.metrics is not None:
            self.metrics.gc_round.set(gc_round)

    async def run(self) -> None:
        channels = {
            "primaries": self.rx_primaries,
            "header_waiter": self.rx_header_waiter,
            "certificate_waiter": self.rx_certificate_waiter,
            "proposer": self.rx_proposer,
        }
        tasks = {
            key: asyncio.ensure_future(ch.recv()) for key, ch in channels.items()
        }
        recon_task = asyncio.ensure_future(self.rx_reconfigure.changed())
        round_task = asyncio.ensure_future(self.rx_consensus_round_updates.changed())
        try:
            while True:
                done, _ = await asyncio.wait(
                    set(tasks.values()) | {recon_task, round_task},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if recon_task in done:
                    note = recon_task.result()
                    if note.kind == "shutdown":
                        return
                    if note.committee is not None:
                        self.change_epoch(note.committee)
                        # Replay messages that arrived from this epoch before
                        # we adopted it (full re-sanitization: anything still
                        # ahead or now stale re-buffers or drops).
                        replay, self.pending_future_epoch = (
                            self.pending_future_epoch, []
                        )
                        for m, pv in replay:
                            await self._handle_message(
                                PreVerified(m) if pv else m
                            )
                    recon_task = asyncio.ensure_future(self.rx_reconfigure.changed())
                if round_task in done:
                    committed_round = round_task.result()
                    round_task = asyncio.ensure_future(
                        self.rx_consensus_round_updates.changed()
                    )
                    await self._gc(committed_round)
                for key, ch in channels.items():
                    task = tasks[key]
                    if task not in done:
                        continue
                    # Done asyncio task from the select set — result() is a
                    # completed-task read.  # lint: allow(no-blocking-in-async)
                    msgs = [task.result()]
                    # Greedy bounded drain: everything already queued (up
                    # to max_burst) is handled in this iteration, sharing
                    # one grouped store commit below instead of one select
                    # round-trip + flush each.
                    while len(msgs) < self.max_burst:
                        extra = ch.try_recv()
                        if extra is None:
                            break
                        msgs.append(extra)
                    tasks[key] = asyncio.ensure_future(ch.recv())
                    if self.metrics is not None:
                        self.metrics.core_burst.observe(len(msgs))
                    for msg in msgs:
                        if key == "proposer":
                            await self.process_own_header(msg)
                        elif key in ("header_waiter",):
                            # Replayed headers were sanitized on first
                            # receipt.
                            try:
                                await self.process_header(msg)
                            except DagError as e:
                                logger.warning("Replayed header rejected: %s", e)
                        elif key == "certificate_waiter":
                            try:
                                await self.process_certificate(msg)
                            except DagError as e:
                                logger.warning(
                                    "Replayed certificate rejected: %s", e
                                )
                        else:
                            await self._handle_message(msg)
                # One durability barrier per iteration: every store write
                # deferred above rides a shared fused WAL flush.
                if self._pending_commits:
                    commits, self._pending_commits = self._pending_commits, []
                    await asyncio.gather(*commits)
        finally:
            for t in tasks.values():
                t.cancel()
            recon_task.cancel()
            round_task.cancel()

    def change_epoch(self, committee: Committee) -> None:
        """(core.rs:592-611): fresh per-epoch volatile state."""
        self.committee = committee
        self.gc_round = 0
        self.highest_received_round = 0
        self.current_header = None
        self.votes_aggregator = VotesAggregator(self.cert_format)
        self.certificates_aggregators.clear()
        self.processing.clear()
        # Rounds restart at 0: the persistent per-author vote guard must be
        # wiped or no new-epoch header ever gets a vote (core.rs:598-601).
        self.vote_digest_store.clear()
        for handlers in self.cancel_handlers.values():
            for handler in handlers:
                handler.cancel()
        self.cancel_handlers.clear()
        self.delta_codec.change_epoch(committee)
        if self.fanout is not None:
            self.fanout.change_epoch(committee)
        self.synchronizer.update_genesis(self.committee)
