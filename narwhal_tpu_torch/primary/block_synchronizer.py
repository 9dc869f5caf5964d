"""BlockSynchronizer: fetch missing certificates and payloads from peers.

Port copy of `narwhal_tpu/primary/block_synchronizer.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/block_synchronizer/{mod,handler,
peers}.rs — three flows:

- `synchronize_block_headers(digests)`: certificates we lack are requested
  from peer primaries (`CertificatesBatchRequest`); responses are verified
  and re-injected into the Core (loopback channel) for causal completion,
  exactly like handler.rs:200-260.
- `synchronize_block_payloads(certs)`: ask peers who holds each payload
  (`PayloadAvailabilityRequest`), then instruct our workers to `Synchronize`
  the batches from the matching peer workers; completion is awaited on the
  payload store's notify primitive.
- `synchronize_range(from_round)`: restart catch-up — collect certificate
  digests above our last round from peers (`CertificatesRangeRequest`) and
  pull the certificates (mod.rs:75-83).

Peer selection mirrors peers.rs: every peer carries a weight that successful
answers raise and failures halve, selection is weight-biased with jitter (so
a recovered peer can regain standing), and payload sync rotates through the
peers that declared availability instead of hammering the first one.
"""

from __future__ import annotations

import asyncio
import logging
import random
from collections import defaultdict

from ..clock import now
from ..config import Committee, Parameters, WorkerCache
from ..messages import (
    CertificatesBatchRequest,
    CertificatesBatchResponse,
    CertificatesRangeRequest,
    CertificatesRangeResponse,
    PayloadAvailabilityRequest,
    PayloadAvailabilityResponse,
    SynchronizeMsg,
)
from ..network import NetworkClient, RpcError
from ..stores import CertificateStore, PayloadStore
from ..types import Certificate, Digest, InvalidSignatureError, PublicKey

logger = logging.getLogger("narwhal.primary")

CERTIFICATE_RESPONSES_RATIO_THRESHOLD = 0.5  # mod.rs:58


class PeerScores:
    """Weighted peer standing (narwhal/primary/src/block_synchronizer/
    peers.rs): successes add, failures halve, and selection multiplies the
    score by a random jitter so low-scored peers are still probed
    occasionally and can recover after an outage."""

    INITIAL = 10.0
    MIN = 0.5
    MAX = 100.0

    def __init__(self, rng: random.Random | None = None):
        self._scores: dict[PublicKey, float] = {}
        # Falling back to the module means the scenario-seeded global
        # stream under simnet (scenario.py seeds it per plan) — replayable;
        # tests inject a dedicated random.Random for isolation.
        self._rng = rng or random  # lint: allow(unseeded-random)

    def score(self, peer: PublicKey) -> float:
        return self._scores.get(peer, self.INITIAL)

    def reward(self, peer: PublicKey) -> None:
        self._scores[peer] = min(self.MAX, self.score(peer) + 1.0)

    def penalize(self, peer: PublicKey) -> None:
        self._scores[peer] = max(self.MIN, self.score(peer) / 2.0)

    def select(
        self, candidates: list[tuple[PublicKey, str]], count: int
    ) -> list[tuple[PublicKey, str]]:
        return sorted(
            candidates,
            key=lambda pa: -self.score(pa[0]) * self._rng.uniform(0.5, 1.0),
        )[:count]


class BlockSynchronizer:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        worker_cache: WorkerCache,
        certificate_store: CertificateStore,
        payload_store: PayloadStore,
        network: NetworkClient,
        parameters: Parameters,
        tx_loopback=None,  # re-inject fetched certificates into the Core
        crypto_pool=None,  # gpu.verifier.VerifyService: batched verify
    ):
        self.name = name
        self.committee = committee
        self.worker_cache = worker_cache
        self.certificate_store = certificate_store
        self.payload_store = payload_store
        self.network = network
        self.parameters = parameters
        self.tx_loopback = tx_loopback
        self.crypto_pool = crypto_pool
        self.peers = PeerScores()  # peers.rs standing

    # -- peer selection ---------------------------------------------------

    def _peers(self, count: int) -> list[tuple[PublicKey, str]]:
        others = [
            (pk, address)
            for pk, address, _net in self.committee.others_primaries(self.name)
        ]
        return self.peers.select(others, count)

    # -- certificates -----------------------------------------------------

    async def synchronize_block_headers(
        self, digests: list[Digest], timeout: float | None = None
    ) -> list[Certificate]:
        """Return certificates for `digests`, fetching missing ones from
        peers; fetched certificates are verified, stored via the Core
        loopback, and returned."""
        found: dict[Digest, Certificate] = {}
        missing: list[Digest] = []
        for digest in digests:
            cert = self.certificate_store.read(digest)
            if cert is not None:
                found[digest] = cert
            else:
                missing.append(digest)
        if missing:
            fetched = await self._fetch_certificates(
                missing, timeout or self.parameters.sync_retry_delay * 4
            )
            for cert in fetched:
                found[cert.digest] = cert
        return [found[d] for d in digests if d in found]

    async def _verify_certificate(self, cert: Certificate) -> None:
        """Certificate.verify with the signature work routed through the
        node's crypto pool when one is configured (catch-up
        sync of compact certificates through the pure-Python
        host_verify_aggregate costs ~one scalar-mul per signer per cert —
        minutes for a long N=50 round range — while the pool's aggregate
        lane fuses whole batches into one device dispatch). Semantics match
        the VerifierStage: structural checks inline, signatures batched."""
        if self.crypto_pool is None:
            # Documented no-pool fallback (full-format cpu committees);
            # compact proofs inside still take the cached single-group MSM.
            # lint: allow(no-per-item-cert-verify)
            cert.verify(self.committee, self.worker_cache)
            return
        if cert.is_compact:
            group = cert.aggregate_group(self.committee)
            if group is None:  # genesis
                return
            cert.header.verify(
                self.committee, self.worker_cache, check_signature=False
            )
            results = await asyncio.gather(
                self.crypto_pool.verify(*cert.header.signature_item()),
                self.crypto_pool.verify_aggregate(*group),
            )
        else:
            items = cert.verify_items(self.committee)
            if not items:  # genesis
                return
            cert.header.verify(
                self.committee, self.worker_cache, check_signature=False
            )
            items.append(cert.header.signature_item())
            results = await asyncio.gather(
                *(self.crypto_pool.verify(*item) for item in items)
            )
        if not all(results):
            raise InvalidSignatureError("fetched certificate failed verification")

    async def _fetch_certificates(
        self, digests: list[Digest], timeout: float
    ) -> list[Certificate]:
        peers = self._peers(self.parameters.sync_retry_nodes)
        if not peers:
            return []

        async def ask(peer: PublicKey, address: str) -> list[Certificate]:
            try:
                resp: CertificatesBatchResponse = await self.network.request(
                    address, CertificatesBatchRequest(tuple(digests)), timeout=timeout
                )
            except (RpcError, OSError, asyncio.TimeoutError):
                self.peers.penalize(peer)
                raise
            got = [c for _, c in resp.certificates if c is not None]
            self.peers.reward(peer)
            return got

        tasks = [asyncio.ensure_future(ask(p, a)) for p, a in peers]
        wanted = set(digests)
        collected: dict[Digest, Certificate] = {}
        try:
            for fut in asyncio.as_completed(tasks, timeout=timeout):
                try:
                    certs = await fut
                except (RpcError, OSError, asyncio.TimeoutError) as e:
                    # Individual peer failure: ask() already penalized its
                    # score; other peers may still satisfy the want-list.
                    logger.debug("certificate fetch peer failed: %r", e)
                    continue
                for cert in certs:
                    if cert.digest in wanted and cert.digest not in collected:
                        try:
                            await self._verify_certificate(cert)
                        except Exception as e:
                            logger.warning("peer sent invalid certificate: %s", e)
                            continue
                        collected[cert.digest] = cert
                if len(collected) == len(wanted):
                    break
        except asyncio.TimeoutError:
            logger.debug(
                "certificate fetch deadline: %d/%d collected",
                len(collected),
                len(wanted),
            )
        finally:
            for t in tasks:
                t.cancel()
        # Hand fetched certificates to the Core for causal completion +
        # storage (handler.rs:233-249).
        if self.tx_loopback is not None:
            for cert in collected.values():
                await self.tx_loopback.send(cert)
        return list(collected.values())

    # -- payloads ---------------------------------------------------------

    async def synchronize_block_payloads(
        self, certificates: list[Certificate], timeout: float | None = None
    ) -> list[Certificate]:
        """Ensure the payload of each certificate is available in our
        workers' stores; returns the certificates whose payload arrived.

        Retry loop with availability rotation (peers.rs + mod.rs:900-1050):
        each attempt targets the NEXT peer that declared availability for a
        still-missing payload, so one unresponsive provider cannot stall the
        sync until the outer timeout."""
        timeout = timeout or self.parameters.sync_retry_delay * 4
        deadline = now() + timeout

        def missing(cert: Certificate) -> bool:
            return any(
                not self.payload_store.contains(bd, wid)
                for bd, wid in cert.header.payload.items()
            )

        pending = [c for c in certificates if missing(c)]
        providers: dict[Digest, list[PublicKey]] = {}
        if pending:
            providers = await self._payload_providers(
                pending, min(timeout, self.parameters.sync_retry_delay * 2)
            )

        attempt = 0
        while pending and now() < deadline:
            await self._request_worker_sync(pending, providers, attempt)
            # Wait for arrivals until the retry tick, then rotate targets.
            waiters = [
                self.payload_store.notify_contains(bd, wid)
                for c in pending
                for bd, wid in c.header.payload.items()
                if not self.payload_store.contains(bd, wid)
            ]
            interval = min(
                self.parameters.sync_retry_delay, max(0.0, deadline - now())
            )
            if waiters:
                try:
                    await asyncio.wait_for(asyncio.gather(*waiters), interval)
                except asyncio.TimeoutError:  # lint: allow(no-silent-except)
                    pass  # retry tick by design; wait_for cancelled the gather
            pending = [c for c in pending if missing(c)]
            attempt += 1
        return [c for c in certificates if not missing(c)]

    async def _payload_providers(
        self, certificates: list[Certificate], timeout: float
    ) -> dict[Digest, list[PublicKey]]:
        """Which peers can serve each certificate's payload?"""
        digests = tuple(c.digest for c in certificates)
        peers = self._peers(self.parameters.sync_retry_nodes)
        providers: dict[Digest, list[PublicKey]] = defaultdict(list)

        async def ask(peer: PublicKey, address: str) -> None:
            try:
                resp: PayloadAvailabilityResponse = await self.network.request(
                    address, PayloadAvailabilityRequest(digests), timeout=timeout
                )
            except (RpcError, OSError, asyncio.TimeoutError):
                self.peers.penalize(peer)
                return
            for digest, available in resp.available:
                if available:
                    providers[digest].append(peer)
            self.peers.reward(peer)

        await asyncio.gather(*(ask(p, a) for p, a in peers))
        return providers

    async def _request_worker_sync(
        self,
        certificates: list[Certificate],
        providers: dict[Digest, list[PublicKey]],
        attempt: int = 0,
    ) -> None:
        """Tell our workers which batches to pull and from whom; `attempt`
        rotates through each payload's available providers (falling back to
        the certificate author) so retries fail over to a different peer."""
        by_worker: dict[int, dict[PublicKey, list[Digest]]] = defaultdict(
            lambda: defaultdict(list)
        )
        for cert in certificates:
            # The certificate author is always a last-resort provider: a
            # peer that declares availability but never serves (a liar or a
            # dead worker) must not monopolize the rotation.
            targets = list(providers.get(cert.digest) or [])
            if cert.origin not in targets:
                targets.append(cert.origin)
            target = targets[attempt % len(targets)]
            for batch_digest, worker_id in cert.header.payload.items():
                if not self.payload_store.contains(batch_digest, worker_id):
                    by_worker[worker_id][target].append(batch_digest)
        # One coalesced Synchronize per (worker, target) group, all groups
        # fanned out concurrently — never one awaited RTT per group.
        sends = [
            (
                self.worker_cache.worker(self.name, worker_id).worker_address,
                SynchronizeMsg(tuple(batch_digests), target),
            )
            for worker_id, per_target in by_worker.items()
            for target, batch_digests in per_target.items()
        ]
        if sends:
            await asyncio.gather(
                *(self.network.unreliable_send(a, m) for a, m in sends)
            )

    # -- range catch-up ---------------------------------------------------

    async def synchronize_range(
        self, from_round: int, to_round: int | None = None, timeout: float = 5.0
    ) -> list[Digest]:
        """Collect certificate digests in (from_round, to_round] known to a
        quorum-ish of peers (mod.rs SynchronizeRange), then fetch them."""
        peers = self._peers(max(self.parameters.sync_retry_nodes, 3))
        if not peers:
            return []
        req = CertificatesRangeRequest(from_round, to_round or (1 << 62))
        counts: dict[Digest, int] = defaultdict(int)
        answers = 0

        async def ask(peer: PublicKey, address: str) -> None:
            nonlocal answers
            try:
                resp: CertificatesRangeResponse = await self.network.request(
                    address, req, timeout=timeout
                )
            except (RpcError, OSError, asyncio.TimeoutError):
                self.peers.penalize(peer)
                return
            answers += 1
            for digest in resp.digests:
                counts[digest] += 1
            self.peers.reward(peer)

        await asyncio.gather(*(ask(p, a) for p, a in peers))
        if answers == 0:
            return []
        # Ceiling, not truncation: with 3 answers a digest needs 2 backers —
        # int() would let a single (possibly lying) peer's digest through.
        threshold = max(1, -(-answers * CERTIFICATE_RESPONSES_RATIO_THRESHOLD // 1))
        wanted = [
            d
            for d, n in counts.items()
            if n >= threshold and not self.certificate_store.contains(d)
        ]
        if wanted:
            await self._fetch_certificates(wanted, timeout)
        return wanted
