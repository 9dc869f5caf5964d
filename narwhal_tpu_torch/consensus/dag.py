"""External-consensus Dag service over the generic compressed DAG.

Port of `narwhal_tpu/consensus/dag.py` (the JAX package's counterpart). It
imports nothing of `narwhal_tpu`; its device path is the port's own
`gpu.dag_kernels` (`DagWindow` and the `reach_many` CUDA kernel, B6).

Reference: narwhal/consensus/src/dag.rs:37-516 — an actor holding
`NodeDag<Certificate>` plus a `(PublicKey, Round) -> Digest` index, serving
Insert/Contains/HasEverContained/Rounds/ReadCausal/NodeReadCausal/Remove/
NotifyRead; GC is mark (remove -> make_compressible) and sweep (triggered by
`rounds`). Genesis certificates are inserted at construction and, being
payload-empty, are compressible — DAG walks never report them
(types/src/primary.rs:633-644).

Here the actor mailbox is replaced by a single asyncio lock: our runtime is
one event loop, so serialized async methods give the identical external
behavior without the command-enum plumbing.

ORDERING: ReadCausal/NodeReadCausal return the causal set in CANONICAL
order — round-descending, authority-index-ascending, digest as tiebreak —
on every backend. The reference's order is whatever its BFS visits
(dag/src/bft.rs:57-127); serving one deterministic order regardless of
backend (host BFS vs device reach walk) keeps the external API bit-stable
when a node switches serving paths mid-stream.

ROUTING (backend="cuda"): the device path pays a flat dispatch (a launch
and one readback) while the host BFS is O(live vertices); neither
dominates everywhere, so the service MEASURES both and routes each request
through a COST MODEL: predicted host cost = EWMA(seconds per reported
vertex) x live vertex count (the walk's footprint tracks the window
round-span x committee frontier), predicted device cost = EWMA(seconds per
fused dispatch) / (pending coalesce-queue depth + 1) — the flat dispatch
amortizes over every reader already waiting for the next flush. The
predicted loser is still probed periodically so the decision tracks drift.
Concurrent ReadCausal/NodeReadCausal requests coalesce into ONE
`reach_many` launch over the DEVICE-RESIDENT window (DagWindow.device_view:
inserts sync as a batched on-device scatter, slides as an on-device roll),
so the hot path uploads nothing but the [K] offsets and [K, N] start
one-hots, and reads the K masks back in one copy.

A failed launch is not hidden: each waiting reader gets the exception (no
host answer is served in its place). The host walk answers a device-routed
request only where the window does not cover the start (coverage is part
of the semantics, not a device failure).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import defaultdict

import numpy as np

from ..channels import Channel
from ..config import Committee
from ..dag import DroppedDigest, NodeDag, UnknownDigests
from ..gpu import HostCopy
from ..types import Certificate, Digest, PublicKey, Round

logger = logging.getLogger("narwhal.consensus.dag")

def _pow2_at_least(n: int) -> int:
    """Next power of two >= n (the coalesced dispatch's padded batch size;
    shared by the dispatch padding and the per-size compile-warm set so
    the two can never drift apart)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# EWMA smoothing for the per-path service-time estimates.
_ALPHA = 0.2
# Probe the currently-losing path every this many routed requests so the
# routing tracks load/geometry drift instead of freezing on stale numbers.
_PROBE_EVERY = 32


class ValidatorDagError(Exception):
    pass


class OutOfCertificates(ValidatorDagError):
    def __init__(self, origin: PublicKey):
        super().__init__(f"no certificates for origin {origin.hex()[:16]}")


class NoCertificateForCoordinates(ValidatorDagError):
    def __init__(self, origin: PublicKey, round: Round):
        super().__init__(f"no certificate at ({origin.hex()[:16]}, {round})")


class _CertVertex:
    """Adapter giving Certificate the Affiliated shape (digest attr +
    parents()/compressible() methods)."""

    __slots__ = ("cert",)

    def __init__(self, cert: Certificate):
        self.cert = cert

    @property
    def digest(self) -> Digest:
        return self.cert.digest

    def parents(self) -> list[Digest]:
        return sorted(self.cert.header.parents)

    def compressible(self) -> bool:
        # Genesis and empty blocks never show up in causal reads.
        return not self.cert.header.payload


class Dag:
    """The external consensus: certificates in, queryable DAG out.

    `spawn()` attaches the feed from the primary's tx_new_certificates
    channel (node/src/lib.rs:198-213); all query methods are usable with or
    without the feed running.

    `backend`: "cpu" (host BFS only) or "cuda" (the device window).
    `device` (backend="cuda" only): None means the card and raises without
    one; "cpu" runs `reach_many`'s plain version on CPU tensors (tests).

    `policy` (backend="cuda" only):
      adaptive — route each ReadCausal to host BFS or device reach walk by
                 measured EWMA service time (default);
      device   — always the device path when the window covers the history
                 (tests; kernel benchmarking);
      host     — never dispatch (the window still tracks inserts).
    """

    def __init__(
        self,
        committee: Committee,
        rx_primary: Channel | None = None,
        backend: str = "cpu",  # cpu | cuda: device-resident causal reads
        window: int = 64,
        policy: str = "adaptive",
        metrics=None,  # ConsensusMetrics: per-route latency + batch gauges
        device=None,  # backend="cuda": None = the card; "cpu" for tests
    ):
        self.rx_primary = rx_primary
        self._committee = committee
        self._dag: NodeDag = NodeDag()
        self._vertices: dict[tuple[PublicKey, Round], Digest] = {}
        # Live-vertex count per round, maintained incrementally so the
        # device backend's window-floor decisions are O(1) per operation
        # instead of rescanning every live vertex (the paths are sold as
        # flat in committee size).
        self._round_live: dict[Round, int] = defaultdict(int)
        self._min_live: Round = 0
        self._lock = asyncio.Lock()
        self._obligations: dict[Digest, list[asyncio.Future]] = defaultdict(list)
        self._task: asyncio.Task | None = None
        # Device window (backend="cuda"): the dense [W, N, N] adjacency of
        # the live rounds, so ReadCausal/NodeReadCausal run as ONE
        # reach_many launch — flat in committee size — instead of a host
        # BFS (the rayon-parallel walk of narwhal/dag/src/
        # lib.rs:231-276, re-expressed as a device scan).
        self._win = None
        if backend not in ("cpu", "cuda"):
            raise ValueError(f"unknown dag backend {backend!r}")
        if policy not in ("adaptive", "device", "host"):
            raise ValueError(f"unknown dag routing policy {policy!r}")
        self._policy = policy
        self._metrics = metrics
        # Cost-model routing state (policy="adaptive"): per-path amortized
        # per-request EWMAs (stats + cold-start fallbacks) plus the two
        # model coefficients — host seconds-per-reported-vertex and device
        # seconds-per-fused-dispatch.
        self._ewma = {"host": None, "dev": None}
        self._host_pv: float | None = None
        self._dev_dispatch: float | None = None
        self._last_batch = 0
        self._routed = {"host": 0, "dev": 0}
        self._route_n = 0
        # Padded batch sizes already dispatched once. The first dispatch at
        # each size stays out of the EWMA, as in the JAX service (where it
        # carried a jit compile), so routing decisions stay comparable with
        # it; on the card the first dispatch of the process carries the
        # kernel library's load (and its nvcc build when none is cached).
        self._dev_warmed: set[int] = set()
        # Coalescing queue: (start digest, future) pairs awaiting the next
        # fused device dispatch.
        self._dev_queue: list[tuple[Digest, asyncio.Future]] = []
        self._flush_task: asyncio.Task | None = None
        if backend == "cuda":
            from ..gpu.dag_kernels import DagWindow  # not at import: a cycle

            self._win = DagWindow(committee, window, device=device)
        for cert in Certificate.genesis(committee):
            self._insert(cert)

    # -- feed -------------------------------------------------------------

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self._run())
        return self._task

    async def _run(self) -> None:
        assert self.rx_primary is not None, "spawn() needs the primary feed"
        while True:
            certificate: Certificate = await self.rx_primary.recv()
            async with self._lock:
                # Core guarantees causal completion before handing certs over.
                try:
                    self._insert(certificate)
                except UnknownDigests as e:
                    logger.warning("dag feed: missing parents %s", e.digests)

    # -- internals (lock held by callers of the async wrappers) -----------

    def _vertices_changed(self, added: Round | None = None) -> None:
        """Maintain the per-round live counts after a single insert
        (`added`) or a bulk rebuild of `_vertices` (added=None)."""
        if added is not None:
            if self._round_live[added] == 0 and added < self._min_live:
                self._min_live = added
            self._round_live[added] += 1
            return
        self._round_live = defaultdict(int)
        for (_, r) in self._vertices:
            self._round_live[r] += 1
        self._min_live = min(self._round_live, default=0)

    def _floor(self) -> Round:
        """Lowest round with a live vertex, O(1) amortized."""
        while self._round_live and self._round_live.get(self._min_live, 0) == 0:
            self._round_live.pop(self._min_live, None)
            self._min_live += 1
        return self._min_live if self._round_live else 0

    def _insert(self, certificate: Certificate) -> None:
        self._dag.try_insert(_CertVertex(certificate))
        key = (certificate.origin, certificate.round)
        if key not in self._vertices:
            self._vertices_changed(added=certificate.round)
        self._vertices[key] = certificate.digest
        if self._win is not None:
            # keep_floor = lowest live round: the window may slide past
            # anything below it (those vertices are gone from _vertices),
            # preserving the invariant that every live round is in-window.
            self._win.insert(certificate, self._floor())
        for fut in self._obligations.pop(certificate.digest, []):
            if not fut.done():
                fut.set_result(certificate)

    # -- ordering ----------------------------------------------------------

    def _canonical(self, certs: list[Certificate]) -> list[Digest]:
        """The service's one deterministic output order: round-descending,
        authority-index-ascending, digest tiebreak. The start vertex is the
        strict round-maximum of its own causal history, so it always sorts
        first (the `d[0] == start` shape callers rely on)."""
        index_of = self._committee.index_of
        return [
            c.digest
            for c in sorted(
                certs, key=lambda c: (-c.round, index_of(c.origin), c.digest)
            )
        ]

    # -- device path -------------------------------------------------------

    def _dev_eligible(self, start: Digest):
        """(round, idx) when the window can serve `start`, else None."""
        if self._win is None:
            return None
        # DagWindow is a Dag-private composite: only Dag._run/Consensus.run
        # mutate it, always between awaits (no yield mid-update), and these
        # reads tolerate a one-round-stale window (the host walk stays
        # authoritative when coverage is incomplete).
        pos = self._win.digest_pos.get(start)  # lint: allow(multi-task-mutation)
        if pos is None:
            return None
        if self._floor() < self._win.round_base:  # lint: allow(multi-task-mutation)
            return None  # incomplete coverage; host walk is authoritative
        return pos

    def _device_causal_many(
        self, starts: list[tuple[Digest, tuple[Round, int]]]
    ) -> list[list[Digest]]:
        """All of `starts` in ONE `reach_many` launch over the
        device-resident window (the coalesced path: K concurrent readers pay
        one launch and one readback, and the [W, N, N] adjacency never
        leaves the device — only the [K] offsets and [K, N] one-hots
        upload). The walk runs through `present`; vertices no longer live
        and compressible interiors are dropped on the host below."""
        from ..gpu.dag_kernels import reach_many  # not at import: a cycle

        win = self._win
        parent_dev, present_dev = win.device_view()
        kpad = _pow2_at_least(len(starts))
        offs = np.zeros((kpad,), np.int32)
        onehots = np.zeros((kpad, win.N), np.uint8)
        for t, (_, (round_, idx)) in enumerate(starts):
            offs[t] = round_ - win.round_base
            onehots[t, idx] = 1
        masks_dev = reach_many(
            parent_dev, present_dev, win._upload(offs), win._upload(onehots)
        )
        (masks,) = HostCopy(masks_dev).result()  # all K masks in one copy
        out: list[list[Digest]] = []
        for t, (start, _) in enumerate(starts):
            certs: list[Certificate] = []
            ws, ns = np.nonzero(masks[t])
            for w, n in zip(ws.tolist(), ns.tolist()):
                cert = win.cert_at(win.round_base + int(w), int(n))
                if cert is None:
                    continue
                # NodeDag is Dag-owned; Dag._run is its only mutator and
                # never yields mid-update, so this read is atomic-consistent.
                node = self._dag._nodes.get(cert.digest)  # lint: allow(multi-task-mutation)
                if node is None or not node.live:
                    continue
                # The walk reports the start plus its INCOMPRESSIBLE
                # ancestors; the raw-edge mask also hits compressed interior
                # vertices — filter them (reachability through them is
                # identical).
                if cert.digest != start and node.compressible:
                    continue
                certs.append(cert)
            out.append(self._canonical(certs))
        return out

    # -- routing -----------------------------------------------------------

    def _record(self, path: str, dt: float) -> None:
        prev = self._ewma[path]
        self._ewma[path] = dt if prev is None else (1 - _ALPHA) * prev + _ALPHA * dt
        self._routed[path] += 1
        if self._metrics is not None:
            route = "host" if path == "host" else "device"
            self._metrics.dag_read_latency.labels(route).observe(dt)
            self._metrics.dag_read_route_ewma_ms.labels(route).set(
                self._ewma[path] * 1000
            )

    def _predict(self, path: str) -> float:
        """Predicted per-request service time (seconds) for routing one more
        request down `path` right now — the cost model of the module
        docstring. Falls back to the plain per-request EWMA until the model
        coefficient for a path has been measured."""
        if path == "host":
            if self._host_pv is not None:
                return self._host_pv * max(1, len(self._vertices))
            return self._ewma["host"]
        if self._dev_dispatch is not None:
            # One more rider on the next fused dispatch: the flat dispatch
            # cost splits across everyone already queued plus this request.
            return self._dev_dispatch / (len(self._dev_queue) + 1)
        return self._ewma["dev"]

    def _pick_path(self) -> str:
        """host | dev (policy='adaptive'): route to the cost model's
        predicted winner. Unmeasured paths get tried once; the predicted
        loser is re-probed every _PROBE_EVERY requests so the decision
        tracks load and geometry drift."""
        if self._policy == "device":
            return "dev"
        if self._policy == "host":
            return "host"
        if self._ewma["host"] is None:
            return "host"
        if self._ewma["dev"] is None:
            return "dev"
        self._route_n += 1
        fast, slow = (
            ("host", "dev")
            if self._predict("host") <= self._predict("dev")
            else ("dev", "host")
        )
        if self._route_n % _PROBE_EVERY == 0:
            return slow
        return fast

    def routing_stats(self) -> dict:
        """The live routing policy, for benchmarks/metrics: per-path call
        counts, EWMA service times (ms) and the cost-model coefficients."""
        return {
            "policy": self._policy,
            "host_calls": self._routed["host"],
            "dev_calls": self._routed["dev"],
            "ewma_host_ms": None
            if self._ewma["host"] is None
            else round(self._ewma["host"] * 1000, 3),
            "ewma_dev_ms": None
            if self._ewma["dev"] is None
            else round(self._ewma["dev"] * 1000, 3),
            "host_us_per_vertex": None
            if self._host_pv is None
            else round(self._host_pv * 1e6, 3),
            "dev_dispatch_ms": None
            if self._dev_dispatch is None
            else round(self._dev_dispatch * 1000, 3),
            "last_coalesced_batch": self._last_batch,
            "live_vertices": len(self._vertices),
        }

    # -- commands (consensus/src/dag.rs:370-516) ---------------------------

    async def insert(self, certificate: Certificate) -> None:
        async with self._lock:
            self._insert(certificate)

    async def contains(self, digest: Digest) -> bool:
        async with self._lock:
            return self._dag.contains_live(digest)

    async def has_ever_contained(self, digest: Digest) -> bool:
        async with self._lock:
            return self._dag.contains(digest)

    async def rounds(self, origin: PublicKey) -> tuple[Round, Round]:
        """(earliest, latest) live rounds for a validator; triggers the GC
        sweep first so answers match subsequent read_causal results."""
        async with self._lock:
            if self._dag.sweep():
                # Prune the coordinate index of tombstoned vertices, or it
                # grows with total history (the reference cleans it here too).
                self._vertices = {
                    k: d
                    for k, d in self._vertices.items()
                    if self._dag.contains_live(d)
                }
                self._vertices_changed()
            alive = sorted(
                r
                for (pk, r), digest in self._vertices.items()
                if pk == origin and self._dag.contains_live(digest)
            )
            if not alive:
                raise OutOfCertificates(origin)
            return alive[0], alive[-1]

    async def read_causal(self, start: Digest) -> list[Digest]:
        """Causal history of `start` over live vertices, in canonical
        order; bypassed (compressible) vertices are never reported. With
        the cuda backend, requests routed to the device coalesce into one
        reach_many launch per event-loop tick."""
        async with self._lock:
            out = self._route_locked(start)
        return await out if isinstance(out, asyncio.Future) else out

    def _route_locked(self, start: Digest):
        """Lock held: validate `start`, then either serve the host walk
        now (returns the list) or enqueue a device-coalesced request
        (returns the future to await AFTER releasing the lock). One lock
        scope covers lookup + routing so a concurrent remove() cannot
        interleave."""
        try:
            self._dag.get(start)  # unknown/dropped semantics as bft
        except (UnknownDigests, DroppedDigest) as e:
            raise ValidatorDagError(str(e)) from e
        if self._dev_eligible(start) is not None and self._pick_path() == "dev":
            fut = asyncio.get_running_loop().create_future()
            self._dev_queue.append((start, fut))
            if self._flush_task is None or self._flush_task.done():
                self._flush_task = asyncio.ensure_future(self._flush_dev())
            return fut
        return self._host_causal(start)

    def _host_causal(self, start: Digest) -> list[Digest]:
        """The host BFS, timed into the routing EWMA and the cost model's
        per-vertex coefficient (lock held)."""
        # CPU cost for the host/device routing model, not protocol time:
        # wall time is the semantically correct clock even under simnet.
        t0 = time.perf_counter()  # lint: allow(no-wall-clock-in-actors)
        try:
            certs = [v.cert for v in self._dag.bft(start)]
        except (UnknownDigests, DroppedDigest) as e:
            raise ValidatorDagError(str(e)) from e
        out = self._canonical(certs)
        dt = time.perf_counter() - t0  # lint: allow(no-wall-clock-in-actors)
        self._record("host", dt)
        pv = dt / max(1, len(certs))
        self._host_pv = (
            pv if self._host_pv is None else (1 - _ALPHA) * self._host_pv + _ALPHA * pv
        )
        return out

    async def _flush_dev(self) -> None:
        """Serve every queued device request in one fused dispatch. Runs a
        tick after the first enqueue so concurrent readers coalesce."""
        await asyncio.sleep(0)
        async with self._lock:
            batch, self._dev_queue = self._dev_queue, []
            if not batch:
                return
            eligible: list[tuple[Digest, tuple[Round, int]]] = []
            futs: list[asyncio.Future] = []
            for start, fut in batch:
                if fut.done():  # caller gone (cancelled/timeout)
                    continue
                # Re-validate between enqueue and flush: a remove() in the
                # gap may have tombstoned the start, and the device mask
                # would silently skip the non-live vertex (violating the
                # d[0] == start contract) where the host path raises.
                try:
                    self._dag.get(start)
                except (UnknownDigests, DroppedDigest) as e:
                    fut.set_exception(ValidatorDagError(str(e)))
                    continue
                pos = self._dev_eligible(start)
                if pos is None:
                    # Window slid (or coverage broke) between enqueue and
                    # flush: the host walk is authoritative.
                    try:
                        fut.set_result(self._host_causal(start))
                    except ValidatorDagError as e:
                        fut.set_exception(e)
                    continue
                eligible.append((start, pos))
                futs.append(fut)
            if not eligible:
                return
            kpad = _pow2_at_least(len(eligible))
            # Device-dispatch CPU cost for the routing model (see above).
            t0 = time.perf_counter()  # lint: allow(no-wall-clock-in-actors)
            try:
                results = self._device_causal_many(eligible)
            except Exception as err:  # a failed launch: every waiter sees it
                logger.exception("fused device read_causal failed")
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(err)
                return
            dt = time.perf_counter() - t0  # lint: allow(no-wall-clock-in-actors)
            self._last_batch = len(eligible)
            if self._metrics is not None:
                self._metrics.dag_read_coalesced_batch.set(len(eligible))
            if kpad in self._dev_warmed:
                # Per-request amortized cost is what competes with one host
                # BFS in the routing decision; the full dispatch wall time
                # feeds the cost model's amortization term.
                self._dev_dispatch = (
                    dt
                    if self._dev_dispatch is None
                    else (1 - _ALPHA) * self._dev_dispatch + _ALPHA * dt
                )
                for _ in eligible:
                    self._record("dev", dt / len(eligible))
            else:
                # First dispatch AT THIS padded batch size stays out of the
                # EWMA (see _dev_warmed). It still served requests, so it
                # counts in the routing stats.
                self._dev_warmed.add(kpad)
                self._routed["dev"] += len(eligible)
            for res, fut in zip(results, futs):
                if not fut.done():
                    fut.set_result(res)

    async def node_read_causal(self, origin: PublicKey, round: Round) -> list[Digest]:
        async with self._lock:
            digest = self._vertices.get((origin, round))
            if digest is None:
                raise NoCertificateForCoordinates(origin, round)
            # Same lock scope as the lookup: a concurrent remove() between
            # lookup and walk would otherwise turn just-resolved
            # coordinates into a spurious DroppedDigest error.
            out = self._route_locked(digest)
        return await out if isinstance(out, asyncio.Future) else out

    async def remove(self, digests: list[Digest]) -> None:
        """Mark certificates for compression and drop them from the
        coordinate index; unknown digests error, already-dropped are fine."""
        async with self._lock:
            unknown: list[Digest] = []
            removed: list[Digest] = []
            todrop = set(digests)
            for digest in todrop:
                try:
                    self._dag.make_compressible(digest)
                    removed.append(digest)
                except UnknownDigests:
                    unknown.append(digest)
                except DroppedDigest:
                    removed.append(digest)
            self._vertices = {
                k: v for k, v in self._vertices.items() if v not in todrop
            }
            self._vertices_changed()
            # A digest actually removed will never be inserted again: fail its
            # waiters now rather than leaving futures pending forever. Unknown
            # digests are NOT failed — they were not removed and may still be
            # inserted later by the feed.
            for digest in removed:
                for fut in self._obligations.pop(digest, []):
                    if not fut.done():
                        fut.set_exception(
                            ValidatorDagError(f"{digest!r} was removed")
                        )
            if unknown:
                raise ValidatorDagError(f"unknown digests {unknown!r}")

    async def notify_read(self, digest: Digest) -> Certificate:
        async with self._lock:
            try:
                return self._dag.get(digest).cert
            except DroppedDigest:
                raise ValidatorDagError(f"{digest!r} was dropped")
            except UnknownDigests:
                fut = asyncio.get_running_loop().create_future()
                self._obligations[digest].append(fut)
                # Prune cancelled waiters so the map cannot grow unboundedly
                # with digests that never arrive.
                fut.add_done_callback(lambda f, d=digest: self._prune_obligation(d, f))
        return await fut

    def _prune_obligation(self, digest: Digest, fut: asyncio.Future) -> None:
        waiters = self._obligations.get(digest)
        if waiters is None:
            return
        if fut in waiters:
            waiters.remove(fut)
        if not waiters:
            self._obligations.pop(digest, None)

    def size(self) -> int:
        return self._dag.size()

    async def shutdown(self) -> None:
        for task in (self._task, self._flush_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:  # lint: allow(no-silent-except)
                    pass  # the cancellation we just requested arriving back
        # Cancelling the flush task can strand queued device requests:
        # fail their futures so in-flight read_causal callers error out
        # instead of awaiting forever.
        pending, self._dev_queue = self._dev_queue, []
        for _, fut in pending:
            if not fut.done():
                fut.set_exception(ValidatorDagError("dag service shut down"))
