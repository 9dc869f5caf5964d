"""Async pre-verification stage: pipeline signature checks off the Core.

Port copy of `narwhal_tpu/primary/verifier_stage.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

The reference verifies every header/vote/certificate inline in the Core's
single-threaded loop (core.rs sanitize_*, the crypto hot path named by the
north star). Here, when a crypto pool is configured, the RPC handlers hand
messages to this stage instead: structural checks run immediately, signature
items go to the AsyncVerifierPool (which coalesces across ALL concurrently
arriving messages into fixed-shape device batches), and only successfully
verified messages are forwarded to the Core wrapped in `PreVerified` so its
sanitize step skips redundant signature work. The Core state machine stays
single-threaded; only crypto becomes pipelined + batched. In the port the
pool of a card node is `gpu.verifier.VerifyService`: headers' and votes'
signatures go to its item lane (`verify_batch`), compact certificates'
proofs to its group lane (`msm_accumulate`).
"""

from __future__ import annotations

import asyncio
import collections
import logging

from ..channels import Channel
from ..config import Committee, WorkerCache
from ..types import Certificate, DagError, Header, InvalidEpoch, Vote

logger = logging.getLogger("narwhal.primary")


class PreVerified:
    """Marker carrying a message whose signatures have been checked."""

    __slots__ = ("inner",)

    def __init__(self, inner):
        self.inner = inner


class VerifierStage:
    def __init__(
        self,
        committee: Committee,
        worker_cache: WorkerCache,
        pool,  # AsyncVerifierPool-compatible: await pool.verify(pk, msg, sig)
        tx_out: Channel,
        rx_reconfigure=None,  # Watch[ReconfigureNotification]: epoch swaps
        max_pending: int = 1_024,
    ):
        self._committee = committee
        self.worker_cache = worker_cache
        self.pool = pool
        self.tx_out = tx_out
        self.rx_reconfigure = rx_reconfigure
        self._sem = asyncio.Semaphore(max_pending)
        self._tasks: set[asyncio.Task] = set()
        # Messages this stage dropped, by (message type, reason): "signature"
        # (a bad signature or aggregate proof), "malformed" (DagError) or
        # "backend" (the pool raised). The JAX package's stage only logs them.
        self.drops: collections.Counter = collections.Counter()

    @property
    def committee(self) -> Committee:
        """Latest committee: epoch changes land on the reconfigure watch, and
        a stage pinned to the boot committee would silently drop every
        new-epoch message."""
        if self.rx_reconfigure is not None:
            note = self.rx_reconfigure.value
            if note is not None and getattr(note, "committee", None) is not None:
                self._committee = note.committee
        return self._committee

    async def submit(self, msg) -> None:
        await self._sem.acquire()
        task = asyncio.ensure_future(self._verify(msg))
        self._tasks.add(task)

        def _done(t: asyncio.Task) -> None:
            self._tasks.discard(t)
            self._sem.release()

        task.add_done_callback(_done)

    async def _verify(self, msg) -> None:
        agg_group = None
        agg_committee = None
        try:
            if isinstance(msg, Header):
                msg.verify(self.committee, self.worker_cache, check_signature=False)
                items = [msg.signature_item()]
            elif isinstance(msg, Vote):
                msg.verify(self.committee, check_signature=False)
                items = [msg.signature_item()]
            elif isinstance(msg, Certificate) and msg.is_compact:
                # Half-aggregated proof: one aggregate check for the vote
                # quorum + the embedded header's own signature. The
                # content-keyed front cache short-circuits the transcript
                # rebuild (Fiat-Shamir weights + per-signer vote digests)
                # whenever any co-hosted node — or an earlier relay copy
                # arriving at this one — already decided this exact proof
                # under this committee. Structural checks always run, so
                # the InvalidEpoch/DagError semantics below are unchanged.
                agg_committee = self.committee
                verdict = msg.cached_aggregate_verdict(agg_committee)
                items = []
                if verdict is not None:
                    msg.structural_verify(agg_committee)
                    if not verdict:
                        self.drops[type(msg).__name__, "signature"] += 1
                        logger.debug(
                            "verifier stage dropped compact certificate with "
                            "known-bad aggregate proof"
                        )
                        return
                    if not msg.is_genesis():
                        msg.header.verify(
                            agg_committee, self.worker_cache, check_signature=False
                        )
                        items.append(msg.header.signature_item())
                else:
                    agg_group = msg.aggregate_group(agg_committee)
                    if agg_group is not None:
                        msg.header.verify(
                            agg_committee, self.worker_cache, check_signature=False
                        )
                        items.append(msg.header.signature_item())
            elif isinstance(msg, Certificate):
                items = msg.verify_items(self.committee)
                if items:
                    msg.header.verify(
                        self.committee, self.worker_cache, check_signature=False
                    )
                    items.append(msg.header.signature_item())
            else:
                await self.tx_out.send(msg)
                return
        except InvalidEpoch:
            # NOT this stage's call: the Core buffers exactly-one-epoch-ahead
            # messages for replay after its reconfigure notification lands
            # (the epoch-change deadlock fix) and logs the stale drops.
            # Forward RAW (un-preverified): the Core re-runs the full
            # sanitize path — including signatures, against whatever
            # committee it holds when the message is finally handled.
            await self.tx_out.send(msg)
            return
        except DagError as e:
            self.drops[type(msg).__name__, "malformed"] += 1
            logger.debug("verifier stage dropped malformed message: %s", e)
            return
        if items or agg_group is not None:
            try:
                awaitables = [self.pool.verify(pk, m, sig) for pk, m, sig in items]
                if agg_group is not None:
                    awaitables.append(self.pool.verify_aggregate(*agg_group))
                results = await asyncio.gather(*awaitables)
            except Exception:
                self.drops[type(msg).__name__, "backend"] += 1
                # Backend dispatch failure with the host fallback disabled
                # (cofactored committees: a strict-rule fallback would be a
                # consensus-split hazard). Drop the message — conservative
                # rejection affects liveness, never safety — and say so.
                logger.exception(
                    "verify backend failed; dropping %s (no host fallback "
                    "under this committee's accept rule)",
                    type(msg).__name__,
                )
                return
            if agg_group is not None:
                # Publish the paid-for MSM verdict under the front key so
                # every later copy of this certificate — same node's relay
                # duplicates or a co-hosted peer's — skips the transcript.
                msg.record_aggregate_verdict(agg_committee, bool(results[-1]))
            if not all(results):
                self.drops[type(msg).__name__, "signature"] += 1
                logger.warning(
                    "verifier stage rejected %s with bad signature",
                    type(msg).__name__,
                )
                return
        await self.tx_out.send(PreVerified(msg))

    def shutdown(self) -> None:
        for t in list(self._tasks):
            t.cancel()
