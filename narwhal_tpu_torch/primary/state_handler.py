"""The StateHandler: consensus feedback, GC triggering, reconfigure protocol.

Port copy of `narwhal_tpu/primary/state_handler.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/state_handler.rs:15-177 — receives
committed certificates from consensus, tracks the last committed round,
signals it on the consensus-round watch (the GC trigger for core and both
waiters), sends Cleanup to our own workers, and executes the
reconfigure/shutdown protocol by swapping the committee and fanning the
notification out to every actor's select loop plus our workers.
"""

from __future__ import annotations

import asyncio
import logging

from ..channels import Channel, Watch
from ..config import Committee, WorkerCache
from ..messages import CleanupMsg, ReconfigureMsg
from ..network import NetworkClient
from ..types import Certificate, PublicKey, ReconfigureNotification, Round

logger = logging.getLogger("narwhal.primary")


class StateHandler:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        worker_cache: WorkerCache,
        network: NetworkClient,
        rx_committed_certificates: Channel,  # from consensus (tx_primary)
        rx_state_handler: Channel,  # ReconfigureNotification from workers
        tx_consensus_round_updates: Watch,  # Round
        tx_reconfigure: Watch,  # ReconfigureNotification fan-out
        metrics=None,
    ):
        self.name = name
        self.committee = committee
        self.worker_cache = worker_cache
        self.network = network
        self.rx_committed_certificates = rx_committed_certificates
        self.rx_state_handler = rx_state_handler
        self.tx_consensus_round_updates = tx_consensus_round_updates
        self.tx_reconfigure = tx_reconfigure
        self.metrics = metrics

        self.last_committed_round: Round = 0
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    def _our_worker_addresses(self) -> list[str]:
        try:
            return [
                w.worker_address
                for w in self.worker_cache.our_workers(self.name).values()
            ]
        except KeyError:
            return []

    async def _handle_commit(self, certificate: Certificate) -> None:
        """(state_handler.rs:57-98): advance the committed round, trigger GC
        downstream and batch cleanup at our workers."""
        round = certificate.round
        if round <= self.last_committed_round:
            return
        self.last_committed_round = round
        self.tx_consensus_round_updates.send(round)
        await self.network.unreliable_broadcast(
            self._our_worker_addresses(), CleanupMsg(round)
        )

    async def _handle_reconfigure(self, note: ReconfigureNotification) -> None:
        """(state_handler.rs:100-172): swap the committee, notify every local
        actor via the watch, and forward to our workers."""
        if note.committee is not None:
            self.committee = note.committee
        self.tx_reconfigure.send(note)
        committee_json = note.committee.to_json() if note.committee is not None else ""
        msg = ReconfigureMsg(note.kind, committee_json)
        await self.network.unreliable_broadcast(self._our_worker_addresses(), msg)
        if note.kind == "shutdown":
            logger.info("State handler executing shutdown")

    async def run(self) -> None:
        commit_task = asyncio.ensure_future(self.rx_committed_certificates.recv())
        state_task = asyncio.ensure_future(self.rx_state_handler.recv())
        try:
            while True:
                done, _ = await asyncio.wait(
                    {commit_task, state_task}, return_when=asyncio.FIRST_COMPLETED
                )
                if commit_task in done:
                    certificate = commit_task.result()
                    commit_task = asyncio.ensure_future(
                        self.rx_committed_certificates.recv()
                    )
                    await self._handle_commit(certificate)
                if state_task in done:
                    note = state_task.result()
                    state_task = asyncio.ensure_future(self.rx_state_handler.recv())
                    await self._handle_reconfigure(note)
                    if note.kind == "shutdown":
                        return
        finally:
            commit_task.cancel()
            state_task.cancel()
