"""Public consensus API: the Validator / Proposer / Configuration services.

Port copy of `narwhal_tpu/primary/api_server.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/primary/src/grpc_server/{mod,validator,proposer,
configuration}.rs serving types/proto/narwhal.proto:127-152 over tonic on
`consensus_api_grpc_address`. Here the same surface is served over the
framework's typed RPC on its own listener:

- Validator.GetCollections  -> BlockWaiter (payload fetch via own workers)
- Validator.RemoveCollections -> BlockRemover (stores + workers + Dag)
- Validator.ReadCausal      -> Dag.read_causal
- Proposer.Rounds           -> Dag.rounds
- Proposer.NodeReadCausal   -> Dag.node_read_causal
- Configuration.NewEpoch    -> unimplemented (parity: configuration.rs:52-81)
- Configuration.NewNetworkInfo -> Committee.update_primary_network_info
- Configuration.GetPrimaryAddress
- Telemetry.Scrape          -> Registry.render (Prometheus text exposition)
- Telemetry.DumpFlightRecorder -> tracing.Tracer.dump (JSON)

The telemetry pair rides this typed listener so it is fabric-reachable
under simnet (grpc.aio binds real sockets and is skipped there).
"""

from __future__ import annotations

import json
import logging

from ..config import Committee
from ..messages import (
    FlightDumpMsg,
    FlightDumpResponse,
    GetCollectionsRequest,
    GetCollectionsResponse,
    GetPrimaryAddressRequest,
    GetPrimaryAddressResponse,
    NewEpochRequest,
    NewNetworkInfoRequest,
    NodeReadCausalRequest,
    ReadCausalRequest,
    ReadCausalResponse,
    RemoveCollectionsRequest,
    RoundsRequest,
    RoundsResponse,
    TelemetryScrapeMsg,
    TelemetryScrapeResponse,
)
from ..network import RpcServer
from ..types import PublicKey

logger = logging.getLogger("narwhal.primary.api")


class ConsensusApi:
    """Mounts the public API on its own RPC listener."""

    def __init__(
        self,
        name: PublicKey,
        committee,  # SharedCommittee-style holder with .load()/.swap() or Committee
        block_waiter,
        block_remover,
        dag=None,
        primary_address: str = "",
        max_concurrency: int = 100,
        registry=None,  # metrics.Registry: Telemetry.Scrape source
        tracer=None,  # tracing.Tracer: Telemetry.DumpFlightRecorder source
    ):
        self.name = name
        self._committee = committee
        self.block_waiter = block_waiter
        self.block_remover = block_remover
        self.dag = dag
        self.primary_address = primary_address
        self.registry = registry
        self.tracer = tracer
        self.server = RpcServer(max_concurrency)
        self.address: str = ""

    def _load_committee(self) -> Committee:
        load = getattr(self._committee, "load", None)
        return load() if load is not None else self._committee

    def set_primary_address(self, address: str) -> None:
        """Single write seam for the advertised primary address: the
        bound (possibly ephemeral) port only exists after Primary.spawn,
        so Node installs it here rather than poking the attribute."""
        self.primary_address = address

    async def spawn(self, address: str) -> str:
        host, port = address.rsplit(":", 1)
        bound = await self.server.start(host, int(port))
        self.address = f"{host}:{bound}"
        self.server.route(GetCollectionsRequest, self._on_get_collections)
        self.server.route(RemoveCollectionsRequest, self._on_remove_collections)
        self.server.route(ReadCausalRequest, self._on_read_causal)
        self.server.route(RoundsRequest, self._on_rounds)
        self.server.route(NodeReadCausalRequest, self._on_node_read_causal)
        self.server.route(NewEpochRequest, self._on_new_epoch)
        self.server.route(NewNetworkInfoRequest, self._on_new_network_info)
        self.server.route(GetPrimaryAddressRequest, self._on_get_primary_address)
        self.server.route(TelemetryScrapeMsg, self._on_scrape)
        self.server.route(FlightDumpMsg, self._on_flight_dump)
        logger.info("Consensus API listening on %s", self.address)
        return self.address

    async def shutdown(self) -> None:
        await self.server.stop()

    # -- Validator ---------------------------------------------------------

    async def _on_get_collections(self, msg: GetCollectionsRequest, peer: str):
        """(validator.rs GetCollections): batches or a per-digest error."""
        from .block_waiter import BlockError, BlockResponse

        results = []
        if not msg.digests:
            raise ValueError("Attempted fetch of no collections!")
        blocks = await self.block_waiter.get_blocks(list(msg.digests))
        for block in blocks:
            if isinstance(block, BlockResponse):
                results.append(
                    (
                        block.digest,
                        tuple(
                            (d, tuple(b.transactions)) for d, b in block.batches
                        ),
                        "",
                    )
                )
            else:
                results.append((block.digest, (), block.kind))
        return GetCollectionsResponse(tuple(results))

    async def _on_remove_collections(self, msg: RemoveCollectionsRequest, peer: str):
        if not msg.digests:
            raise ValueError("Attempted removal of no collections!")
        await self.block_remover.remove_blocks(list(msg.digests))
        return None  # Ack = Empty

    async def _on_read_causal(self, msg: ReadCausalRequest, peer: str):
        if self.dag is None:
            raise RuntimeError("ReadCausal needs the external consensus Dag")
        digests = await self.dag.read_causal(msg.digest)
        return ReadCausalResponse(tuple(digests))

    # -- Proposer ----------------------------------------------------------

    async def _on_rounds(self, msg: RoundsRequest, peer: str):
        if self.dag is None:
            raise RuntimeError("Rounds needs the external consensus Dag")
        committee = self._load_committee()
        if msg.public_key not in committee.authorities:
            raise ValueError("Invalid public key: unknown authority")
        oldest, newest = await self.dag.rounds(msg.public_key)
        return RoundsResponse(oldest, newest)

    async def _on_node_read_causal(self, msg: NodeReadCausalRequest, peer: str):
        if self.dag is None:
            raise RuntimeError("NodeReadCausal needs the external consensus Dag")
        digests = await self.dag.node_read_causal(msg.public_key, msg.round)
        return ReadCausalResponse(tuple(digests))

    # -- Configuration -----------------------------------------------------

    async def _on_new_epoch(self, msg: NewEpochRequest, peer: str):
        # Parity with the reference: parsed but not implemented
        # (configuration.rs:52-81).
        raise NotImplementedError(f"Not Implemented! epoch_number: {msg.epoch}")

    async def _on_new_network_info(self, msg: NewNetworkInfoRequest, peer: str):
        committee = self._load_committee()
        if msg.epoch != committee.epoch:
            raise ValueError(
                f"Passed in epoch {msg.epoch} does not match current epoch "
                f"{committee.epoch}"
            )
        info = {}
        for public_key, stake, address in msg.validators:
            if public_key not in committee.authorities:
                raise ValueError("Invalid public key: unknown authority")
            info[public_key] = (stake, address)
        committee.update_primary_network_info(info)
        return None

    async def _on_get_primary_address(self, msg: GetPrimaryAddressRequest, peer: str):
        return GetPrimaryAddressResponse(self.primary_address)

    # -- Telemetry ---------------------------------------------------------

    async def _on_scrape(self, msg: TelemetryScrapeMsg, peer: str):
        if self.registry is None:
            raise RuntimeError("Telemetry.Scrape: node mounted no registry")
        return TelemetryScrapeResponse(self.registry.render())

    async def _on_flight_dump(self, msg: FlightDumpMsg, peer: str):
        if self.tracer is None:
            raise RuntimeError(
                "Telemetry.DumpFlightRecorder: node mounted no tracer"
            )
        dump = self.tracer.dump(msg.max_events or None)
        return FlightDumpResponse(
            json.dumps(dump, sort_keys=True, separators=(",", ":")).encode()
        )
