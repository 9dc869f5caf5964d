"""gRPC public plane: Validator / Proposer / Configuration on the primary and
Transactions on the worker.

Port copy of `narwhal_tpu/grpc_api.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`;
its `proto/` is a byte-for-byte copy of the JAX package's, so both register
the same `narwhal.proto` in protobuf's default pool and load side by side.

Reference: the reference's client-facing edges are tonic gRPC against
types/proto/narwhal.proto:127-160 (built in types/build.rs:42-121, mounted at
primary/src/grpc_server/mod.rs:25-106 and worker/src/worker.rs:369-423) — any
language can submit transactions or drive external consensus. This module
serves the same services from `narwhal_tpu_torch/proto/narwhal.proto` using
grpc.aio with hand-rolled method handlers (no grpc_tools codegen needed; the
message classes come from protoc --python_out).

The internal typed-RPC surface (api_server.ConsensusApi, the worker's
tx_server) remains the high-throughput path; gRPC is the interoperable edge,
exactly as anemo (internal) vs tonic (public) split in the reference.
"""

from __future__ import annotations

import logging

import grpc

from .consensus.dag import ValidatorDagError
from .proto import narwhal_pb2 as pb

logger = logging.getLogger("narwhal.grpc")

_PKG = "narwhal"


def _unary(handler, request_cls):
    async def call(request_bytes, context):
        request = request_cls.FromString(request_bytes)
        reply = await handler(request, context)
        return reply.SerializeToString()

    return grpc.unary_unary_rpc_method_handler(
        call, request_deserializer=None, response_serializer=None
    )


def _raw_unary(handler):
    """Unary method whose request/response are raw bytes end to end — the
    telemetry plane's scrape text and flight-recorder JSON need no protoc
    message types, matching the raw-bytes generic-handler idiom above."""

    async def call(request_bytes, context):
        return await handler(request_bytes, context)

    return grpc.unary_unary_rpc_method_handler(
        call, request_deserializer=None, response_serializer=None
    )


def _stream_in(handler, request_cls):
    async def call(request_iter, context):
        async def typed():
            async for raw in request_iter:
                yield request_cls.FromString(raw)

        reply = await handler(typed(), context)
        return reply.SerializeToString()

    return grpc.stream_unary_rpc_method_handler(
        call, request_deserializer=None, response_serializer=None
    )


class _Service:
    """One gRPC service assembled from (method name -> handler) pairs."""

    def __init__(self, name: str, methods: dict):
        self.name = f"{_PKG}.{name}"
        self.methods = methods

    def generic_handler(self) -> grpc.GenericRpcHandler:
        return grpc.method_handlers_generic_handler(self.name, self.methods)


class GrpcPublicApi:
    """The primary's public consensus API over gRPC, backed by the same
    seams as the typed-RPC ConsensusApi: BlockWaiter (collection fetch),
    BlockRemover (deletion fan-out), the external Dag (causal reads), and
    the committee (configuration)."""

    def __init__(
        self,
        name,
        committee,
        block_waiter,
        block_remover,
        dag=None,
        primary_address: str = "",
        registry=None,  # metrics.Registry: Telemetry.Scrape source
        tracer=None,  # tracing.Tracer: Telemetry.DumpFlightRecorder source
    ):
        self.name = name
        self.committee = committee
        self.block_waiter = block_waiter
        self.block_remover = block_remover
        self.dag = dag
        self.primary_address = primary_address
        self.registry = registry
        self.tracer = tracer
        self._server: grpc.aio.Server | None = None
        self.address: str = ""

    def set_primary_address(self, address: str) -> None:
        """Single write seam for the advertised primary address: the
        bound (possibly ephemeral) port only exists after Primary.spawn,
        so Node installs it here rather than poking the attribute."""
        self.primary_address = address

    # -- Validator ---------------------------------------------------------
    async def _get_collections(self, request, context):
        from .primary.block_waiter import BlockError, BlockResponse

        results = await self.block_waiter.get_blocks(list(request.collection_ids))
        out = pb.GetCollectionsResponse()
        for digest, res in zip(request.collection_ids, results):
            item = out.results.add(collection_id=digest)
            if isinstance(res, BlockResponse):
                for batch_digest, batch in res.batches:
                    item.batches.add(
                        digest=batch_digest, transactions=list(batch.transactions)
                    )
            elif isinstance(res, BlockError):
                item.error = res.kind
            else:
                item.error = "BatchError"
        return out

    async def _remove_collections(self, request, context):
        from .primary.block_remover import BlockRemoverError

        try:
            await self.block_remover.remove_blocks(list(request.collection_ids))
        except BlockRemoverError as e:
            await context.abort(grpc.StatusCode.INTERNAL, f"remove failed: {e.kind}")
        return pb.Empty()

    async def _read_causal(self, request, context):
        if self.dag is None:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "ReadCausal requires external consensus (the Dag service)",
            )
        try:
            digests = await self.dag.read_causal(request.collection_id)
        except ValidatorDagError as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except Exception as e:
            # A dag-internal failure (device dispatch, shutdown race) is not
            # the caller naming an unknown digest: surface it as INTERNAL so
            # clients retry elsewhere instead of treating data as absent.
            logger.exception("ReadCausal failed")
            await context.abort(grpc.StatusCode.INTERNAL, str(e))
        return pb.ReadCausalResponse(collection_ids=list(digests))

    # -- Proposer ----------------------------------------------------------
    async def _rounds(self, request, context):
        if self.dag is None:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "Rounds requires external consensus (the Dag service)",
            )
        try:
            oldest, newest = await self.dag.rounds(bytes(request.public_key))
        except ValidatorDagError as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except Exception as e:
            logger.exception("Rounds failed")
            await context.abort(grpc.StatusCode.INTERNAL, str(e))
        return pb.RoundsResponse(oldest_round=oldest, newest_round=newest)

    async def _node_read_causal(self, request, context):
        if self.dag is None:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "NodeReadCausal requires external consensus (the Dag service)",
            )
        try:
            digests = await self.dag.node_read_causal(
                bytes(request.public_key), request.round
            )
        except ValidatorDagError as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except Exception as e:
            logger.exception("NodeReadCausal failed")
            await context.abort(grpc.StatusCode.INTERNAL, str(e))
        return pb.NodeReadCausalResponse(collection_ids=list(digests))

    # -- Configuration -----------------------------------------------------
    async def _new_epoch(self, request, context):
        # Reference parity: Configuration::new_epoch is unimplemented
        # (primary/src/grpc_server/configuration.rs:78-81).
        await context.abort(grpc.StatusCode.UNIMPLEMENTED, "Not Implemented!")

    async def _new_network_info(self, request, context):
        if request.epoch_number != self.committee.epoch:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"epoch {request.epoch_number} != current {self.committee.epoch}",
            )
        updates = {
            bytes(v.public_key): (v.stake_weight, v.primary_address)
            for v in request.validators
        }
        try:
            self.committee.update_primary_network_info(updates)
        except Exception as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.Empty()

    async def _get_primary_address(self, request, context):
        return pb.GetPrimaryAddressResponse(primary_address=self.primary_address)

    # -- Telemetry ---------------------------------------------------------
    async def _scrape(self, request_bytes, context):
        if self.registry is None:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "Telemetry.Scrape: node mounted no registry",
            )
        return self.registry.render().encode()

    async def _dump_flight(self, request_bytes, context):
        import json

        if self.tracer is None:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "Telemetry.DumpFlightRecorder: node mounted no tracer",
            )
        # Request body: optional 4-byte little-endian max_events cap.
        max_events = None
        if len(request_bytes) >= 4:
            cap = int.from_bytes(request_bytes[:4], "little")
            max_events = cap or None
        dump = self.tracer.dump(max_events)
        return json.dumps(dump, sort_keys=True, separators=(",", ":")).encode()

    # -- lifecycle ---------------------------------------------------------
    def _services(self) -> list[_Service]:
        return [
            _Service(
                "Validator",
                {
                    "GetCollections": _unary(
                        self._get_collections, pb.CollectionRequest
                    ),
                    "RemoveCollections": _unary(
                        self._remove_collections, pb.CollectionRequest
                    ),
                    "ReadCausal": _unary(self._read_causal, pb.ReadCausalRequest),
                },
            ),
            _Service(
                "Proposer",
                {
                    "Rounds": _unary(self._rounds, pb.RoundsRequest),
                    "NodeReadCausal": _unary(
                        self._node_read_causal, pb.NodeReadCausalRequest
                    ),
                },
            ),
            _Service(
                "Configuration",
                {
                    "NewEpoch": _unary(self._new_epoch, pb.NewEpochRequest),
                    "NewNetworkInfo": _unary(
                        self._new_network_info, pb.NewNetworkInfoRequest
                    ),
                    "GetPrimaryAddress": _unary(self._get_primary_address, pb.Empty),
                },
            ),
            _Service(
                "Telemetry",
                {
                    "Scrape": _raw_unary(self._scrape),
                    "DumpFlightRecorder": _raw_unary(self._dump_flight),
                },
            ),
        ]

    async def spawn(self, address: str) -> str:
        server = grpc.aio.server()
        for svc in self._services():
            server.add_generic_rpc_handlers((svc.generic_handler(),))
        port = server.add_insecure_port(address)
        await server.start()
        host = address.rsplit(":", 1)[0]
        self.address = f"{host}:{port}"
        self._server = server
        logger.info("gRPC public API listening on %s", self.address)
        return self.address

    async def shutdown(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=0.5)
            self._server = None


class GrpcTransactions:
    """Worker-side client transaction ingest over gRPC
    (Transactions.SubmitTransaction / SubmitTransactionStream), feeding the
    same batch-maker channel as the typed tx_server — and gated by the same
    admission control: overload aborts with StatusCode.RESOURCE_EXHAUSTED
    instead of queueing unboundedly."""

    def __init__(self, tx_batch_maker, metrics=None, gate=None):
        self.tx_batch_maker = tx_batch_maker
        self.metrics = metrics
        self.gate = gate  # pacing.IngestGate, shared with the typed ingest
        self._server: grpc.aio.Server | None = None
        self.address: str = ""

    async def _admit(self, context) -> None:
        if self.gate is None:
            return
        from .pacing import IngestOverloadError

        try:
            await self.gate.admit()
        except IngestOverloadError as e:
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))

    async def _submit(self, request, context):
        await self._admit(context)
        tx = request.transaction
        frame = len(tx).to_bytes(4, "little") + tx
        if self.metrics is not None:
            self.metrics.tx_received.inc()
        await self.tx_batch_maker.send((1, frame))
        return pb.Empty()

    async def _submit_stream(self, request_iter, context):
        async for request in request_iter:
            await self._submit(request, context)
        return pb.Empty()

    async def spawn(self, address: str) -> str:
        server = grpc.aio.server()
        server.add_generic_rpc_handlers(
            (
                _Service(
                    "Transactions",
                    {
                        "SubmitTransaction": _unary(self._submit, pb.Transaction),
                        "SubmitTransactionStream": _stream_in(
                            self._submit_stream, pb.Transaction
                        ),
                    },
                ).generic_handler(),
            )
        )
        port = server.add_insecure_port(address)
        await server.start()
        host = address.rsplit(":", 1)[0]
        self.address = f"{host}:{port}"
        self._server = server
        logger.info("gRPC Transactions listening on %s", self.address)
        return self.address

    async def shutdown(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=0.5)
            self._server = None
