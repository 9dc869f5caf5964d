"""The port's public edges against the JAX package's: `proto/`, `grpc_api`
and the typed consensus API on a live cluster.

- The scenarios of `tests/test_api.py` and `tests/test_grpc_api.py` run
  against the port's `Cluster` (each module's source with the package
  renamed).
- The port's `narwhal_pb2` is a byte-for-byte copy: both packages register
  one `narwhal.proto` in protobuf's default pool.
- A client built on the JAX package's `narwhal_pb2` gets the same answers,
  byte for byte and status for status, from a port `GrpcPublicApi` as from
  a JAX one, both over one seeded certificate stream (and from a port API
  over `Dag(backend="cuda", device="cpu")`); the workers' gRPC
  `Transactions` ingest of both packages feeds their batch makers alike.
"""

import asyncio
import re
from pathlib import Path

import grpc
import pytest

import narwhal_tpu.grpc_api as j_grpc
import narwhal_tpu.proto.narwhal_pb2 as j_pb
import narwhal_tpu_torch.grpc_api as t_grpc
import narwhal_tpu_torch.proto.narwhal_pb2 as t_pb
from chip_smoke import grpc_call
from test_torch_block_services import PKGS, mock_worker, seeded_dag
from test_torch_network import host_backends, port_scenarios  # noqa: F401 (a fixture)

# The renamed scenarios name no backend: the JAX node's host defaults.
pytestmark = pytest.mark.usefixtures("host_backends")

TESTS = Path(__file__).resolve().parent
FILES = ("test_api.py", "test_grpc_api.py")

_SCENARIOS = {}
for _file in FILES:
    for _name, _fn in port_scenarios(_file).items():
        assert _name not in _SCENARIOS and _name not in globals(), _name
        _SCENARIOS[_name] = _fn
globals().update(_SCENARIOS)

GRPC = {"port": t_grpc, "jax": j_grpc}


def test_all_reference_api_scenarios_collected():
    ref = set()
    for file in FILES:
        ref |= set(re.findall(r"^def (test_\w+)", (TESTS / file).read_text(), re.M))
    assert set(_SCENARIOS) == ref and len(ref) == 6


def test_proto_bytes_equal_and_share_the_default_pool():
    assert (TESTS.parent / "narwhal_tpu_torch/proto/narwhal.proto").read_bytes() == (
        TESTS.parent / "narwhal_tpu/proto/narwhal.proto").read_bytes()
    assert t_pb.DESCRIPTOR.serialized_pb == j_pb.DESCRIPTOR.serialized_pb
    assert t_pb.DESCRIPTOR.name == j_pb.DESCRIPTOR.name == "narwhal.proto"
    names = sorted(t_pb.DESCRIPTOR.message_types_by_name)
    assert names == sorted(j_pb.DESCRIPTOR.message_types_by_name) and len(names) == 16
    assert sorted(t_pb.DESCRIPTOR.services_by_name) == [
        "Configuration", "Proposer", "Transactions", "Validator"]
    msg = t_pb.GetCollectionsResponse()
    item = msg.results.add(collection_id=b"\x01" * 32)
    item.batches.add(digest=b"\x02" * 32, transactions=[b"tx"])
    assert j_pb.GetCollectionsResponse.FromString(msg.SerializeToString()) == msg


class _Waiter:
    """A block waiter answering from a fixed map with package `m`'s own
    BlockResponse / BlockError (the gRPC layer checks their classes)."""

    def __init__(self, m, certs, batches):
        self.m, self.by_digest = m, {c.digest: c for c in certs}
        self.batches = batches

    async def get_blocks(self, digests):
        out = []
        for d in digests:
            c = self.by_digest.get(d)
            if c is None:
                out.append(self.m.waiter.BlockError(d, "BlockNotFound"))
            else:
                out.append(self.m.waiter.BlockResponse(
                    d, [(b, self.batches[b]) for b in sorted(c.header.payload)]))
        return out


async def grpc_answers(m, grpc_mod, dag_backend: str = "cpu") -> list:
    """Every Validator / Proposer / Configuration / Telemetry method of
    package `m`'s GrpcPublicApi over a Dag fed a seeded stream, asked by a
    client built on the JAX package's `narwhal_pb2`: each reply's bytes, or
    its status code and details."""
    f, certs, batches = seeded_dag(m, 6, seed=5)
    kw = {"device": "cpu"} if dag_backend == "cuda" else {}
    dag = m.dag.Dag(f.committee, backend=dag_backend, **kw)
    for c in certs:
        await dag.insert(c)
    storage = m.stores.NodeStorage(None)
    worker = await mock_worker(m, f, batches)
    network = m.network.NetworkClient()
    remover = m.remover.BlockRemover(f.authorities[0].public, f.worker_cache,
                                     storage.certificate_store, storage.header_store,
                                     storage.payload_store, network, dag=dag)
    registry = m.metrics.Registry()
    registry.counter("node_things_total", "Things").inc(3)
    api = grpc_mod.GrpcPublicApi(f.authorities[0].public, f.committee,
                                 _Waiter(m, certs, batches), remover, dag=dag,
                                 registry=registry)
    api.set_primary_address("127.0.0.1:4242")
    await api.spawn("127.0.0.1:0")
    pb = j_pb
    keys = [a.public for a in f.authorities]
    full = [c for c in certs if c.header.payload]
    unknown = b"\x5a" * 32
    validators = [pb.ValidatorData(public_key=k, stake_weight=1,
                                   primary_address=f"127.0.0.1:{7000 + i}")
                  for i, k in enumerate(keys)]
    calls = (
        [("Proposer", "Rounds", pb.RoundsResponse, pb.RoundsRequest(public_key=k))
         for k in keys + [b"\x01" * 32]]
        + [("Proposer", "NodeReadCausal", pb.NodeReadCausalResponse,
            pb.NodeReadCausalRequest(public_key=keys[i], round=r))
           for i, r in ((0, 6), (1, 5), (2, 1), (3, 9))]
        + [("Validator", "ReadCausal", pb.ReadCausalResponse,
            pb.ReadCausalRequest(collection_id=d))
           for d in [c.digest for c in certs[-4:] + full[:2]] + [unknown]]
        + [("Validator", "GetCollections", pb.GetCollectionsResponse,
            pb.CollectionRequest(collection_ids=ids))
           for ids in ([c.digest for c in full[:3]], [unknown], [])]
        + [("Validator", "RemoveCollections", pb.Empty,
            pb.CollectionRequest(collection_ids=[c.digest for c in full[:2]])),
           ("Validator", "ReadCausal", pb.ReadCausalResponse,
            pb.ReadCausalRequest(collection_id=full[0].digest)),
           ("Configuration", "GetPrimaryAddress", pb.GetPrimaryAddressResponse, pb.Empty()),
           ("Configuration", "NewEpoch", pb.Empty, pb.NewEpochRequest(epoch_number=1)),
           ("Configuration", "NewNetworkInfo", pb.Empty,
            pb.NewNetworkInfoRequest(epoch_number=f.committee.epoch, validators=validators)),
           ("Configuration", "NewNetworkInfo", pb.Empty,
            pb.NewNetworkInfoRequest(epoch_number=f.committee.epoch + 1))]
    )
    out = []
    channel = grpc.aio.insecure_channel(api.address)
    try:
        for service, method, reply_cls, request in calls:
            try:
                reply = await grpc_call(channel, service, method, reply_cls)(request, timeout=30.0)
                out.append(("ok", reply.SerializeToString()))
            except grpc.aio.AioRpcError as e:
                out.append((e.code().name, e.details()))
        scrape = channel.unary_unary("/narwhal.Telemetry/Scrape")
        out.append(("scrape", await scrape(b"", timeout=30.0)))
    finally:
        await channel.close()
        network.close()
        await api.shutdown()
        await worker.stop()
    return out


def test_jax_client_gets_the_same_grpc_answers(run):
    got = {name: run(grpc_answers(m, GRPC[name]), timeout=120.0) for name, m in PKGS.items()}
    got["port_cuda"] = run(grpc_answers(PKGS["port"], t_grpc, "cuda"), timeout=120.0)
    assert got["port"] == got["jax"]
    assert got["port_cuda"] == got["jax"]
    codes = [k for k, _ in got["port"]]
    assert codes.count("ok") >= 15
    assert {"NOT_FOUND", "UNIMPLEMENTED", "INVALID_ARGUMENT"} <= set(codes)
    assert b"node_things_total 3" in got["port"][-1][1]


async def ingest(m, grpc_mod) -> list:
    """Package `m`'s worker-side gRPC Transactions service in front of a
    channel standing for the batch maker: what a JAX-pb client's unary and
    streamed submissions put on it."""
    tx = m.channels.Channel(100)
    svc = grpc_mod.GrpcTransactions(tx)
    addr = await svc.spawn("127.0.0.1:0")
    chan = grpc.aio.insecure_channel(addr)
    try:
        await grpc_call(chan, "Transactions", "SubmitTransaction", j_pb.Empty)(
            j_pb.Transaction(transaction=b"\x09" * 40), timeout=30.0)
        stream = chan.stream_unary(
            "/narwhal.Transactions/SubmitTransactionStream",
            request_serializer=lambda msg: msg.SerializeToString(),
            response_deserializer=j_pb.Empty.FromString)
        await stream(iter(j_pb.Transaction(transaction=bytes([i]) * (i + 1)) for i in range(5)),
                     timeout=30.0)
    finally:
        await chan.close()
        await svc.shutdown()
    return [tx.try_recv() for _ in range(tx.qsize())]


def test_worker_grpc_ingest_matches_jax(run):
    got = {name: run(ingest(m, GRPC[name])) for name, m in PKGS.items()}
    assert got["port"] == got["jax"] and len(got["port"]) == 6
    assert got["port"][0] == (1, (40).to_bytes(4, "little") + b"\x09" * 40)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_grpc_servers_stop_with_their_cluster(run, pkg):
    """Every cluster teardown stops its GrpcPublicApi and GrpcTransactions
    servers: their ports refuse connections after `shutdown`."""
    from narwhal_tpu.cluster import Cluster as JCluster
    from narwhal_tpu_torch.cluster import Cluster as TCluster

    async def scenario():
        cluster = (TCluster if pkg == "port" else JCluster)(size=4, workers=1)
        await cluster.start()
        addrs = [a.primary.grpc_api_address for a in cluster.authorities] + [
            a.workers[0].worker.grpc_transactions_address for a in cluster.authorities]
        assert all(addrs)
        await cluster.shutdown()
        refused = 0
        for addr in addrs:
            host, port = addr.rsplit(":", 1)
            try:
                _, w = await asyncio.open_connection(host, int(port))
                w.close()
            except OSError:
                refused += 1
        return refused, len(addrs)

    refused, total = run(scenario(), timeout=60.0)
    assert refused == total == 8
