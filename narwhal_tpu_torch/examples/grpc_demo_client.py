"""Demo of the external-consensus public API over gRPC, against the PyTorch
port: the interoperable edge any language's generated stubs can drive.

Port copy of the repo's `examples/grpc_demo_client.py`, which mirrors the
reference implementation's `examples/src/demo_client.rs` against
`narwhal_tpu_torch/proto/narwhal.proto`: submit transactions
(Transactions), then walk Rounds -> NodeReadCausal -> GetCollections ->
RemoveCollections. `demo()` is the JAX package's, with the package renamed.

Run standalone (boots an in-process 4-node cluster on the port `Cluster`'s
defaults: the card's `cuda` crypto and DAG backends; raises without a card):
    python -m narwhal_tpu_torch.examples.grpc_demo_client
Or against a running node (a port or a JAX one: the wire is the same):
    python -m narwhal_tpu_torch.examples.grpc_demo_client --api HOST:PORT --key HEX --tx HOST:PORT
"""

from __future__ import annotations

import argparse
import asyncio

import grpc

from narwhal_tpu_torch.proto import narwhal_pb2 as pb


def _unary(channel, service, method, reply_cls):
    return channel.unary_unary(
        f"/narwhal.{service}/{method}",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=reply_cls.FromString,
    )


async def demo(api: str, public_key: bytes, tx_address: str | None) -> None:
    channels = []
    try:
        if tx_address:
            tx_chan = grpc.aio.insecure_channel(tx_address)
            channels.append(tx_chan)
            stream = tx_chan.stream_unary(
                "/narwhal.Transactions/SubmitTransactionStream",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb.Empty.FromString,
            )
            n = 64
            await stream(
                iter(
                    pb.Transaction(
                        transaction=b"\x01" + i.to_bytes(8, "big") + b"\x00" * 23
                    )
                    for i in range(n)
                )
            )
            print(f"submitted {n} transactions to {tx_address} (gRPC stream)")

        chan = grpc.aio.insecure_channel(api)
        channels.append(chan)
        rounds_call = _unary(chan, "Proposer", "Rounds", pb.RoundsResponse)
        rounds = None
        for _ in range(150):
            try:
                rounds = await rounds_call(pb.RoundsRequest(public_key=public_key))
                if rounds.newest_round >= 2:
                    break
            except grpc.aio.AioRpcError:
                pass
            await asyncio.sleep(0.2)
        assert rounds is not None, "API never answered Rounds"
        print(f"Rounds: oldest={rounds.oldest_round} newest={rounds.newest_round}")

        nrc = _unary(chan, "Proposer", "NodeReadCausal", pb.NodeReadCausalResponse)
        causal = await nrc(
            pb.NodeReadCausalRequest(public_key=public_key, round=rounds.newest_round)
        )
        ids = list(causal.collection_ids)
        print(f"NodeReadCausal(round={rounds.newest_round}): {len(ids)} collections")

        gc = _unary(chan, "Validator", "GetCollections", pb.GetCollectionsResponse)
        got = await gc(pb.CollectionRequest(collection_ids=ids[:4]))
        batches = sum(len(r.batches) for r in got.results)
        txs = sum(
            len(b.transactions) for r in got.results for b in r.batches
        )
        print(f"GetCollections: {len(got.results)} collections, {batches} batches, {txs} txs")

        rm = _unary(chan, "Validator", "RemoveCollections", pb.Empty)
        await rm(pb.CollectionRequest(collection_ids=ids[:4]))
        print(f"RemoveCollections: removed {len(ids[:4])} collections")
    finally:
        for c in channels:
            await c.close()


async def standalone() -> None:
    """The standalone flow: a 4-node in-process committee with external
    consensus on the port `Cluster`'s defaults (the card), walked over gRPC
    by `demo()` at authority 0, then shut down."""
    from narwhal_tpu_torch.cluster import Cluster

    cluster = Cluster(size=4, workers=1, internal_consensus=False)
    await cluster.start()
    try:
        worker = cluster.authorities[0].workers[0].worker
        await demo(
            cluster.authorities[0].primary.grpc_api_address,
            cluster.authorities[0].name,
            worker.grpc_transactions_address,
        )
    finally:
        await cluster.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--api", default=None, help="primary gRPC API host:port")
    ap.add_argument("--key", default=None, help="authority public key (hex)")
    ap.add_argument("--tx", default=None, help="worker gRPC Transactions host:port")
    args = ap.parse_args()
    if args.api:
        asyncio.run(demo(args.api, bytes.fromhex(args.key), args.tx))
    else:
        asyncio.run(standalone())


if __name__ == "__main__":
    main()
