"""Demo of the external-consensus public API, against the PyTorch port.

Port copy of the repo's `examples/demo_client.py`, which mirrors the
reference implementation's `examples/src/demo_client.rs`: boot (or point
at) a committee running with external consensus, submit transactions, then
walk the API: Rounds -> NodeReadCausal -> GetCollections ->
RemoveCollections. `demo()` is the JAX package's, with the package renamed.

Run standalone (boots an in-process 4-node cluster on the port `Cluster`'s
defaults: the card's `cuda` crypto and DAG backends; raises without a card):
    python -m narwhal_tpu_torch.examples.demo_client
Or against a running node (a port or a JAX one: the wire is the same):
    python -m narwhal_tpu_torch.examples.demo_client --api HOST:PORT --key HEX --tx HOST:PORT
"""

from __future__ import annotations

import argparse
import asyncio

from narwhal_tpu_torch.messages import (
    GetCollectionsRequest,
    NodeReadCausalRequest,
    RemoveCollectionsRequest,
    RoundsRequest,
    SubmitTransactionStreamMsg,
)
from narwhal_tpu_torch.network import NetworkClient, RpcError


async def demo(api: str, public_key: bytes, tx_address: str | None) -> None:
    client = NetworkClient()
    try:
        if tx_address:
            txs = tuple(b"\x01" + i.to_bytes(8, "big") + b"\x00" * 23 for i in range(64))
            await client.request(tx_address, SubmitTransactionStreamMsg(txs))
            print(f"submitted {len(txs)} transactions to {tx_address}")

        rounds = None
        for _ in range(150):
            try:
                rounds = await client.request(api, RoundsRequest(public_key))
                if rounds.newest_round >= 2:
                    break
            except RpcError:
                pass
            await asyncio.sleep(0.2)
        assert rounds is not None, "API never answered Rounds"
        print(f"Rounds: oldest={rounds.oldest_round} newest={rounds.newest_round}")

        nrc = await client.request(
            api, NodeReadCausalRequest(public_key, rounds.newest_round)
        )
        print(f"NodeReadCausal({rounds.newest_round}): {len(nrc.digests)} collections")

        got = await client.request(api, GetCollectionsRequest(nrc.digests))
        n_batches = sum(len(b) for _, b, _ in got.results)
        n_txs = sum(len(t) for _, b, _ in got.results for _, t in b)
        print(f"GetCollections: {len(got.results)} collections, "
              f"{n_batches} batches, {n_txs} transactions")

        await client.request(
            api, RemoveCollectionsRequest(tuple(d for d, _, _ in got.results))
        )
        print(f"RemoveCollections: removed {len(got.results)} collections")
    finally:
        client.close()


async def standalone() -> None:
    """The standalone flow: a 4-node in-process committee with external
    consensus on the port `Cluster`'s defaults (the card), walked by
    `demo()` at authority 0, then shut down."""
    from narwhal_tpu_torch.cluster import Cluster

    cluster = Cluster(size=4, workers=1, internal_consensus=False)
    await cluster.start()
    try:
        node = cluster.authorities[0]
        await demo(
            node.primary.api_address,
            node.name,
            node.worker_transactions_address(0),
        )
    finally:
        await cluster.shutdown()


async def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--api", help="consensus API address host:port")
    parser.add_argument("--key", help="authority public key (hex)")
    parser.add_argument("--tx", help="worker transactions address host:port")
    args = parser.parse_args()

    if args.api:
        await demo(args.api, bytes.fromhex(args.key), args.tx)
        return
    await standalone()


if __name__ == "__main__":
    asyncio.run(main())
