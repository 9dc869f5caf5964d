"""SimCluster — a whole committee on the simnet fabric.

Port copy of `narwhal_tpu/simnet/cluster.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Same assembly as `narwhal_tpu_torch.cluster.Cluster` (real PrimaryNode/WorkerNode
actors, real stores, real frames), with three substitutions:

* **addresses are synthetic** (`nodeI:port` strings owned by the fabric) —
  no `get_available_port` probing, no placeholder sockets, no fds. The
  fabric learns which node owns which address at assignment time, which is
  what partitions and crash isolation key on;
* **every node's tasks carry its identity**: `start_node` sets the
  `CURRENT_NODE` context variable around construction + spawn, so every
  task an actor ever spawns — including lazy reconnects rounds later —
  attributes its connections to the right node;
* **commits are recorded**: the per-node Consensus commit tap appends
  `(epoch, round, certificate digest)` to `commits[i]` and mirrors a
  compact entry into the fabric's event log, giving the safety/liveness
  oracles the exact committed sequence without an extra channel.

`crash_node` / `restart_node` model fail-stop: the fabric isolates the node
first (connections reset, connects refused — no goodbye messages escape),
then the node object is torn down; restart builds a fresh node with a fresh
in-memory store, exercising the catch-up path.

The card under the virtual clock (the port's own part): with
`crypto_backend="cuda"` no node builds the process-wide `VerifyService`,
which seals on a wall-clock deadline on a thread of its own and resolves
its futures through `call_soon_threadsafe`, so the virtual clock would run
on through the simulated committee's timers while the card works (and,
with no timer pending, end the run in `SimDeadlockError`). Instead
`_crypto_pool` gives each node an `AsyncVerifierPool` over ONE
`GpuVerifier` a cluster, in the mode the committee's `verify_rule` names,
its buckets powers of two up to 2048 rows. A simulated node's flushes are
a few rows each, so under the cofactored rule the msm lane (A2 and its
host epilogue, a few ms of Python a flush) takes only buckets of 32 rows
or more, and a smaller flush takes A1's cofactored verdict.
The pool dispatches through `loop.run_in_executor`, which `SimLoop` runs
inline, so every launch and readback happens on the loop's thread and a
verdict arrives at a virtual time the seed fixes. `dag_backend="cuda"`
needs nothing of the kind: `GpuBullshark` / `GpuTusk` already await their
readbacks through `run_in_executor`.

Known limit on replay: the card's random weights (the msm lane's z_i and
the group lane's w_g) come from `os.urandom` in `gpu/verifier.py`, as in
the JAX verifier; `types.set_weight_entropy` seeds only the host library's.
Verdicts on honest input do not depend on them, so the event log still
replays bit for bit; only the launches' arithmetic differs between runs.
"""

from __future__ import annotations

from ..cluster import AuthorityDetails, Cluster
from ..config import WorkerInfo
from dataclasses import replace
from .fabric import CURRENT_NODE, SimFabric


def node_id(index: int) -> str:
    return f"node{index}"


class SimCluster(Cluster):
    def __init__(self, size: int = 4, fabric: SimFabric | None = None, **kwargs):
        self.fabric = fabric or SimFabric()
        self._card_verifier = None  # built on the first cuda node
        # (epoch, round, digest-hex) per node, in exact commit order.
        self.commits: list[list[tuple[int, int, str]]] = [
            [] for _ in range(size)
        ]
        super().__init__(size=size, **kwargs)

    def _assign_addresses(self) -> None:
        committee = self.fixture.committee
        port = 0
        for i, fixture_auth in enumerate(self.fixture.authorities):
            pk = fixture_auth.public
            port += 1
            addr = f"{node_id(i)}:{port}"
            committee.authorities[pk] = replace(
                committee.authorities[pk], primary_address=addr
            )
            addrs = [addr]
            ws = self.fixture.worker_cache.workers[pk]
            for wid, info in ws.items():
                port += 2
                tx_addr = f"{node_id(i)}:{port - 1}"
                w_addr = f"{node_id(i)}:{port}"
                ws[wid] = WorkerInfo(
                    name=info.name, transactions=tx_addr, worker_address=w_addr
                )
                addrs += [tx_addr, w_addr]
            self.fabric.register_node(node_id(i), addrs)

    def _commit_tap(self, index: int):
        record = self.commits[index].append
        log = self.fabric.log

        def tap(output) -> None:
            cert = output.certificate
            entry = (cert.epoch, cert.round, cert.digest.hex())
            record(entry)
            log.append("commit", node_id(index), *entry)

        return tap

    def _crypto_pool(self, index: int):
        if self.crypto_backend != "cuda":
            return None
        from ..gpu.verifier import AsyncVerifierPool, GpuVerifier

        verifier = self._card_verifier
        if verifier is None:
            rule = getattr(self.parameters, "verify_rule", "strict")
            verifier = self._card_verifier = GpuVerifier(
                max_bucket=2048,
                msm_min_bucket=32,
                mode="msm" if rule == "cofactored" else "item",
                device=self.device,
            )
        return AsyncVerifierPool(
            backend=verifier,
            group_backend=lambda groups: verifier.collect_groups(
                verifier.submit_groups(groups)
            ),
        )

    async def start_node(self, index: int) -> AuthorityDetails:
        token = CURRENT_NODE.set(node_id(index))
        try:
            return await super().start_node(index)
        finally:
            CURRENT_NODE.reset(token)

    async def crash_node(self, index: int) -> None:
        """Fail-stop: isolate on the fabric first (peers see resets and
        refused reconnects, never a clean goodbye), then tear down."""
        self.fabric.set_node_down(node_id(index), True)
        await self.stop_node(index)

    async def restart_node(self, index: int) -> AuthorityDetails:
        self.fabric.set_node_down(node_id(index), False)
        if self.authorities[index].primary is not None:
            await self.stop_node(index)
        # A node restarted with a fresh in-memory store recommits its DAG
        # from genesis (deterministic ordering makes the replay identical),
        # so its observation record starts a fresh segment — the safety
        # oracle then checks the replayed sequence against the others'
        # full sequences, which is exactly the prefix property.
        self.commits[index].clear()
        return await self.start_node(index)

    def committed_rounds(self) -> list[float]:
        return [
            a.metric("consensus_last_committed_round") if a.primary else 0.0
            for a in self.authorities
        ]
