"""FaultPlan — the declarative scenario grammar.

Port copy of `narwhal_tpu/simnet/plan.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

A plan is a seed, default link conditions, and a time-ordered set of fault
events. Times are **virtual seconds** from scenario start; node references
are committee indices (canonical pubkey-sorted order, the same dense ids
certificates and the DAG tensors use). The scenario runner
(simnet/scenario.py) applies each event at its virtual time; the fabric
(simnet/fabric.py) enforces the link-level ones on every byte it carries.

Grammar (constructors are the DSL):

    FaultPlan(
        seed=7,                        # drives jitter/drop AND retry jitter
        default_link=LinkSpec(latency=0.001, jitter=0.0005, drop=0.0),
        events=(
            Partition(at=2.0, heal=5.0, groups=((0, 1), (2, 3))),
            LinkFault(at=1.0, end=4.0, a=0, b=3,
                      link=LinkSpec(latency=0.05, jitter=0.02, drop=0.01)),
            Crash(at=3.0, node=2, restart_at=6.0),
            WorkerLoss(at=2.5, node=1, worker_id=0),
            Equivocate(node=3, start=0.0),
            Reconfigure(at=4.0),       # epoch += 1, in-band, under traffic
        ),
    )

Semantics:

* `LinkSpec` — per-chunk delivery latency (+ uniform jitter from the seeded
  RNG); `drop` is the probability a chunk is lost, which on a framed,
  AEAD-sequenced stream means the CONNECTION dies (both ends see a reset)
  and the retry machinery reconnects — exactly a flaky TCP path.
* `Partition` — nodes in different groups cannot exchange bytes between
  `at` and `heal`: existing cross-group connections are reset, new connects
  are refused. Nodes absent from every group form an implicit last group.
* `Crash` — the node is isolated at `at` (connections reset, connects
  refused) and shut down; with `restart_at` it reboots with a fresh store
  and catches up (the reference's crash/recovery model for in-memory runs).
* `WorkerLoss` — one worker lane dies mid-quorum; the primary and the other
  lanes keep running.
* `Equivocate` — the node signs two conflicting headers per round from
  `start` on and shows different ones to different halves of the committee
  (simnet/byzantine.py).
* `Reconfigure` — an in-band epoch change (new committee json, epoch+1)
  pushed through every primary's own-worker control plane while traffic
  flows.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class LinkSpec:
    """Per-chunk delivery conditions for one (or the default) link."""

    latency: float = 0.001  # seconds, one-way, per chunk
    jitter: float = 0.0  # uniform [0, jitter) added per chunk (seeded RNG)
    drop: float = 0.0  # P(chunk lost) => connection reset


@dataclass(frozen=True)
class Partition:
    at: float
    heal: float
    groups: tuple[tuple[int, ...], ...]


@dataclass(frozen=True)
class LinkFault:
    """Override conditions on the (a, b) node pair, both directions,
    between `at` and `end` (None = until scenario end)."""

    at: float
    a: int
    b: int
    link: LinkSpec
    end: float | None = None


@dataclass(frozen=True)
class Crash:
    at: float
    node: int
    restart_at: float | None = None


@dataclass(frozen=True)
class WorkerLoss:
    at: float
    node: int
    worker_id: int = 0


@dataclass(frozen=True)
class Equivocate:
    node: int
    start: float = 0.0


@dataclass(frozen=True)
class Reconfigure:
    at: float


@dataclass(frozen=True)
class FaultPlan:
    seed: int = 0
    default_link: LinkSpec = field(default_factory=LinkSpec)
    events: tuple = ()

    def byzantine_nodes(self) -> frozenset[int]:
        return frozenset(
            e.node for e in self.events if isinstance(e, Equivocate)
        )

    def timed_events(self) -> list:
        """Every event with an `at` time, sorted by application time (ties
        keep declaration order, so plans are unambiguous)."""
        timed = [e for e in self.events if hasattr(e, "at")]
        order = sorted(enumerate(timed), key=lambda pair: (pair[1].at, pair[0]))
        return [e for _, e in order]
