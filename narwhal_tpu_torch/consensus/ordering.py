"""Commit ordering: leader chains and causal-history flattening.

Port copy of `narwhal_tpu/consensus/ordering.py` (the JAX package's
counterpart). The PyTorch port keeps its own copy so that it imports
nothing of `narwhal_tpu`.

Reference: narwhal/consensus/src/utils.rs:11-101 (order_leaders,
linked, order_dag) — the per-commit DAG-walk hot path named by the north star.
This module is the host (exact-semantics) implementation; the vectorized
adjacency-tensor version lives in narwhal_tpu_torch/gpu/dag_kernels.py and is
equivalence-tested against this one on random lossy DAGs.

Determinism note: the reference iterates Rust HashSets during the DFS, so its
within-round tie order is platform-defined. We iterate parents in sorted
digest order, making the full sequence a pure function of the DAG — which is
what lets the device kernel reproduce it bit-for-bit.
"""

from __future__ import annotations

from typing import Callable

from ..config import Committee
from ..types import Certificate, Digest, Round
from .state import ConsensusState, DagMap

LeaderFn = Callable[[Committee, Round, DagMap], tuple[Digest, Certificate] | None]


def order_leaders(
    committee: Committee,
    leader: Certificate,
    state: ConsensusState,
    get_leader: LeaderFn,
) -> list[Certificate]:
    """Walk even rounds back to the last committed round, keeping each prior
    leader that is linked to the one after it (utils.rs:11-38). Returned
    newest-first, like the reference (callers commit in reverse)."""
    to_commit = [leader]
    current = leader
    for r in range(leader.round - 2, state.last_committed_round + 1, -2):
        entry = get_leader(committee, r, state.dag)
        if entry is None:
            continue
        _, prev_leader = entry
        if linked(current, prev_leader, state.dag):
            to_commit.append(prev_leader)
            current = prev_leader
    return to_commit


def linked(leader: Certificate, prev_leader: Certificate, dag: DagMap) -> bool:
    """Is there a DAG path from leader down to prev_leader (utils.rs:40-53)?
    Round-by-round frontier propagation — on the device this is the bitwise
    matmul chain over parent adjacency matrices."""
    frontier = [leader]
    for r in range(leader.round - 1, prev_leader.round - 1, -1):
        certs = dag.get(r, {})
        parent_digests = set()
        for cert in frontier:
            parent_digests |= cert.header.parents
        frontier = [
            cert for digest, cert in certs.values() if digest in parent_digests
        ]
    return any(c.digest == prev_leader.digest for c in frontier)


def order_dag(
    gc_depth: Round, leader: Certificate, state: ConsensusState
) -> list[Certificate]:
    """Flatten the leader's uncommitted causal history, oldest round first
    (utils.rs:55-101): DFS collecting certificates not yet committed for
    their authority, drop anything past the GC bound, stable-sort by round."""
    ordered: list[Certificate] = []
    seen: set[Digest] = set()
    buffer = [leader]
    while buffer:
        cert = buffer.pop()
        ordered.append(cert)
        round_certs = state.dag.get(cert.round - 1, {})
        by_digest = {digest: c for digest, c in round_certs.values()}
        for parent_digest in sorted(cert.header.parents):
            parent = by_digest.get(parent_digest)
            if parent is None:
                continue  # already ordered or garbage collected
            if parent_digest in seen:
                continue
            # The reference checks equality here (utils.rs:86-89), relying on
            # update() having purged anything older from the DAG; we use >= so
            # the guard also holds on a freshly-recovered DAG window, where
            # already-committed certificates may still be present.
            if state.last_committed.get(parent.origin, 0) >= parent.round:
                continue
            seen.add(parent_digest)
            buffer.append(parent)

    ordered = [
        c for c in ordered if c.round + gc_depth >= state.last_committed_round
    ]
    # Canonical commit order: (round, origin). The reference only sorts by
    # round and leaves within-round order to Rust HashSet iteration (i.e.
    # nondeterministic); fixing the tie-break on the origin key makes the
    # sequence a pure function of the DAG and lets the device adjacency-matrix
    # kernel (gpu/dag_kernels.py) reproduce it exactly — origin order equals
    # committee dense-index order because committees sort by public key.
    ordered.sort(key=lambda c: (c.round, c.origin))
    return ordered


def dag_leader(
    committee: Committee, round: Round, dag: DagMap
) -> tuple[Digest, Certificate] | None:
    """The elected leader's certificate at `round`, if present
    (bullshark.rs:141-166). Stake-weighted choice seeded by the round."""
    name = committee.leader(round)
    entry = dag.get(round, {}).get(name)
    return entry
