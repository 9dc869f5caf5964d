"""Bullshark ordering engine — the default, lower-latency commit rule.

Port copy of `narwhal_tpu/consensus/bullshark.py` (the JAX package's
counterpart). The PyTorch port keeps its own copy so that it imports
nothing of `narwhal_tpu`.

Reference: narwhal/consensus/src/bullshark.rs:18-166. On a round-r
certificate: the candidate leader sits at even round r-1; it commits once the
round-r certificates referencing it carry >= f+1 stake (validity threshold);
committing a leader first commits every earlier linked leader, each flattening
its causal sub-DAG.
"""

from __future__ import annotations

from ..config import Committee
from ..stores import ConsensusStore
from ..types import Certificate, ConsensusOutput, Round, SequenceNumber
from . import ordering
from .state import ConsensusState


class Bullshark:
    def __init__(
        self,
        committee: Committee,
        store: ConsensusStore,
        gc_depth: Round,
        leader_fn=None,
    ):
        self.committee = committee
        self.store = store
        self.gc_depth = gc_depth
        # Tests may pin the leader (the reference's cfg(test) fixed-leader
        # shim, bullshark.rs:150-156); default is stake-weighted by round.
        self._leader_fn = leader_fn or ordering.dag_leader

    def process_certificate(
        self,
        state: ConsensusState,
        consensus_index: SequenceNumber,
        certificate: Certificate,
    ) -> list[ConsensusOutput]:
        round = certificate.round
        state.add(certificate)

        r = round - 1
        if r % 2 != 0 or r < 2:
            return []
        leader_round = r
        if leader_round <= state.last_committed_round:
            return []
        entry = self._leader_fn(self.committee, leader_round, state.dag)
        if entry is None:
            return []
        leader_digest, leader = entry

        support = sum(
            self.committee.stake(cert.origin)
            for _, cert in state.dag.get(round, {}).values()
            if leader_digest in cert.header.parents
        )
        if support < self.committee.validity_threshold():
            return []

        sequence: list[ConsensusOutput] = []
        for chain_leader in reversed(
            ordering.order_leaders(self.committee, leader, state, self._leader_fn)
        ):
            for cert in ordering.order_dag(self.gc_depth, chain_leader, state):
                state.update(cert, self.gc_depth)
                sequence.append(
                    ConsensusOutput(certificate=cert, consensus_index=consensus_index)
                )
                consensus_index += 1
                self.store.write_consensus_state(
                    state.last_committed, consensus_index - 1, cert.digest
                )
        return sequence

    def update_committee(self, new_committee: Committee) -> None:
        self.committee = new_committee
