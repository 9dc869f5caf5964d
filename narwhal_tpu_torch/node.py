"""Node assembly: the execution state the node wires into its executor.

Port copy of part of `narwhal_tpu/node.py` (the JAX package's counterpart):
`SimpleExecutionState` only. The rest of the node (PrimaryNode, WorkerNode,
the restarter and the backpressure monitor) waits for the port of the node,
cluster and command line (ROADMAP queue 1, item 5).

Reference: narwhal/node/src/execution_state.rs:9-60.
"""

from __future__ import annotations

from .executor import ExecutionIndices, ExecutionState
from .stores import NodeStorage


class SimpleExecutionState(ExecutionState):
    """No-op application persisting its execution cursor in the node's store
    (narwhal/node/src/execution_state.rs:9-60)."""

    def __init__(self, storage: NodeStorage | None = None):
        self._cf = (
            storage.engine.column_family("execution_indices")
            if storage is not None
            else None
        )
        self._indices = ExecutionIndices()

    async def handle_consensus_transaction(self, output, indices, transaction):
        self._indices = indices
        if self._cf is not None:
            self._cf.put(b"indices", indices.to_bytes())
        return b""

    async def load_execution_indices(self) -> ExecutionIndices:
        if self._cf is not None:
            raw = self._cf.get(b"indices")
            if raw is not None:
                self._indices = ExecutionIndices.from_bytes(raw)
        return self._indices
