"""Execution progress indices — the exactly-once replay cursor.

Port copy of `narwhal_tpu/executor/state.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/executor/src/state.rs:13-64 — ExecutionIndices
{next_certificate_index, next_batch_index, next_transaction_index} persisted
by the application inside handle_consensus_transaction so a crash resumes at
the exact transaction boundary.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..codec import Reader, Writer


@dataclass(frozen=True)
class ExecutionIndices:
    next_certificate_index: int = 0
    next_batch_index: int = 0
    next_transaction_index: int = 0

    def next(
        self, total_batches: int, total_transactions: int
    ) -> "ExecutionIndices":
        """Advance past one transaction (state.rs:30-55): roll batch/
        certificate counters when their last element executes."""
        tx_done = self.next_transaction_index + 1 == total_transactions
        batch_done = tx_done and self.next_batch_index + 1 == total_batches
        return ExecutionIndices(
            next_certificate_index=self.next_certificate_index + (1 if batch_done else 0),
            next_batch_index=0 if batch_done else self.next_batch_index + (1 if tx_done else 0),
            next_transaction_index=0 if tx_done else self.next_transaction_index + 1,
        )

    def check_next_transaction_index(
        self, certificate_index: int, batch_index: int, transaction_index: int
    ) -> bool:
        """True iff (cert, batch, tx) is exactly the next transaction to
        execute (state.rs:57-64)."""
        return (
            certificate_index == self.next_certificate_index
            and batch_index == self.next_batch_index
            and transaction_index == self.next_transaction_index
        )

    def to_bytes(self) -> bytes:
        w = Writer()
        w.u64(self.next_certificate_index)
        w.u64(self.next_batch_index)
        w.u64(self.next_transaction_index)
        return w.finish()

    @staticmethod
    def from_bytes(data: bytes) -> "ExecutionIndices":
        r = Reader(data)
        out = ExecutionIndices(r.u64(), r.u64(), r.u64())
        r.done()
        return out
