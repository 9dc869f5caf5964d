"""Consensus for the port (counterpart: `narwhal_tpu/consensus/`).

The host engines `Bullshark` and `Tusk` (with `ordering`), the `Consensus`
runner that drives an engine (host or `gpu.dag_kernels.GpuBullshark` /
`GpuTusk`) from the certificate channel over a node's stores, the external
`Dag` service, `ConsensusState` and `ConsensusMetrics`."""

from .state import ConsensusState
from .bullshark import Bullshark
from .tusk import Tusk
from .runner import Consensus
from .dag import Dag, ValidatorDagError

__all__ = [
    "ConsensusState",
    "Bullshark",
    "Tusk",
    "Consensus",
    "Dag",
    "ValidatorDagError",
]
