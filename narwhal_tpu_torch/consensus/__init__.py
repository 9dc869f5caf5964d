"""Consensus for the port (counterpart: `narwhal_tpu/consensus/`).

The host engines `Bullshark` and `Tusk` (with `ordering`), the external
`Dag` service, `ConsensusState` and `ConsensusMetrics`. The device engines
are `narwhal_tpu_torch.gpu.dag_kernels.GpuBullshark` and `GpuTusk`; the
consensus runner comes with the node wiring (ROADMAP queue 1 item 5)."""

from .state import ConsensusState
from .bullshark import Bullshark
from .tusk import Tusk
from .dag import Dag, ValidatorDagError

__all__ = ["ConsensusState", "Bullshark", "Tusk", "Dag", "ValidatorDagError"]
