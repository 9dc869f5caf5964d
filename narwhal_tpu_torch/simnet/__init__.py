"""simnet — deterministic adversary & fault-simulation harness.

Port copy of `narwhal_tpu/simnet/__init__.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

A seeded, virtual-clock, socket-free network for whole-committee
simulation: the production protocol stack (actors, framing, handshakes,
AEAD) runs unmodified over an in-memory fabric behind the
`network/transport.py` seam, driven by an event loop whose time is
simulated (`SimLoop`). Scenarios — partitions, link jitter/loss, crashes,
worker loss, byzantine equivocation, epoch reconfiguration under traffic —
are declared as a `FaultPlan` and replay bit-identically per seed.

    from narwhal_tpu_torch.simnet import (
        FaultPlan, Partition, Crash, Equivocate, run_scenario, oracles,
    )

    result = run_scenario(nodes=4, duration=5.0, plan=FaultPlan(
        seed=7, events=(Partition(at=1.0, heal=3.0, groups=((0, 1), (2, 3))),),
    ))
    oracles.assert_safety(result.commits)
    oracles.assert_liveness(result.rounds,
                            result.round_marks["heal@3.0"], min_rounds=2)

See README § "Fault simulation" for the grammar, oracle semantics, and the
determinism guarantees. In the port, `run_scenario` runs on the card unless
asked for the host (`crypto_backend="cpu", dag_backend="cpu"`, or
`device="cpu"` for the kernels' plain versions): see `scenario.py` and
`cluster.py` for how the card's verdicts ride the virtual clock.
"""

from . import fuzz, oracles
from .byzantine import Equivocator
from .clock import SimDeadlockError, SimLoop
from .cluster import SimCluster, node_id
from .fabric import CURRENT_NODE, EventLog, SimFabric
from .plan import (
    Crash,
    Equivocate,
    FaultPlan,
    LinkFault,
    LinkSpec,
    Partition,
    Reconfigure,
    WorkerLoss,
)
from .scenario import ScenarioResult, run_scenario

__all__ = [
    "CURRENT_NODE",
    "Crash",
    "Equivocate",
    "Equivocator",
    "EventLog",
    "FaultPlan",
    "LinkFault",
    "LinkSpec",
    "Partition",
    "Reconfigure",
    "ScenarioResult",
    "SimCluster",
    "SimDeadlockError",
    "SimFabric",
    "SimLoop",
    "WorkerLoss",
    "fuzz",
    "node_id",
    "oracles",
    "run_scenario",
]
