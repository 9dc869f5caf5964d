"""The JAX package's `tests/test_dag.py` against the port: `NodeDag`, the host
Dag service and the device Dag service.

Its source runs with the package renamed
(`test_torch_network.port_scenarios`), its `Test*` classes included.
`TestDeviceDagService` names the JAX package's `"tpu"` backend: it runs on
the port's `backend="cuda"` with `device="cpu"` (the plain walk on CPU
tensors).
"""

import re
from pathlib import Path

from test_torch_network import port_scenarios

TESTS = Path(__file__).resolve().parent
FILE = "test_dag.py"
LEFT_OUT = frozenset()
SUBS = (
    ('backend="tpu"', 'backend="cuda", device="cpu"'),
)

_SCENARIOS = port_scenarios(FILE, LEFT_OUT, subs=SUBS, classes=True)
assert not set(_SCENARIOS) & set(globals()), sorted(set(_SCENARIOS) & set(globals()))
globals().update(_SCENARIOS)


def test_all_reference_dag_scenarios_collected():
    ref = re.findall(r"^(?:def (test_\w+)|class (Test\w+))", (TESTS / FILE).read_text(), re.M)
    assert set(_SCENARIOS) == {a or b for a, b in ref} - LEFT_OUT
