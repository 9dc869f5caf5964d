"""The JAX package's `tests/test_properties.py` against the port: hypothesis
properties: message round trips, `NodeDag` compression, the order DAG and
WAL truncation.

Its source runs with the package renamed
(`test_torch_network.port_scenarios`), its `Test*` classes included. Left
out: `test_registry_fully_covered` and
`test_message_roundtrip_whole_registry`, the JAX package's own reds
(`BackpressureMsg` has no fuzz strategy there);
`tests/test_torch_messages.py` holds every registered message's bytes in
both packages.
"""

import re
from pathlib import Path

from test_torch_network import port_scenarios

TESTS = Path(__file__).resolve().parent
FILE = "test_properties.py"
LEFT_OUT = frozenset({
    "test_registry_fully_covered",
    "test_message_roundtrip_whole_registry",
})

_SCENARIOS = port_scenarios(FILE, LEFT_OUT, classes=True)
assert not set(_SCENARIOS) & set(globals()), sorted(set(_SCENARIOS) & set(globals()))
globals().update(_SCENARIOS)


def test_all_reference_properties_scenarios_collected():
    ref = re.findall(r"^(?:def (test_\w+)|class (Test\w+))", (TESTS / FILE).read_text(), re.M)
    assert set(_SCENARIOS) == {a or b for a, b in ref} - LEFT_OUT
