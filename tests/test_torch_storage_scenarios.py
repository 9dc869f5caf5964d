"""The JAX package's `tests/test_storage.py` against the port: the WAL engine,
group commit, notify-read, the stores and the native engine.

Its source runs with the package renamed
(`test_torch_network.port_scenarios`), its `Test*` classes included.
"""

import re
from pathlib import Path

from test_torch_network import port_scenarios

TESTS = Path(__file__).resolve().parent
FILE = "test_storage.py"
LEFT_OUT = frozenset()

_SCENARIOS = port_scenarios(FILE, LEFT_OUT, classes=True)
assert not set(_SCENARIOS) & set(globals()), sorted(set(_SCENARIOS) & set(globals()))
globals().update(_SCENARIOS)


def test_all_reference_storage_scenarios_collected():
    ref = re.findall(r"^(?:def (test_\w+)|class (Test\w+))", (TESTS / FILE).read_text(), re.M)
    assert set(_SCENARIOS) == {a or b for a, b in ref} - LEFT_OUT
