"""The JAX package's `tests/test_pacing.py` against the port: the pacing
controller, backpressure, the ingest gate, the batch maker's seal deadlines
and the stage timer.

Its source runs with the package renamed
(`test_torch_network.port_scenarios`), its `Test*` classes included. The
scenarios that boot a `Cluster` name no backend: they run on the host, the
JAX node's defaults (`host_backends`).
"""

import re
from pathlib import Path

import pytest

from test_torch_network import host_backends, port_scenarios  # noqa: F401 (a fixture)

# The renamed scenarios name no backend: the JAX node's host defaults.
pytestmark = pytest.mark.usefixtures("host_backends")

TESTS = Path(__file__).resolve().parent
FILE = "test_pacing.py"
LEFT_OUT = frozenset()

_SCENARIOS = port_scenarios(FILE, LEFT_OUT, classes=True)
assert not set(_SCENARIOS) & set(globals()), sorted(set(_SCENARIOS) & set(globals()))
globals().update(_SCENARIOS)


def test_all_reference_pacing_scenarios_collected():
    ref = re.findall(r"^(?:def (test_\w+)|class (Test\w+))", (TESTS / FILE).read_text(), re.M)
    assert set(_SCENARIOS) == {a or b for a, b in ref} - LEFT_OUT
