"""The port's relay fanout, compact-certificate default and telemetry on a
live cluster, against the JAX package's scenarios.

- `tests/test_fanout.py` whole: the relay trees and header codecs, and its
  cluster scenarios (dissemination under relay equals direct broadcast, a
  crashed relay, the wire accounting metrics).
- `tests/test_compact_default.py` whole: the boot's symmetric
  ConfigErrors, the batched host pool under the compact default, the
  pool's group lane, the verifier stage and certificate references.
- `tests/test_telemetry.py` without the metrics catalog gate (it pins the
  JAX package's registries in `tools/metrics_catalog.json`): the tracer's
  spans, sampling and waterfalls, its simnet cases (telemetry RPCs over
  the port's fabric, a seeded scenario's bit-identical trace), and its
  cluster cases (per-incarnation tracer scoping, a live cluster's scrape,
  flight dump and waterfall).

Each module's source runs with the package renamed.
`test_live_cluster_scrape_dump_and_waterfall` is `slow` in the port: it
failed 2 of 3 runs alone here in both packages (its stage-order assertion
on one certificate's waterfall), where tier-1 takes only a case that
passes 5 of 5 under `-n 6`.
"""

import re
from pathlib import Path

import pytest

from test_torch_network import host_backends, port_scenarios  # noqa: F401 (a fixture)

# The renamed scenarios name no backend: the JAX node's host defaults.
pytestmark = pytest.mark.usefixtures("host_backends")

TESTS = Path(__file__).resolve().parent
FILES = ("test_fanout.py", "test_compact_default.py", "test_telemetry.py")
LEFT_OUT = frozenset({
    "test_metrics_catalog_matches_registries",  # the JAX package's catalog
})
FLAKY_UNDER_LOAD = frozenset({"test_live_cluster_scrape_dump_and_waterfall"})

_SCENARIOS = {}
for _file in FILES:
    for _name, _fn in port_scenarios(_file, LEFT_OUT).items():
        assert _name not in _SCENARIOS and _name not in globals(), _name
        _SCENARIOS[_name] = pytest.mark.slow(_fn) if _name in FLAKY_UNDER_LOAD else _fn
globals().update(_SCENARIOS)


def test_all_reference_fanout_scenarios_collected():
    ref = set()
    for file in FILES:
        ref |= set(re.findall(r"^def (test_\w+)", (TESTS / file).read_text(), re.M))
    assert set(_SCENARIOS) == ref - LEFT_OUT and len(_SCENARIOS) == 27
