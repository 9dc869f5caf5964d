"""The repository's static gates over the PyTorch port.

- narwhal-lint over `narwhal_tpu_torch/`: no finding that is not
  suppressed inline with its justification (the port has no baseline).
- narwhal-sched over `narwhal_tpu_torch/`: likewise.
- narwhal-topo from the port's wiring root, `__main__._run_node`: no
  finding, and the extracted actors, channels and edges equal the JAX
  package's extraction from its own `_run_node` with the package name
  mapped (`narwhal_tpu_torch` for `narwhal_tpu`, `gpu/` for `tpu/`).

The tools are the JAX package's (`tools/`), run unchanged.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools.analysis import Context, extract, run_detectors  # noqa: E402
from tools.analysis.__main__ import topology_doc  # noqa: E402
from tools.lint import run_lint  # noqa: E402

PORT_ROOT = "narwhal_tpu_torch/__main__.py::_run_node"
JAX_ROOT = "narwhal_tpu/__main__.py::_run_node"


def test_port_lint_has_no_findings():
    result = run_lint([str(REPO / "narwhal_tpu_torch")], baseline=None, root=REPO)
    assert result.files_scanned >= 78
    details = "\n".join(f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in result.new)
    assert not result.new, f"lint findings in the port:\n{details}"


def test_port_sched_has_no_findings():
    from tools.sched import run_sched

    result = run_sched([str(REPO / "narwhal_tpu_torch")], root=REPO)
    details = "\n".join(f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in result.new)
    assert not result.new, f"sched findings in the port:\n{details}"


@pytest.fixture(scope="module")
def topologies():
    port, port_ex = extract(REPO, package="narwhal_tpu_torch", roots=[PORT_ROOT])
    jax, _ = extract(REPO)
    return port, port_ex, jax


def test_port_topology_has_no_findings(topologies):
    port, port_ex, _ = topologies
    result = run_detectors(Context(port, port_ex.program, REPO))
    details = "\n".join(f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in result.new)
    assert not result.new, f"topology findings in the port:\n{details}"
    assert len(port.live_channels()) >= 20 and len(port.tasks) >= 30


def _mapped(doc: dict) -> dict:
    text = json.dumps({k: v for k, v in doc.items() if k != "roots"}, sort_keys=True)
    text = text.replace("narwhal_tpu_torch/gpu/", "narwhal_tpu/tpu/")
    return json.loads(text.replace("narwhal_tpu_torch", "narwhal_tpu"))


def test_port_topology_equals_the_jax_topology(topologies):
    port, _, jax = topologies
    port_doc = _mapped(topology_doc(port, [PORT_ROOT]))
    jax_doc = _mapped(topology_doc(jax, [JAX_ROOT]))
    for key in ("channels", "tasks", "edges"):
        assert port_doc[key] == jax_doc[key], key
    edges = {(e["task"], e["channel"], e["op"]) for e in port_doc["edges"]}
    assert ("_run_node._drain_execution_output", "node/execution_output", "recv") in edges
    assert ("Consensus.run", "node/consensus_output", "send") in edges
