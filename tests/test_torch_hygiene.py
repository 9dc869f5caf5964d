"""Hygiene of the PyTorch port: it stands alone, and it never falls back to
the CPU on its own.

- No module of `narwhal_tpu_torch/`, not `chip_smoke.py` and not
  `msm_breakdown.py` imports `jax` or
  anything of `narwhal_tpu` (an AST scan, so a lazy import inside a
  function counts too).
- Entry points resolve a missing `device` to CUDA and raise when CUDA is
  absent; the CPU is used only when asked for.
- Every kernel the registry lists has a CUDA source under `gpu/csrc/` that
  defines the C entry point its wrapper calls.
- `chip_smoke.py` exits non-zero without a card, and alone in a directory.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "narwhal_tpu_torch"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "msm_breakdown.py"]
    assert len(files) > 15
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = {
        m for m in _imports(path)
        if m.split(".")[0] in ("jax", "jaxlib", "narwhal_tpu", "flax", "optax")
    }
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_package_imports_without_jax_loaded():
    code = (
        "import sys\n"
        "import narwhal_tpu_torch.gpu.pipeline, narwhal_tpu_torch.gpu.verifier\n"
        "import narwhal_tpu_torch.gpu.dag_kernels, narwhal_tpu_torch.fixtures\n"
        "import narwhal_tpu_torch.consensus, narwhal_tpu_torch.channels\n"
        "import narwhal_tpu_torch.pacing, narwhal_tpu_torch.consensus.metrics\n"
        "import narwhal_tpu_torch.entry, narwhal_tpu_torch.gpu.mesh\n"
        "import narwhal_tpu_torch.native, narwhal_tpu_torch.storage\n"
        "import narwhal_tpu_torch.stores, narwhal_tpu_torch.tracing\n"
        "from narwhal_tpu_torch.consensus import Consensus\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'narwhal_tpu' or m.startswith('narwhal_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from narwhal_tpu_torch.consensus import Dag
    from narwhal_tpu_torch.entry import entry
    from narwhal_tpu_torch.fixtures import CommitteeFixture
    from narwhal_tpu_torch.gpu import resolve_device
    from narwhal_tpu_torch.gpu.dag_kernels import DagWindow, GpuBullshark, GpuTusk
    from narwhal_tpu_torch.gpu.verifier import GpuVerifier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    committee = CommitteeFixture(size=4).committee
    for make in (
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: GpuVerifier(),
        lambda: GpuBullshark(committee, None, 50),
        lambda: DagWindow(committee, 16),
        lambda: GpuTusk(committee, None, 50),
        lambda: Dag(committee, backend="cuda"),
        lambda: entry(),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert resolve_device("cpu").type == "cpu"
    assert GpuBullshark(committee, None, 50, device="cpu").device.type == "cpu"
    assert GpuTusk(committee, None, 50, device="cpu").device.type == "cpu"
    assert Dag(committee, backend="cuda", device="cpu")._win.device.type == "cpu"
    assert Dag(committee)._win is None  # the host backend needs no device


def test_registry_sources_define_the_wrapped_entry_points():
    from narwhal_tpu_torch.gpu import kernel_registry as kr

    symbols = {
        "verify_batch": "ed25519_verify_batch",
        "msm_accumulate": "ed25519_msm_accumulate",
        "window_sync": "dag_window_window_sync",
        "chain_commit": "dag_window_chain_commit",
        "reach_many": "dag_window_reach_many",
        "verify_decompress": "ed25519_verify_decompress",
        "verify_straus": "ed25519_verify_straus",
        "verify_verdict": "ed25519_verify_verdict",
        "msm_window": "ed25519_msm_window",
        "msm_shard_reduce": "ed25519_msm_shard_reduce",
        "leader_support": "dag_window_leader_support",
        "consensus_commit": "dag_window_consensus_commit",
        "sharded_walk": "dag_window_sharded_walk",
    }
    assert set(kr.KERNELS) == set(symbols)
    for name, (stem, replaces) in kr.KERNELS.items():
        src = (kr.CSRC / f"{stem}.cu").read_text()
        assert f'extern "C" int {symbols[name]}(' in src
        assert f'extern "C" const char* {stem}_error_string(' in src
        assert "cudaGetLastError()" in src
        path, _, _line = replaces.partition(" ")[0].partition(":")
        assert (REPO / path).is_file()
    assert "arch=compute_90a,code=sm_90a" in kr.NVCC_FLAGS


def test_a_changed_header_changes_every_build_target(tmp_path):
    """The library name hashes the source and every csrc/*.cuh: editing a
    shared header rebuilds each source that may include it."""
    import shutil

    from narwhal_tpu_torch.gpu import kernel_registry as kr

    csrc = tmp_path / "csrc"
    shutil.copytree(kr.CSRC, csrc)
    stems = sorted({stem for stem, _ in kr.KERNELS.values()})
    assert "ed25519_msm" in stems and list(csrc.glob("*.cuh"))
    before = {s: kr._target(s, csrc) for s in stems}
    assert before == {s: kr._target(s) for s in stems}
    header = csrc / "ed25519_field.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: kr._target(s, csrc) for s in stems}
    assert all(after[s] != before[s] for s in stems)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(kr._target(s, csrc) != after[s] for s in stems)


def test_launch_counts_are_plain_integers():
    from narwhal_tpu_torch.gpu import kernel_registry as kr

    kr.reset_launch_counts()
    kr.count_launch("chain_commit")
    kr.count_launch("chain_commit")
    counts = kr.launch_counts()
    assert counts["chain_commit"] == 2 and counts["verify_batch"] == 0
    kr.reset_launch_counts()
    assert set(kr.launch_counts().values()) == {0}


def test_cpu_tensors_never_launch():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu import kernel_registry as kr

    kr.reset_launch_counts()
    parent = torch.zeros((4, 3, 3), dtype=torch.uint8)
    present = torch.ones((4, 3), dtype=torch.uint8)
    dk.roll_window(parent, present, 1)
    dk.chain_commit(parent, present, 50, torch.zeros(3, dtype=torch.int32), 0,
                    torch.tensor([2], dtype=torch.int32),
                    torch.tensor([[1, 0, 0]], dtype=torch.uint8))
    dk.reach_many(parent, present, torch.tensor([2, 0], dtype=torch.int32),
                  torch.tensor([[1, 0, 0], [0, 0, 0]], dtype=torch.uint8))
    assert set(kr.launch_counts().values()) == {0}


def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
