"""Build, load and count the port's CUDA kernels.

Counterpart of `narwhal_tpu/tpu/kernel_registry.py`, which wraps every
device kernel in a `tracked_jit` and reports XLA compile walls. Here each
kernel is CUDA C++ under `csrc/`, compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<stem>-<hash>.so csrc/<stem>.cu

into a shared library with a plain C interface, loaded with `ctypes`.
Pointers and the stream are passed as `c_void_p`; every C entry point
returns `cudaGetLastError()` after its launch and `check` raises when it is
not 0. One library per source; sources build in parallel (one nvcc each,
all started together). The file name carries a hash of the source and the
flags, and of every header under `csrc/`, so a changed source or header is
rebuilt and an unchanged one is reused.

The registry keeps, in place of `compile_walls()`:
- one build wall per kernel (the wall of the nvcc run of its source), and
- one plain-integer launch count per kernel, incremented by the kernel's
  wrapper where it launches the kernel and nowhere else, so that a run can
  show its main path went through the kernels.

The JAX registry's per-mesh cache of sharded jit wrappers (`sharded()`)
has no counterpart: it exists to share XLA compiles between verifiers over
one mesh, and a CUDA library is built once per process whatever the mesh.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> (source stem, the JAX program it replaces)
KERNELS: dict[str, tuple[str, str]] = {
    "verify_batch": (
        "ed25519_verify", "narwhal_tpu/tpu/ed25519.py:395 verify_batch_kernel"),
    "msm_accumulate": (
        "ed25519_msm", "narwhal_tpu/tpu/ed25519.py:666 msm_accumulate_kernel"),
    "verify_decompress": (
        "ed25519_staged", "narwhal_tpu/tpu/ed25519.py:485 verify_decompress_kernel"),
    "verify_straus": (
        "ed25519_staged", "narwhal_tpu/tpu/ed25519.py:496 verify_straus_kernel"),
    "verify_verdict": (
        "ed25519_staged", "narwhal_tpu/tpu/ed25519.py:527 verify_verdict_kernel"),
    "msm_window": ("ed25519_msm", "narwhal_tpu/tpu/ed25519.py:549 msm_window_kernel"),
    "msm_shard_reduce": (
        "ed25519_msm",
        "narwhal_tpu/tpu/verifier.py:96 the cross-device reduce of msm_window (out_specs=None)"),
    "place_batch": ("dag_window", "narwhal_tpu/tpu/dag_kernels.py:95 place_batch"),
    "roll_window": ("dag_window", "narwhal_tpu/tpu/dag_kernels.py:79 roll_window"),
    "chain_commit": ("dag_window", "narwhal_tpu/tpu/dag_kernels.py:128 chain_commit"),
    "reach_many": ("dag_window", "narwhal_tpu/consensus/dag.py:262 _reach_k"),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_WALLS: dict[str, float] = {}  # source stem -> nvcc wall seconds
_LOGS: dict[str, str] = {}  # source stem -> nvcc output (ptxas register report)
_LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}


def nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _target(stem: str, csrc: Path = CSRC) -> Path:
    """The library's path: its name carries a hash of the source, of every
    header under csrc/ (a source may include any of them) and of the flags."""
    h = hashlib.sha256((csrc / f"{stem}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build(stems=None) -> dict[str, float]:
    """Build (if needed) and load the libraries of `stems` (default: every
    source under csrc/), one nvcc process per source, all started together.
    Returns the build wall of each source built or loaded here."""
    stems = sorted(set(stems or (s for s, _ in KERNELS.values())))
    with _LOCK:
        todo = [s for s in stems if s not in _LIBS]
        if not todo:
            return {s: _WALLS[s] for s in stems}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for stem in todo:
            out = _target(stem)
            if out.exists():
                _WALLS[stem] = 0.0
                _LOGS[stem] = "(reused an earlier build)"
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp, out, time.perf_counter(),
            )
        failed = []
        for stem, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            _WALLS[stem] = time.perf_counter() - t0
            _LOGS[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (rc={proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for stem in todo:
            _LIBS[stem] = ctypes.CDLL(str(_target(stem)))
        return {s: _WALLS[s] for s in stems}


def library(stem: str) -> ctypes.CDLL:
    lib = _LIBS.get(stem)
    if lib is None:
        build([stem])
        lib = _LIBS[stem]
    return lib


def function(stem: str, symbol: str, nargs_ptr: int, nargs_int: int):
    """The C entry point `symbol` of `stem`: `nargs_ptr` pointer arguments,
    then `nargs_int` int arguments, then the stream; returns a cudaError_t."""
    fn = getattr(library(stem), symbol)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def check(stem: str, kernel: str, rc: int) -> None:
    """Raise when a launch reported an error (the C side returns
    cudaGetLastError() right after the launch)."""
    if rc != 0:
        err = getattr(library(stem), f"{stem}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}): {err(rc).decode()}")


def count_launch(kernel: str) -> None:
    with _LOCK:
        _LAUNCHES[kernel] += 1


def launch_counts() -> dict[str, int]:
    with _LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def build_walls() -> dict[str, float]:
    """Build wall per kernel: the nvcc wall of the source it lives in
    (kernels that share a source share its wall)."""
    with _LOCK:
        return {
            name: _WALLS[stem] for name, (stem, _) in KERNELS.items() if stem in _WALLS
        }


def build_logs() -> dict[str, str]:
    with _LOCK:
        return dict(_LOGS)
