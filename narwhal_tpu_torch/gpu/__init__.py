"""The port's device plane: hand-written CUDA kernels and their host wrappers.

Counterpart of `narwhal_tpu/tpu/__init__.py`. The JAX package's version
configures XLA's persistent compilation cache; here the kernels are CUDA
C++ sources under `csrc/`, built once per process with nvcc into
`_build/` (see `kernel_registry`), so there is no compile cache to manage.
What this module keeps is what every entry point of the port shares: the
device policy (`resolve_device`, `named_device`) and the device-to-host
readback (`HostCopy`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. `None` means the card (`cuda`);
    the CPU is used only when the caller asks for it, as the tests do.
    Raises when CUDA is asked for and absent — there is no silent CPU
    path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "narwhal_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def named_device(device=None) -> torch.device:
    """`resolve_device`, with a bare `cuda` pinned to the current card, so
    that no launch depends on the current device of the thread that makes
    it (the verifier's service threads, a mesh's device list)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class HostCopy:
    """Device tensors on their way to the host. On the card: a non-blocking
    copy of each into pinned memory plus one CUDA event that `result` waits
    on (the counterpart of jax's `copy_to_host_async`); on the CPU the
    tensors themselves."""

    def __init__(self, *tensors: torch.Tensor):
        self.devices = tuple(t.device for t in tensors)  # where the sources lie
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            dev = tensors[0].device
            self._host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self._host = list(tensors)

    def wait(self) -> None:
        """Block until the copies land."""
        if self._event is not None:
            self._event.synchronize()

    def result(self) -> list:
        """The tensors as numpy arrays (blocks until the copies land)."""
        self.wait()
        return [h.numpy() for h in self._host]
