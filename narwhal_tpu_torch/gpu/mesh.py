"""The device mesh of the committee-sharded commit walk and the dry run.

Counterpart of `jax.sharding.Mesh` as the JAX package builds it for
`--dag-shards` (`narwhal_tpu/node.py:296-330`) and for the multi-device dry
run (`__graft_entry__.py`, a `data x auth` grid). JAX runs such a mesh from
one process; so does the port: a mesh is an explicit grid of
`torch.device`s in one process, and a device may appear more than once
(`["cpu"] * k` in the tests, `[cuda:0] * k` on one card). The sharded
functions in `dag_kernels` launch on every device of a row in turn and move
the exchanged blocks with `.to(device)`.
"""

from __future__ import annotations

import torch

from ..config import ConfigError
from . import named_device


class DeviceMesh:
    """A grid of devices with named axes: `devices` is nested one level per
    axis (for `("data", "auth")` a d x a grid of rows), `.shape` maps each
    axis to its length, as `Mesh.shape` does."""

    def __init__(self, devices, axes):
        self.axes = tuple(axes)
        if len(self.axes) not in (1, 2) or len(set(self.axes)) != len(self.axes):
            raise ValueError(f"a mesh has one or two distinct axes, got {self.axes}")
        if len(self.axes) == 1:
            grid = (tuple(named_device(d) for d in devices),)
        else:
            grid = tuple(tuple(named_device(d) for d in row) for row in devices)
        if not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("mesh rows must be non-empty and of one length")
        self.devices = grid[0] if len(self.axes) == 1 else grid
        lengths = (len(grid[0]),) if len(self.axes) == 1 else (len(grid), len(grid[0]))
        self.shape = dict(zip(self.axes, lengths))

    def rows(self, axis: str) -> list[tuple[torch.device, ...]]:
        """The devices along `axis`, one tuple for each index of the other
        axis (a single tuple on a one-axis mesh)."""
        if axis not in self.shape:
            raise ConfigError(f"mesh has no {axis!r} axis (axes: {self.axes})")
        if len(self.axes) == 1:
            return [self.devices]
        if self.axes.index(axis) == 1:
            return list(self.devices)
        return [tuple(row[j] for row in self.devices) for j in range(len(self.devices[0]))]


def auth_mesh(shards: int, devices=None, data: int = 1) -> DeviceMesh:
    """The committee-axis mesh (`--dag-shards shards`): a `data x auth`
    grid of `data * shards` devices, auth the faster axis, as
    `Mesh(np.array(devs).reshape(data, shards), ("data", "auth"))` lays it
    out (with data = 1 the node's one-axis mesh, here a grid of one row).

    `devices` pins an explicit list, where a device may repeat; by default
    the first `data * shards` cards. Too few devices raise ConfigError:
    unlike the JAX node, which falls back to virtual CPU devices, the port
    never moves the sharded walk off the card unasked."""
    if shards < 1 or data < 1:
        raise ConfigError(f"--dag-shards {shards} x data {data} must be at least 1 x 1")
    need = shards * data
    if devices is not None:
        devs = [named_device(d) for d in devices]
        if len(devs) < need:
            raise ConfigError(
                f"--dag-shards {shards} x data {data} exceeds the {len(devs)} pinned devices"
            )
    else:
        count = torch.cuda.device_count()
        if count < need:
            raise ConfigError(
                f"--dag-shards {shards} x data {data} exceeds available devices "
                f"({count} cuda)"
            )
        devs = [torch.device("cuda", i) for i in range(need)]
    grid = [devs[r * shards:(r + 1) * shards] for r in range(data)]
    return DeviceMesh(grid, ("data", "auth"))
