"""The device mesh of the committee-sharded commit walk and the dry run.

Counterpart of `jax.sharding.Mesh` as the JAX package builds it for
`--dag-shards` (`narwhal_tpu/node.py:296-330`) and for the multi-device dry
run (`__graft_entry__.py`, a `data x auth` grid). JAX runs such a mesh from
one process; so does the port: a mesh is an explicit grid of
`torch.device`s in one process, and a device may appear more than once
(`["cpu"] * k` in the tests, `[cuda:0] * k` on one card).

The sharded walk of an auth row takes one of three routes, chosen from the
row's topology when the mesh is built (`walk_route`, kept in
`DeviceMesh.routes`) and never on a failure. On each a walk set is one
`sharded_walk` launch per card, a thread-block cluster of a CTA per shard
of the card:
  "cluster"  every shard on one card: one launch;
  "peer"     the row spans cards that all have peer access to one
             another: the launches exchange frontier blocks through
             peer-mapped card memory (`WalkExchange`, kept on the mesh so
             that its buffers outlive every launch);
  "host"     the row spans cards without peer access: the launches
             exchange through pinned host memory that every card maps.
A mesh on the CPU walks with the plain version on every route but "peer".
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from ..config import ConfigError
from . import named_device


MAX_CLUSTER = 16  # sharded_walk: CTAs a cluster (8 portable, 16 non-portable)
ROUTES = ("cluster", "peer", "host")


def walk_route(devices) -> str:
    """The sharded walk's route over one auth row of devices, from the
    topology alone: "cluster" when every shard is on one device, "peer"
    when the row spans CUDA cards that all have peer access to one another
    (`torch.cuda.can_device_access_peer` on every ordered pair), else
    "host". Raises ConfigError when a row mixes the CPU and cards, or
    when a card would hold more shards of the row than a cluster holds
    (MAX_CLUSTER); the CPU, where the plain version walks, takes any
    number."""
    devs = tuple(devices)
    distinct = list(dict.fromkeys(devs))
    if len({d.type for d in distinct}) > 1:
        raise ConfigError(f"an auth row mixes device types: {[str(d) for d in distinct]}")
    if len(distinct) == 1:
        route = "cluster"
    elif all(torch.cuda.can_device_access_peer(a, b)
             for a in distinct for b in distinct if a != b):
        route = "peer"
    else:
        route = "host"
    if distinct[0].type != "cuda":
        return route  # one CPU device: the plain version, no cluster
    most = max(devs.count(d) for d in distinct)
    if most > MAX_CLUSTER:
        raise ConfigError(
            f"the {route} route puts {most} shards of an auth row on one device: a "
            f"thread-block cluster holds at most {MAX_CLUSTER}"
        )
    return route


class WalkExchange:
    """One auth row's shards as the sharded walk launches them on `route`.

    `groups` holds one list of slots (shard indices of the row) per launch:
    every slot in one group on "cluster"; on "peer" and "host" one group
    per card, or, on one card repeated (a forced route that tests the
    exchange without a second card), one group per slot, each with its own
    launch, stream and exchange buffer; on a CPU row "host" is one group
    (the plain version walks every slot at once). `devices[g]` is group
    g's device. On the exchange routes on the card it also keeps what the
    launches share: each group's exchange buffer ("peer": card memory
    mapped by the other cards; "host": pinned host memory every card
    maps), pointer table, error word, slot and owner tables and stream, and
    the generation counter `gen` that every launch advances (see
    csrc/dag_window.cu, sharded_walk)."""

    def __init__(self, devices, route: str):
        row = tuple(devices)
        distinct = list(dict.fromkeys(row))
        if route == "cluster":
            if len(distinct) != 1:
                raise ConfigError(f"the cluster route needs every shard on one device, got "
                                  f"{[str(d) for d in row]}")
            walk_route(row)
            groups = [list(range(len(row)))]
        elif route in ("peer", "host"):
            cards = all(d.type == "cuda" for d in distinct)
            if route == "host" and not cards and len(distinct) == 1:
                groups = [list(range(len(row)))]  # the CPU: the plain version
            elif not cards:
                raise ConfigError(f"the {route} route runs on cards only, got "
                                  f"{[str(d) for d in distinct]}")
            elif len(distinct) == 1:
                groups = [[i] for i in range(len(row))]
            else:
                own = walk_route(row)  # raises past a cluster's shards on one card
                if route == "peer" and own != "peer":
                    raise ConfigError(f"the peer route needs peer access between every pair "
                                      f"of {[str(d) for d in distinct]}")
                groups = [[i for i, d in enumerate(row) if d == u] for u in distinct]
        else:
            raise ConfigError(f"unknown walk route {route!r} (one of {ROUTES})")
        self.route = route
        self.row = row
        self.groups = groups
        self.devices = [row[g[0]] for g in groups]
        self.gen = 0
        self._shared = None

    def shared(self, nslots: int, npad: int) -> dict:
        """The exchange launches' shared state, sized for `nslots` walk slots
        of `npad` frontier bytes (grown, zeroed and `gen` reset when too
        small; the caller synchronises every launch before it returns, so no
        launch is in flight then, and the buffers it drops are freed). Every
        launch passes the kernel st["nslots"], the layout the buffers were
        made with, whatever its own walk count, so a later launch with fewer
        walks or in the other mode finds each flag where the earlier ones
        left it. On "peer" the buffers are card memory, each ordered pair of
        distinct cards mapped at the first call; on "host" pinned host
        memory (`HostBuffer`), with no peer mapping."""
        from . import kernel_registry

        st = self._shared
        if st is not None and st["nslots"] >= nslots and st["npad"] >= npad:
            return st
        G = len(self.groups)
        if st is None and self.route == "peer":
            enable = kernel_registry.library("dag_window").dag_window_enable_peer
            enable.argtypes, enable.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
            cards = list(dict.fromkeys(self.devices))
            for a in cards:
                for b in cards:
                    if a != b:
                        kernel_registry.check("dag_window", "enable_peer",
                                              enable(a.index, b.index))
        nbytes = 12 * nslots * G + 2 * nslots * npad
        if self.route == "host":
            bufs = [HostBuffer(nbytes) for _ in self.devices]
            ptrs = [b.ptr for b in bufs]
        else:
            bufs = [torch.zeros((nbytes,), dtype=torch.uint8, device=d) for d in self.devices]
            ptrs = [b.data_ptr() for b in bufs]
        owner = [0] * len(self.row)
        for g, slots in enumerate(self.groups):
            for s in slots:
                owner[s] = g
        self._shared = st = {
            "nslots": nslots, "npad": npad, "bufs": bufs,
            "tables": [torch.tensor(ptrs, dtype=torch.int64, device=d) for d in self.devices],
            "owner": [torch.tensor(owner, dtype=torch.int32, device=d) for d in self.devices],
            "slots": [torch.tensor(s, dtype=torch.int32, device=d)
                      for s, d in zip(self.groups, self.devices)],
            "errs": [torch.zeros((2,), dtype=torch.int32, device=d) for d in self.devices],
            "streams": [torch.cuda.Stream(device=d) for d in self.devices],
        }
        self.gen = 0
        return st


class HostBuffer:
    """`nbytes` of zeroed pinned host memory that every card maps (portable,
    mapped; `ptr` is its address on the host and on every card), freed
    when the object goes. Its holder keeps it past every launch that uses
    it (`WalkExchange.shared`)."""

    def __init__(self, nbytes: int):
        from . import kernel_registry

        lib = kernel_registry.library("dag_window")
        alloc, free = lib.dag_window_host_alloc, lib.dag_window_host_free
        alloc.argtypes, alloc.restype = [ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int
        free.argtypes, free.restype = [ctypes.c_void_p], ctypes.c_int
        out = ctypes.c_void_p()
        kernel_registry.check("dag_window", "host_alloc", alloc(nbytes, ctypes.byref(out)))
        self.ptr = out.value
        self.nbytes = nbytes
        weakref.finalize(self, free, self.ptr)


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
        # The sharded walk's route of each auth row, from the topology alone.
        self.routes = [walk_route(r) for r in self.rows("auth")] if "auth" in self.shape else []
        self._walks: dict[tuple[int, str], WalkExchange] = {}

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

    def walk(self, row: int = 0, route: str | None = None) -> WalkExchange:
        """Auth row `row`'s shards as the sharded walk launches them: on the
        row's own route, or on `route` where a caller forces one (tests and
        chip_smoke.py run "peer" and "host" on one card repeated). Kept on
        the mesh, so the exchange routes' buffers outlive every launch."""
        route = route or self.routes[row]
        ex = self._walks.get((row, route))
        if ex is None:
            ex = self._walks[(row, route)] = WalkExchange(self.rows("auth")[row], route)
        return ex


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
