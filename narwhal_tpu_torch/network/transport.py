"""Transport provider seam — where simnet swaps the socket layer out.

Port copy of `narwhal_tpu/network/transport.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

`rpc.py` opens client connections and server listeners through this module
instead of calling asyncio directly. In production nothing changes: the
calls delegate straight to `asyncio.open_connection` / `asyncio.start_server`.
Under the simulation harness (narwhal_tpu_torch/simnet), `install(fabric)`
routes both through an in-memory fabric: the same length-prefixed, AEAD-sealed
frames flow over seeded virtual-latency queues instead of TCP sockets, so a
whole committee — hundreds of nodes — fits in one process with zero file
descriptors spent on the mesh.

The seam is process-global on purpose: a simulated committee is by
definition one process sharing one fabric, and the swap must catch every
connection the protocol opens (including lazy reconnects rounds later)
without threading a handle through every actor.
"""

from __future__ import annotations

import asyncio

_fabric = None


def install(fabric) -> None:
    """Route all connection setup through `fabric` (a simnet SimFabric:
    anything with `open_connection(host, port, limit=)` and
    `start_server(cb, host, port, limit=)` coroutines)."""
    global _fabric
    if _fabric is not None and fabric is not _fabric:
        raise RuntimeError("a simnet transport fabric is already installed")
    _fabric = fabric


def uninstall() -> None:
    global _fabric
    _fabric = None


def active():
    """The installed fabric, or None when running over real sockets."""
    return _fabric


def simnet_active() -> bool:
    return _fabric is not None


async def open_connection(host: str, port: int, *, limit: int):
    """(reader, writer) to host:port — via the fabric when one is installed,
    else a real TCP connection."""
    fabric = _fabric
    if fabric is not None:
        return await fabric.open_connection(host, port, limit=limit)
    return await asyncio.open_connection(host, port, limit=limit)
