"""Metered bounded channel: the `Channel` that feeds `Dag.spawn()`.

Port copy of `Channel` from `narwhal_tpu/channels.py` (the JAX package's
counterpart). The PyTorch port keeps its own copy so that it imports nothing
of `narwhal_tpu`. Only `Channel` is here: the rest of that module
(`metered_channel`, `Watch`, `Subscriber`, `BoundedExecutor`,
`BoundedFuturesOrdered`, `CancelOnDrop`) comes with the node and worker
wiring (ROADMAP queue 1, items 5 and 7).

Reference: metered mpsc channels whose depth is a prometheus gauge
(narwhal/types/src/metered_channel.rs:15-259).
"""

from __future__ import annotations

import asyncio
from typing import Generic, TypeVar

from .metrics import Gauge

T = TypeVar("T")

DEFAULT_CHANNEL_CAPACITY = 1_000


class Channel(Generic[T]):
    """Bounded mpsc with a depth gauge."""

    def __init__(self, capacity: int = DEFAULT_CHANNEL_CAPACITY, gauge: Gauge | None = None):
        self._q: asyncio.Queue[T] = asyncio.Queue(maxsize=capacity)
        self._capacity = max(1, capacity)
        self._gauge = gauge

    @property
    def capacity(self) -> int:
        return self._capacity

    def depth(self) -> int:
        """Items currently queued — the observability hook the pacing
        controller and backpressure monitor read (alongside the per-channel
        depth gauge metered_channel registers)."""
        return self._q.qsize()

    def occupancy(self) -> float:
        """depth/capacity in [0, 1]: the unit every pacing/admission
        watermark is expressed in, so channels of different capacities feed
        one controller without per-channel scaling."""
        return self._q.qsize() / self._capacity

    async def send(self, item: T) -> None:
        await self._q.put(item)
        if self._gauge:
            self._gauge.set(self._q.qsize())

    def try_send(self, item: T) -> bool:
        try:
            self._q.put_nowait(item)
        except asyncio.QueueFull:
            return False
        if self._gauge:
            self._gauge.set(self._q.qsize())
        return True

    async def send_many(self, items) -> None:
        """Enqueue a burst with at most one suspension point per full queue:
        items slot in via put_nowait while capacity lasts and only block
        when the queue is actually full, and the depth gauge updates once
        per burst instead of once per item. The executor's batch drain uses
        this so applying a staged batch costs zero per-transaction channel
        hops."""
        for item in items:
            try:
                self._q.put_nowait(item)
            except asyncio.QueueFull:
                if self._gauge:
                    self._gauge.set(self._q.qsize())
                await self._q.put(item)
        if self._gauge:
            self._gauge.set(self._q.qsize())

    async def recv(self) -> T:
        item = await self._q.get()
        if self._gauge:
            self._gauge.set(self._q.qsize())
        return item

    def try_recv(self) -> T | None:
        try:
            item = self._q.get_nowait()
        except asyncio.QueueEmpty:
            return None
        if self._gauge:
            self._gauge.set(self._q.qsize())
        return item

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()
