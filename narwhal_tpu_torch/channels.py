"""Metered bounded channels + bounded future pools — the actor plumbing.

Port copy of `narwhal_tpu/channels.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: metered mpsc channels whose depth is a prometheus gauge
(narwhal/types/src/metered_channel.rs:15-259) and semaphore-bounded
future queues (narwhal/types/src/bounded_future_queue.rs:17-156).
Every inter-actor edge in the primary/worker is one of these
(primary/src/primary.rs:104-151 creates 16+).
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Generic, TypeVar

from .metrics import Gauge

T = TypeVar("T")

DEFAULT_CHANNEL_CAPACITY = 1_000


def metered_channel(registry, role: str, name: str, capacity: int) -> "Channel":
    """A Channel with its depth gauge registered as
    `<role>_channel_<name>_depth` (SURVEY §5.6: every inter-task channel is
    a gauge; types/src/metered_channel.rs:15-259). The single naming seam
    for node/primary/worker channel metrics."""
    return Channel(
        capacity,
        gauge=registry.gauge(
            f"{role}_channel_{name}_depth",
            f"depth of the {role}'s {name} channel",
        ),
    )


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


class Watch(Generic[T]):
    """Single-value broadcast channel with change notification — tokio's
    watch, used for the reconfigure signal observed by every actor's select
    loop (see §3.5 of SURVEY; state_handler.rs:100-172)."""

    def __init__(self, initial: T):
        self._value = initial
        self._version = 0
        self._event = asyncio.Event()

    @property
    def value(self) -> T:
        return self._value

    @property
    def version(self) -> int:
        return self._version

    def send(self, value: T) -> None:
        self._value = value
        self._version += 1
        self._event.set()
        self._event = asyncio.Event()

    async def changed(self, seen_version: int) -> tuple[T, int]:
        """Wait until the version advances past seen_version; returns
        (value, version)."""
        while self._version <= seen_version:
            event = self._event
            await event.wait()
        return self._value, self._version


class Subscriber(Generic[T]):
    """Cursor over a Watch for select-loop style consumption."""

    def __init__(self, watch: Watch[T]):
        self._watch = watch
        self._seen = watch.version

    async def changed(self) -> T:
        value, self._seen = await self._watch.changed(self._seen)
        return value

    def peek(self) -> T:
        return self._watch.value


class BoundedExecutor:
    """Caps concurrent spawned tasks per peer
    (narwhal/network/src/bounded_executor.rs:46-153)."""

    def __init__(self, capacity: int):
        self._sem = asyncio.Semaphore(capacity)
        self._tasks: set[asyncio.Task] = set()

    async def spawn(self, coro: Awaitable) -> asyncio.Task:
        await self._sem.acquire()
        return self._track(coro)

    def try_spawn(self, coro) -> asyncio.Task | None:
        if self._sem.locked():
            # asyncio.Semaphore has no try_acquire; locked() means value==0
            if isinstance(coro, Awaitable):
                asyncio.ensure_future(coro).cancel()
            return None
        # non-blocking acquire: value > 0 so this cannot suspend
        self._sem._value -= 1  # noqa: SLF001 - mirrored from Semaphore.acquire fast path
        return self._track(coro)

    def _track(self, coro) -> asyncio.Task:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)

        def _done(t: asyncio.Task) -> None:
            self._tasks.discard(t)
            self._sem.release()
            if not t.cancelled() and t.exception() is not None:
                pass  # swallowed like the reference's detached tasks

        task.add_done_callback(_done)
        return task

    async def shutdown(self) -> None:
        for t in list(self._tasks):
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)


class BoundedFuturesOrdered:
    """Semaphore-bounded ordered future pool
    (narwhal/types/src/bounded_future_queue.rs): push blocks when full,
    results pop in push order."""

    def __init__(self, capacity: int):
        self._capacity = capacity
        self._queue: asyncio.Queue[asyncio.Task] = asyncio.Queue(maxsize=capacity)
        self._live: set[asyncio.Task] = set()

    async def push(self, coro: Awaitable) -> None:
        task = asyncio.ensure_future(coro)
        self._live.add(task)
        task.add_done_callback(self._live.discard)
        await self._queue.put(task)

    async def next(self):
        task = await self._queue.get()
        return await task

    def cancel_all(self) -> None:
        """Cancel every pushed future that has not completed yet; the pool
        owner must call this on teardown or in-flight work outlives it."""
        for task in list(self._live):
            task.cancel()

    def qsize(self) -> int:
        return self._queue.qsize()


async def drain_cancelled(tasks, timeout: float = 10.0, who: str = "") -> None:
    """Await already-cancelled tasks with a deadline. A task that ignores
    its cancellation (e.g. parked on a cancel-immune executor handoff) must
    not wedge shutdown forever — the reference aborts its tokio tasks and
    moves on; we warn and abandon. asyncio.wait neither re-cancels nor
    blocks past the timeout."""
    import logging

    live = [t for t in tasks if not t.done()]
    if not live:
        return
    _, stuck = await asyncio.wait(live, timeout=timeout)
    if stuck:
        logging.getLogger("narwhal.channels").warning(
            "%s shutdown: abandoning %d task(s) that ignored cancellation",
            who or "task",
            len(stuck),
        )


class CancelOnDrop:
    """Handle whose destruction cancels the underlying task
    (narwhal/network/src/lib.rs:27-47)."""

    def __init__(self, task: asyncio.Task):
        self.task = task

    def cancel(self) -> None:
        self.task.cancel()

    def __await__(self):
        return self.task.__await__()
