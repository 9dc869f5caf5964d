"""The virtual clock: an event loop whose time is simulated.

Port copy of `narwhal_tpu/simnet/clock.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

`SimLoop` is a selector event loop with three changes that together make a
whole-committee simulation deterministic and wall-clock free:

* **`time()` is virtual.** It starts at 0.0 and only moves when the loop
  would otherwise sleep: when a `_run_once` iteration has no ready
  callbacks, the selector wrapper advances the virtual clock by exactly the
  timeout the loop computed (the gap to the earliest scheduled timer)
  instead of blocking in `select`. `asyncio.sleep`, `wait_for` deadlines,
  pacing timers and retry backoffs all run against this clock, so a
  10-virtual-second scenario takes however long its *CPU work* takes —
  typically milliseconds — and two runs take identical virtual trajectories.

* **`run_in_executor` runs inline.** Thread handoffs are the one asyncio
  feature whose completion order depends on the host scheduler; executing
  the function synchronously (storage flushes are cheap no-fsync appends in
  the in-memory configurations simnet uses) removes the only source of
  nondeterminism the loop itself could introduce.

* **Quiescence is an error.** A real loop with nothing scheduled blocks in
  `select` forever waiting for I/O; a simulated committee has no external
  I/O, so "no ready callbacks and no timers" means every task is parked on
  an event that can never fire — a deadlock. The loop raises immediately
  with the pending-task count instead of hanging the test.

Timer ordering is inherited from asyncio's scheduled heap (strictly by
`when`, ties by insertion order), so equal-deadline callbacks fire in the
order they were scheduled — deterministically.
"""

from __future__ import annotations

import asyncio
import selectors


class SimDeadlockError(RuntimeError):
    """No ready callbacks, no scheduled timers, no external I/O possible:
    the simulation can never make progress again."""


class _VirtualTimeSelector:
    """Selector wrapper: polls real fds without blocking (only the loop's
    self-pipe is ever registered — simnet opens no sockets) and converts the
    would-be blocking time into a virtual-clock jump."""

    def __init__(self, inner: selectors.BaseSelector):
        self._inner = inner
        self._loop: "SimLoop | None" = None

    def select(self, timeout=None):
        events = self._inner.select(0)
        if events:
            return events
        if timeout is None:
            loop = self._loop
            pending = (
                sum(1 for t in asyncio.all_tasks(loop) if not t.done())
                if loop is not None
                else "?"
            )
            raise SimDeadlockError(
                "simnet deadlock: no runnable callbacks and no timers, but "
                f"{pending} task(s) still pending — every task is waiting "
                "on an event that can never fire"
            )
        if timeout > 0 and self._loop is not None:
            self._loop._sim_now += timeout
        return events

    def __getattr__(self, name):
        return getattr(self._inner, name)


class SimLoop(asyncio.SelectorEventLoop):
    """Event loop on virtual time. Construct, `asyncio.set_event_loop`, and
    drive with `run_until_complete` — `simnet.scenario` wraps the lifecycle."""

    def __init__(self):
        selector = _VirtualTimeSelector(selectors.DefaultSelector())
        super().__init__(selector)
        selector._loop = self
        self._sim_now = 0.0

    def time(self) -> float:
        return self._sim_now

    def run_in_executor(self, executor, func, *args):
        # Inline: see module docstring. Returns an already-resolved future,
        # matching the awaitable contract of the real method.
        fut = self.create_future()
        try:
            fut.set_result(func(*args))
        except Exception as e:  # delivered through the future, like a pool
            fut.set_exception(e)
        return fut
