"""Persistent storage: WAL-backed column-family store with notify_read.

Port of `narwhal_tpu/storage.py` (the JAX package's counterpart). The PyTorch
port keeps its own copy so that it imports nothing of `narwhal_tpu`; the
on-disk format is byte-identical, so either package reopens the other's
directory, on either backend.

The reference persists everything in RocksDB through the typed-store crate:
9 column families opened at narwhal/node/src/lib.rs:53-123, a generic
Store<K,V> with read/write/remove/notify_read/iter, and a CertificateStore
with a (round, digest) secondary index plus a blocking notify_read pub/sub
(narwhal/storage/src/certificate_store.rs:28-331) — the primitive all
"waiter" components are built on.

Design: node state is small (digests, headers, certs — payload batches are
the only bulk data), so there is an in-memory hash table per column family
backed by an append-only write-ahead log for durability. Recovery replays
the WAL; a torn tail record is discarded, giving atomic write_batch.
`compact()` rewrites the log when garbage exceeds a threshold (GC deletes
from consensus would otherwise grow it unboundedly).

Two interchangeable backends share the on-disk format: the pure-Python
engine below, and the native C++ engine (native_src/storage_engine.cpp via
narwhal_tpu_torch/native.py, the analog of the reference's RocksDB C++
core). The native one is used when it builds and loads; NARWHAL_NATIVE=0
(or `use_native=False`) forces Python. The notify_read waiter plane always
lives in Python (it is event-loop state, not storage).

Group commit: the async write API (`ColumnFamily.put_async`,
`StorageEngine.write_batch_async`) coalesces every write enqueued while a
flush is in flight into ONE fused WAL record with ONE flush — the RocksDB
WAL group-commit discipline. Callers get the shared commit future of their
group; on the pure-Python backend the memtable (and notify_read waiters)
see the write immediately, so only durability waits for the group. A torn
tail of a fused record discards the WHOLE group on replay — group commits
are crash-atomic exactly like `write_batch`. The sync API appends and
flushes before returning; when a group is pending, a sync write first
persists the group's ops ahead of its own so WAL order always matches
memtable apply order.
"""

from __future__ import annotations

import asyncio
import os
import struct
import threading
import time
import zlib
from typing import Iterable, Iterator

_HDR = struct.Struct("<II")  # payload_len, crc32


class StorageStats:
    """Process-wide group-commit counters (the WireStats analog for the
    storage plane): every fused group committed by every engine in this
    process. The benchmark harness samples `snapshot()` around its window
    to report ops-per-flush — the quantity group commit exists to move."""

    groups_committed = 0
    ops_committed = 0
    max_group_ops = 0
    flush_seconds_total = 0.0

    @classmethod
    def record_group(cls, ops: int, flush_seconds: float) -> None:
        cls.groups_committed += 1
        cls.ops_committed += ops
        if ops > cls.max_group_ops:
            cls.max_group_ops = ops
        cls.flush_seconds_total += flush_seconds

    @classmethod
    def snapshot(cls) -> dict:
        return {
            "groups_committed": cls.groups_committed,
            "ops_committed": cls.ops_committed,
            "max_group_ops": cls.max_group_ops,
            "flush_seconds_total": round(cls.flush_seconds_total, 6),
        }


class _CommitGroup:
    """One pending fused commit: ops accumulate until the committer drains
    the group; every enqueuer shares `future` (resolved after the single
    flush)."""

    __slots__ = ("future", "ops", "notifies")

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.future: asyncio.Future = loop.create_future()
        self.ops: list[tuple[int, str, bytes, bytes]] = []
        # Native backend only: puts applied (and notified) at commit time.
        self.notifies: list[tuple] = []


class StorageEngine:
    """One per node, holding every column family (the RocksDB instance
    analog). path=None runs purely in memory (tests)."""

    def __init__(
        self,
        path: str | None,
        use_native: bool | None = None,
        fsync: bool | None = None,
    ):
        self._path = path
        # Durability level of a WAL flush. Default (seed semantics):
        # flush() drains the userspace buffer to the OS — survives process
        # crash. fsync=True (or NARWHAL_WAL_FSYNC=1) adds os.fsync — survives
        # machine crash; ~1000x more expensive per call, which is exactly
        # the cost group commit amortizes (one fsync per fused group).
        if fsync is None:
            fsync = os.environ.get("NARWHAL_WAL_FSYNC", "0") == "1"
        self._fsync = fsync
        self._cfs: dict[str, "ColumnFamily"] = {}
        self._log = None
        self._cf_ids: dict[str, int] = {}
        self._dirty_bytes = 0
        self._append_count = 0
        self._native = None
        # Group-commit state: the open group, the committer draining it,
        # and the loop they belong to (a test's fresh loop must not await a
        # future created on a dead one).
        self._group: _CommitGroup | None = None
        self._commit_task: asyncio.Task | None = None
        self._commit_loop: asyncio.AbstractEventLoop | None = None
        # Serializes flush/compact across the loop thread and the
        # committer's executor thread (compact swaps the file object out
        # from under an in-flight flush otherwise).
        self._io_lock = threading.Lock()
        # Optional Prometheus instruments (attach_metrics).
        self._m_group_size = None
        self._m_flush_seconds = None
        if use_native is None:
            use_native = os.environ.get("NARWHAL_NATIVE", "1") != "0"
        if path is not None:
            os.makedirs(path, exist_ok=True)
        if use_native:
            try:
                from .native import NativeEngine

                self._native = NativeEngine(path)
            except (RuntimeError, OSError):
                self._native = None
        if self._native is not None:
            return
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._log_path = os.path.join(path, "wal.log")
            self._replay()
            self._log = open(self._log_path, "ab")

    def column_family(self, name: str) -> "ColumnFamily":
        cf = self._cfs.get(name)
        if cf is None:
            cf = ColumnFamily(name, self)
            self._cfs[name] = cf
            self._cf_ids.setdefault(name, len(self._cf_ids))
        return cf

    # -- WAL --------------------------------------------------------------
    def _replay(self) -> None:
        if not os.path.exists(self._log_path):
            return
        with open(self._log_path, "rb") as f:
            data = f.read()
        pos = 0
        valid_end = 0
        while pos + _HDR.size <= len(data):
            plen, crc = _HDR.unpack_from(data, pos)
            body_end = pos + _HDR.size + plen
            if body_end > len(data):
                break
            body = data[pos + _HDR.size : body_end]
            if zlib.crc32(body) != crc:
                break
            self._apply_record(body)
            pos = body_end
            valid_end = pos
        if valid_end < len(data):
            # torn tail: truncate so future appends start at a clean boundary
            with open(self._log_path, "ab") as f:
                f.truncate(valid_end)

    def _apply_record(self, body: bytes) -> None:
        pos = 0
        (count,) = struct.unpack_from("<I", body, pos)
        pos += 4
        for _ in range(count):
            op, name_len = struct.unpack_from("<BH", body, pos)
            pos += 3
            name = body[pos : pos + name_len].decode()
            pos += name_len
            (klen,) = struct.unpack_from("<I", body, pos)
            pos += 4
            key = body[pos : pos + klen]
            pos += klen
            cf = self.column_family(name)
            if op == 0:
                (vlen,) = struct.unpack_from("<I", body, pos)
                pos += 4
                value = body[pos : pos + vlen]
                pos += vlen
                cf._data[key] = value
            else:
                cf._data.pop(key, None)

    def _append(self, ops: list[tuple[int, str, bytes, bytes]]) -> None:
        if self._log is None:
            return
        self._append_body(self._encode_ops(ops))
        self._flush_log()

    def _append_body(self, body: bytes) -> None:
        """Buffered append of one record WITHOUT flushing (the flush is the
        syscall group commit amortizes)."""
        self._log.write(_HDR.pack(len(body), zlib.crc32(body)) + body)
        self._dirty_bytes += len(body)
        self._append_count += 1
        # Compaction check is amortized: only every 4096 appends, and only
        # once the log is large, do we pay for a live-size scan.
        if self._dirty_bytes > (64 << 20) and self._append_count % 4096 == 0:
            if self._dirty_bytes > 2 * self._live_size_estimate():
                self.compact()

    def _flush_log(self) -> None:
        """Flush the WAL buffer (plus fsync at the machine-crash durability
        level); safe from the committer's executor thread (compact() swaps
        the file object under the same lock)."""
        with self._io_lock:
            if self._log is not None:
                self._log.flush()
                if self._fsync:
                    os.fsync(self._log.fileno())

    # -- group commit ------------------------------------------------------
    def write_batch_async(
        self,
        puts: list[tuple["ColumnFamily", bytes, bytes]],
        deletes: list[tuple["ColumnFamily", bytes]] = (),
    ) -> asyncio.Future:
        """Group-commit variant of `write_batch`: enqueue the ops onto the
        current commit group and return the group's shared commit future
        (resolved once the fused WAL record is flushed — off the event
        loop). On the Python backend the memtable applies (and notify_read
        waiters fire) immediately, so readers never wait on durability; the
        native backend applies at commit. Requires a running event loop."""
        loop = asyncio.get_running_loop()
        puts = list(puts)
        deletes = list(deletes)
        if self._native is None:
            for cf, key, value in puts:
                cf._data[key] = value
            for cf, key in deletes:
                cf._data.pop(key, None)
            for cf, key, value in puts:
                cf._notify(key, value)
            if self._log is None:  # in-memory: trivially "durable"
                fut = loop.create_future()
                fut.set_result(None)
                return fut
        ops = [(0, cf.name, key, value) for cf, key, value in puts]
        ops += [(1, cf.name, key, b"") for cf, key in deletes]
        grp = self._group
        if grp is None or self._commit_loop is not loop:
            grp = self._group = _CommitGroup(loop)
        grp.ops.extend(ops)
        if self._native is not None:
            grp.notifies.extend(puts)
        if (
            self._commit_task is None
            or self._commit_task.done()
            or self._commit_loop is not loop
        ):
            self._commit_loop = loop
            self._commit_task = loop.create_task(self._run_committer())
        return grp.future

    async def _run_committer(self) -> None:
        """Drain commit groups one fused record + one flush at a time.
        While a flush runs in the executor the loop is free, so writes
        issued meanwhile pile into the NEXT group — coalescing deepens
        exactly when the WAL is busiest (group commit's core property)."""
        loop = asyncio.get_running_loop()
        while self._group is not None and self._group.ops:
            grp, self._group = self._group, None
            n_ops = len(grp.ops)
            t0 = time.perf_counter()
            try:
                if self._native is not None:
                    body = self._encode_ops(grp.ops)
                    # ctypes releases the GIL: append+flush runs truly off
                    # the loop.
                    await loop.run_in_executor(
                        None, self._native.write_batch, body
                    )
                    for cf, key, value in grp.notifies:
                        cf._notify(key, value)
                else:
                    # Encode+buffered-append on the loop (cheap memcpy,
                    # keeps WAL order loop-ordered); only the flush — the
                    # syscall — leaves the loop.
                    self._append_body(self._encode_ops(grp.ops))
                    await loop.run_in_executor(None, self._flush_log)
            except Exception as e:
                if not grp.future.done():
                    grp.future.set_exception(e)
                continue
            dt = time.perf_counter() - t0
            StorageStats.record_group(n_ops, dt)
            if self._m_group_size is not None:
                self._m_group_size.observe(n_ops)
                self._m_flush_seconds.observe(dt)
            if not grp.future.done():
                grp.future.set_result(None)

    def attach_metrics(self, registry) -> None:
        """Register the group-commit instruments on a node's registry
        (group size / WAL flush latency histograms)."""
        self._m_group_size = registry.histogram(
            "storage_commit_group_size",
            "ops per fused group-commit WAL record",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
        )
        self._m_flush_seconds = registry.histogram(
            "storage_wal_flush_seconds",
            "wall seconds per group-commit WAL flush",
        )

    def _live_size_estimate(self) -> int:
        return sum(
            sum(len(k) + len(v) for k, v in cf._data.items())
            for cf in self._cfs.values()
        )

    def compact(self) -> None:
        """Rewrite the WAL with only live entries."""
        if self._log is None:
            return
        tmp = self._log_path + ".tmp"
        with open(tmp, "wb") as f:
            for cf in self._cfs.values():
                for key, value in cf._data.items():
                    nb = cf.name.encode()
                    body = (
                        struct.pack("<I", 1)
                        + struct.pack("<BH", 0, len(nb))
                        + nb
                        + struct.pack("<I", len(key))
                        + key
                        + struct.pack("<I", len(value))
                        + value
                    )
                    f.write(_HDR.pack(len(body), zlib.crc32(body)) + body)
        with self._io_lock:  # an executor flush must not race the swap
            self._log.close()
            os.replace(tmp, self._log_path)
            self._log = open(self._log_path, "ab")
        self._dirty_bytes = self._live_size_estimate()

    @staticmethod
    def _encode_ops(ops: list[tuple[int, str, bytes, bytes]]) -> bytes:
        parts = [struct.pack("<I", len(ops))]
        for op, name, key, value in ops:
            nb = name.encode()
            parts.append(struct.pack("<BH", op, len(nb)))
            parts.append(nb)
            parts.append(struct.pack("<I", len(key)))
            parts.append(key)
            if op == 0:
                parts.append(struct.pack("<I", len(value)))
                parts.append(value)
        return b"".join(parts)

    def write_batch(self, puts: list[tuple["ColumnFamily", bytes, bytes]], deletes: list[tuple["ColumnFamily", bytes]] = ()) -> None:
        """Atomic multi-CF write (reference: rocksdb WriteBatch used by
        CertificateStore.write, storage/src/certificate_store.rs:55-120).
        Synchronous seed semantics: durable (appended + flushed) before
        returning. A pending commit group is persisted FIRST so the WAL
        record order always matches the memtable apply order."""
        self._drain_pending_group_sync()
        ops = [(0, cf.name, key, value) for cf, key, value in puts]
        ops += [(1, cf.name, key, b"") for cf, key in deletes]
        if self._native is not None:
            self._native.write_batch(self._encode_ops(ops))
        else:
            for cf, key, value in puts:
                cf._data[key] = value
            for cf, key in deletes:
                cf._data.pop(key, None)
            self._append(ops)
        for cf, key, value in puts:
            cf._notify(key, value)

    def _drain_pending_group_sync(self) -> None:
        """Persist + resolve the open commit group inline (loop-thread
        callers only — sync writes and close())."""
        grp, self._group = self._group, None
        if grp is None or not grp.ops:
            return
        if self._native is not None:
            self._native.write_batch(self._encode_ops(grp.ops))
            for cf, key, value in grp.notifies:
                cf._notify(key, value)
        elif self._log is not None:
            self._append_body(self._encode_ops(grp.ops))
            self._flush_log()
        StorageStats.record_group(len(grp.ops), 0.0)
        if self._m_group_size is not None:
            self._m_group_size.observe(len(grp.ops))
        if not grp.future.done():
            grp.future.set_result(None)

    def close(self) -> None:
        # A group still open at shutdown (already visible in the memtable)
        # must not silently lose its WAL record: persist it inline.
        self._drain_pending_group_sync()
        if self._commit_task is not None and not self._commit_task.done():
            self._commit_task.cancel()
        self._commit_task = None
        with self._io_lock:
            if self._log is not None:
                self._log.close()
                self._log = None
        if self._native is not None:
            self._native.close()
            self._native = None


class ColumnFamily:
    """Generic byte KV map with notify_read
    (typed-store Store<K,V> analog)."""

    def __init__(self, name: str, engine: StorageEngine):
        self.name = name
        self._engine = engine
        self._native = engine._native  # shared handle; None => dict backend
        self._nname = name.encode()
        self._data: dict[bytes, bytes] = {}
        self._waiters: dict[bytes, list[asyncio.Future]] = {}

    # -- sync ops ---------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        self._engine.write_batch([(self, key, value)])

    def put_all(self, items: Iterable[tuple[bytes, bytes]]) -> None:
        self._engine.write_batch([(self, k, v) for k, v in items])

    # -- group-commit (async) ops -----------------------------------------
    def put_async(self, key: bytes, value: bytes) -> asyncio.Future:
        """Enqueue onto the engine's commit group; returns the shared
        commit future (await it for durability — the memtable already sees
        the write on the Python backend)."""
        return self._engine.write_batch_async([(self, key, value)])

    def put_all_async(self, items: Iterable[tuple[bytes, bytes]]) -> asyncio.Future:
        return self._engine.write_batch_async([(self, k, v) for k, v in items])

    def get(self, key: bytes) -> bytes | None:
        if self._native is not None:
            return self._native.get(self._nname, key)
        return self._data.get(key)

    def get_all(self, keys: Iterable[bytes]) -> list[bytes | None]:
        return [self.get(k) for k in keys]

    def contains(self, key: bytes) -> bool:
        if self._native is not None:
            return self._native.contains(self._nname, key)
        return key in self._data

    def delete(self, key: bytes) -> None:
        self._engine.write_batch([], [(self, key)])

    def delete_all(self, keys: Iterable[bytes]) -> None:
        self._engine.write_batch([], [(self, k) for k in keys])

    def iter(self) -> Iterator[tuple[bytes, bytes]]:
        if self._native is not None:
            return iter(self._native.items(self._nname))
        return iter(list(self._data.items()))

    def keys(self) -> list[bytes]:
        if self._native is not None:
            return [k for k, _ in self._native.items(self._nname)]
        return list(self._data)

    def __len__(self) -> int:
        if self._native is not None:
            return self._native.len(self._nname)
        return len(self._data)

    # -- notify_read ------------------------------------------------------
    async def notify_read(self, key: bytes) -> bytes:
        """Return the value, blocking until someone writes it
        (storage/src/certificate_store.rs:138-160). Cancellation-safe: a
        cancelled waiter is pruned on the next notify."""
        val = self.get(key)
        if val is not None:
            return val
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(key, []).append(fut)
        try:
            return await fut
        finally:
            lst = self._waiters.get(key)
            if lst is not None:
                try:
                    lst.remove(fut)
                except ValueError:
                    pass
                if not lst:
                    # Register/await/cleanup idiom: each waiter removes
                    # only its own future, and the empty-list pop re-checks
                    # the CURRENT list after the await — a waiter that
                    # registered at the yield point repopulates the key.
                    self._waiters.pop(key, None)  # lint: allow(await-interleaved-rmw)

    def _notify(self, key: bytes, value: bytes) -> None:
        for fut in self._waiters.pop(key, []):
            if not fut.done():
                fut.set_result(value)
