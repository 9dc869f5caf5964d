"""The port's durable storage and stores against the JAX package's.

`narwhal_tpu_torch.storage` (the WAL, group commit, `compact`, the native
engine branch) and `narwhal_tpu_torch.stores` are copies of the JAX
package's modules. Here, on the Python WAL (`use_native=False`) and on the
native C++ engine (the port's own build):

- one seeded sequence of puts, deletes, `write_batch`es, async group
  commits and compactions leaves every column family equal in both
  packages after a reopen;
- each package opens the other's directory, on either backend, and a run
  of synchronous writes leaves byte-identical logs;
- a log cut at every byte of its last record (a fused group) reopens to
  the state before that record, in both packages, on both backends;
- each store of `NodeStorage(path)` round-trips across a reopen with the
  same record in both packages.
"""

import asyncio
import random
import shutil
import struct
from types import SimpleNamespace

import pytest

import narwhal_tpu.fixtures as j_fixtures
import narwhal_tpu.storage as j_storage
import narwhal_tpu.stores as j_stores
import narwhal_tpu.types as j_types
import narwhal_tpu_torch.fixtures as t_fixtures
import narwhal_tpu_torch.storage as t_storage
import narwhal_tpu_torch.stores as t_stores
import narwhal_tpu_torch.types as t_types

JAX = SimpleNamespace(name="jax", storage=j_storage, stores=j_stores, types=j_types,
                      fixtures=j_fixtures)
PORT = SimpleNamespace(name="port", storage=t_storage, stores=t_stores, types=t_types,
                       fixtures=t_fixtures)
PACKAGES = {"jax": JAX, "port": PORT}
BACKENDS = {"wal": False, "native": True}
CFS = ("alpha", "beta", "certificates", "sequence")


def engine(m, path, backend):
    e = m.storage.StorageEngine(str(path), use_native=BACKENDS[backend])
    if m is PORT:
        assert (e._native is not None) == BACKENDS[backend]
    return e


def dump(e) -> dict:
    return {name: sorted(e.column_family(name).iter()) for name in CFS}


def compact(e) -> None:
    if e._native is not None:
        e._native.compact()
    else:
        e.compact()


async def seeded_ops(m, path, backend, seed, n_ops=400):
    """A seeded mix of every write the engine takes, group commits left in
    flight across later sync writes and compactions. Returns the live
    state before close."""
    e = engine(m, path, backend)
    rng = random.Random(seed)
    cfs = [e.column_family(name) for name in CFS]
    keys = [bytes([i]) * (1 + i % 5) for i in range(32)]

    def pick():
        return rng.choice(cfs), rng.choice(keys)

    futs = []
    for _ in range(n_ops):
        op = rng.random()
        cf, key = pick()
        if op < 0.25:
            cf.put(key, rng.randbytes(rng.randrange(0, 120)))
        elif op < 0.32:
            cf.delete(key)
        elif op < 0.42:
            e.write_batch([(*pick(), rng.randbytes(8)) for _ in range(3)], [pick()])
        elif op < 0.72:
            puts = [(*pick(), rng.randbytes(rng.randrange(1, 40)))
                    for _ in range(rng.randrange(1, 5))]
            futs.append(e.write_batch_async(puts, [pick()] if op < 0.5 else []))
        elif op < 0.82:
            await asyncio.gather(*futs)
            futs = []
        elif op < 0.85:
            compact(e)
        elif op < 0.93:
            cf.put_all((rng.choice(keys), rng.randbytes(4)) for _ in range(3))
        else:
            cf.delete_all(rng.sample(keys, 3))
        if rng.random() < 0.1:
            await asyncio.sleep(0)
    await asyncio.gather(*futs)
    state = dump(e)
    e.close()
    return state


@pytest.mark.parametrize("backend", BACKENDS)
def test_seeded_ops_leave_equal_column_families(tmp_path, backend):
    states = {}
    for m in (JAX, PORT):
        path = tmp_path / m.name
        live = asyncio.run(seeded_ops(m, path, backend, seed=11))
        reopened = engine(m, path, backend)
        states[m.name] = dump(reopened)
        reopened.close()
        assert states[m.name] == live
    assert states["port"] == states["jax"]
    assert sum(len(v) for v in states["port"].values()) > 40


def sync_writes(e) -> None:
    a, b = e.column_family("alpha"), e.column_family("beta")
    a.put(b"k1", b"v1")
    a.put_all([(b"k2", b"v2"), (b"k3", b"v3")])
    b.put(b"x", b"y" * 1000)
    e.write_batch([(a, b"k4", b""), (b, b"z", b"zz")], [(a, b"k2")])
    a.delete(b"k1")
    b.delete_all([b"missing", b"z"])


@pytest.mark.parametrize("reader_backend", BACKENDS)
@pytest.mark.parametrize("writer_backend", BACKENDS)
@pytest.mark.parametrize("writer", PACKAGES)
def test_each_package_reads_the_others_directory(tmp_path, writer, writer_backend,
                                                 reader_backend):
    w = PACKAGES[writer]
    r = PORT if w is JAX else JAX
    path = tmp_path / "db"
    e = engine(w, path, writer_backend)
    sync_writes(e)
    want = dump(e)
    e.close()
    wal = (path / "wal.log").read_bytes()
    e = engine(r, path, reader_backend)
    assert dump(e) == want
    e.close()
    # The same synchronous writes through the other package and backend
    # leave the same bytes.
    other = tmp_path / "other"
    e = engine(r, other, reader_backend)
    sync_writes(e)
    e.close()
    assert (other / "wal.log").read_bytes() == wal


def records(data: bytes) -> list[tuple[int, int]]:
    pos, bounds = 0, []
    while pos + 8 <= len(data):
        (plen,) = struct.unpack_from("<I", data, pos)
        bounds.append((pos, pos + 8 + plen))
        pos += 8 + plen
    return bounds


def test_torn_tail_cut_at_every_byte(tmp_path):
    """A log whose last record is a fused group of 6 puts, cut at every
    byte of that record (and once with a flipped body byte): both packages,
    on both backends, reopen to the state before the record, and the WAL
    engine truncates the file to the last whole record."""
    src = tmp_path / "src"

    async def write():
        e = engine(PORT, src, "wal")
        cf = e.column_family("alpha")
        cf.put(b"base", b"ok")
        e.column_family("beta").put(b"other", b"x" * 5)
        await asyncio.gather(*[cf.put_async(b"grp%d" % i, b"v" * 12) for i in range(6)])
        e.close()

    asyncio.run(write())
    data = (src / "wal.log").read_bytes()
    bounds = records(data)
    assert len(bounds) == 3
    start, end = bounds[-1]
    assert end == len(data) and end - start > 6 * 12
    before = {"alpha": [(b"base", b"ok")], "beta": [(b"other", b"xxxxx")],
              "certificates": [], "sequence": []}
    flipped = bytearray(data)
    flipped[start + 20] ^= 0x40
    cuts = [data[:n] for n in range(start, end)] + [bytes(flipped)]
    for i, torn in enumerate(cuts):
        for m in (JAX, PORT):
            for backend in BACKENDS:
                path = tmp_path / f"c{i}-{m.name}-{backend}"
                path.mkdir()
                (path / "wal.log").write_bytes(torn)
                e = engine(m, path, backend)
                assert dump(e) == before, (i, m.name, backend)
                e.close()
                if backend == "wal":
                    assert (path / "wal.log").read_bytes() == data[:start]
                shutil.rmtree(path)


def certificates(m, rounds=4):
    f = m.fixtures.CommitteeFixture(size=4)
    genesis = {c.digest for c in m.types.Certificate.genesis(f.committee)}
    certs, _ = m.fixtures.make_certificates(f.committee, 1, rounds, genesis,
                                            failure_probability=0.2, rng=random.Random(4))
    return f, certs


async def store_scenario(m, path, backend, store):
    """Write through one store of NodeStorage(path) (sync and group-commit
    writes, a notify_read woken by a later write), reopen, read back, and
    record what each read returns (objects as their bytes)."""
    f, certs = certificates(m)
    env = {"NARWHAL_NATIVE": "1" if BACKENDS[backend] else "0"}
    trace = []
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        ns = m.stores.NodeStorage(str(path))
        assert (ns.engine._native is not None) == BACKENDS[backend]
        digests = [c.digest for c in certs]
        if store == "certificate":
            s = ns.certificate_store
            waiter = asyncio.ensure_future(s.notify_read(digests[-1]))
            await asyncio.sleep(0)
            s.write(certs[0])
            s.write_all(certs[1:4])
            await s.write_async(certs[4])
            await s.write_all_async(certs[5:])
            trace.append((await asyncio.wait_for(waiter, 10)).to_bytes())
            s.delete(digests[2])
            s.delete_all(digests[6:8])
        elif store == "header":
            s = ns.header_store
            waiter = asyncio.ensure_future(s.notify_read(certs[3].header.digest))
            await asyncio.sleep(0)
            s.write(certs[0].header)
            for c in certs[1:4]:
                await s.write_async(c.header)
            trace.append((await asyncio.wait_for(waiter, 10)).to_bytes())
            s.delete_all([certs[1].header.digest])
        elif store == "payload":
            s = ns.payload_store
            waiter = asyncio.ensure_future(s.notify_contains(digests[5], 1))
            await asyncio.sleep(0)
            s.write(digests[0], 0)
            await s.write_async(digests[1], 3)
            await s.write_all_async([(d, i % 2) for i, d in enumerate(digests[2:6])])
            trace.append(await asyncio.wait_for(waiter, 10))
            s.delete_all([(digests[2], 0)])
        elif store == "batch":
            s = ns.batch_store
            waiter = asyncio.ensure_future(s.notify_read(digests[3]))
            await asyncio.sleep(0)
            for i, d in enumerate(digests[:4]):
                s.write(d, bytes([i]) * (i * 10))
            ns.temp_batch_store.write(digests[0], b"temp")
            trace.append(await asyncio.wait_for(waiter, 10))
            s.delete_all([digests[1]])
        elif store == "vote":
            s = ns.vote_digest_store
            s.write(certs[0].origin, 3, digests[0])
            await s.write_async(certs[1].origin, 5, digests[1])
            s.write(certs[0].origin, 4, digests[2])
        else:
            s = ns.consensus_store
            for i, c in enumerate(certs[:6]):
                s.write_consensus_state({c.origin: c.round, certs[0].origin: 1}, i, c.digest)
        ns.close()

        ns = m.stores.NodeStorage(str(path))
        if store == "certificate":
            s = ns.certificate_store
            trace += [[c and c.to_bytes() for c in s.read_all(digests)],
                      [s.contains(d) for d in digests], len(s),
                      [c.digest for c in s.after_round(2)], s.last_round(),
                      s.last_round(certs[0].origin)]
        elif store == "header":
            s = ns.header_store
            trace += [[h and h.to_bytes() for h in (s.read(c.header.digest) for c in certs[:5])]]
        elif store == "payload":
            s = ns.payload_store
            trace += [[s.contains(d, w) for d in digests[:7] for w in (0, 1, 3)]]
        elif store == "batch":
            s = ns.batch_store
            trace += [s.read_all(digests[:5]), [s.contains(d) for d in digests[:5]], len(s),
                      ns.temp_batch_store.read(digests[0]), s.read(digests[3])]
        elif store == "vote":
            s = ns.vote_digest_store
            trace += [s.read(c.origin) for c in certs[:3]]
            s.clear()
            trace += [s.read(c.origin) for c in certs[:3]]
        else:
            s = ns.consensus_store
            trace += [s.read_last_committed(), s.last_consensus_index(),
                      s.read_sequenced_digests_after(0), s.read_sequenced_digests_after(4)]
        ns.close()
    return trace


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("store", ["certificate", "header", "payload", "batch", "vote",
                                   "consensus"])
def test_store_round_trip_across_reopen(tmp_path, store, backend):
    got = asyncio.run(store_scenario(PORT, tmp_path / "port", backend, store))
    want = asyncio.run(store_scenario(JAX, tmp_path / "jax", backend, store))
    assert got == want
    assert any(x not in (None, [], 0) for x in got)


def test_node_storage_opens_every_store_on_one_engine(tmp_path):
    ns = t_stores.NodeStorage(str(tmp_path))
    stores = (ns.vote_digest_store, ns.header_store, ns.certificate_store, ns.payload_store,
              ns.batch_store, ns.temp_batch_store, ns.consensus_store)
    assert [type(s).__name__ for s in stores] == [
        "VoteDigestStore", "HeaderStore", "CertificateStore", "PayloadStore", "BatchStore",
        "BatchStore", "ConsensusStore"]
    names = set(ns.engine._cfs)
    ns.close()
    assert names == {"votes", "headers", "certificates", "certificate_id_by_round",
                     "payload", "batches", "temp_batches", "last_committed", "sequence"}
    assert names == set(j_stores.NodeStorage(None).engine._cfs)


def test_group_commit_across_event_loops(tmp_path):
    """Each asyncio.run gets a fresh loop: a group commit on the second loop
    must not await the first loop's committer, on either backend, and a
    group left open at close is persisted."""
    for backend in BACKENDS:
        path = tmp_path / backend

        async def commit(e, key):
            await e.column_family("alpha").put_async(key, b"v")

        e = engine(PORT, path, backend)
        asyncio.run(commit(e, b"first"))
        asyncio.run(asyncio.wait_for(commit(e, b"second"), 10))

        async def leave_open():
            e.column_family("alpha").put_async(b"open", b"v")

        asyncio.run(leave_open())
        e.close()
        e = engine(PORT, path, backend)
        assert dump(e)["alpha"] == [(b"first", b"v"), (b"open", b"v"), (b"second", b"v")]
        e.close()
