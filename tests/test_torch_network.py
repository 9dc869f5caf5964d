"""The port's `network/` against the JAX package's.

- The JAX package's own network, authentication and pool scenarios
  (`tests/test_network.py`, `test_auth.py`, `test_pool.py`) run against the
  port: each module's source with the package name swapped, executed as a
  module of its own. The escalation scenario is left out there (it times
  a slow handler); `test_deadline_miss_*` below holds the escalation without
  depending on how fast the host is.
- Interop both ways, authenticated, on both AEAD branches (AES-GCM with
  OpenSSL, the blake2b AEAD and pure-Python X25519 without): a port
  `NetworkClient` against a JAX `RpcServer` and the reverse.
- The frame header, the handshake domains and a sealed frame are the same
  bytes in both packages, and a tampered frame raises `AuthError` across
  them.
"""

import asyncio
import os
import re
import types
from pathlib import Path

import pytest

import narwhal_tpu.crypto as j_crypto
import narwhal_tpu.messages as j_messages
import narwhal_tpu.network as j_network
import narwhal_tpu.network.auth as j_auth
import narwhal_tpu.network.rpc as j_rpc
import narwhal_tpu_torch.crypto as t_crypto
import narwhal_tpu_torch.messages as t_messages
import narwhal_tpu_torch.network as t_network
import narwhal_tpu_torch.network.auth as t_auth
import narwhal_tpu_torch.network.rpc as t_rpc

TESTS = Path(__file__).resolve().parent

# The JAX package's escalation scenario waits on a slow handler's timing;
# the port's is test_deadline_miss_escalates_and_keeps_the_connection.
TIMED = {"test_reliable_send_escalates_deadline_for_slow_peer"}


def port_scenarios(filename: str, leave_out=frozenset(), subs=(), classes=False) -> dict:
    """The test functions of the JAX package's `tests/<filename>`, run
    against the port: the source with `narwhal_tpu` renamed to
    `narwhal_tpu_torch` (and its device plane `narwhal_tpu.tpu` to the
    port's `narwhal_tpu_torch.gpu`), then each `(pattern, replacement)` of
    `subs` applied, executed as a module of its own. With `classes`, its
    `Test*` classes too."""
    src = (TESTS / filename).read_text()
    src = re.sub(r"\bnarwhal_tpu\.tpu\b", "narwhal_tpu_torch.gpu", src)
    src = re.sub(r"\bnarwhal_tpu\b", "narwhal_tpu_torch", src)
    for pattern, replacement in subs:
        src, n = re.subn(pattern, replacement, src)
        assert n, f"{filename}: {pattern!r} matches nothing"
    mod = types.ModuleType(f"port_{Path(filename).stem}")
    mod.__file__ = str(TESTS / filename)
    exec(compile(src, f"{filename} (against narwhal_tpu_torch)", "exec"), mod.__dict__)
    return {
        name: fn for name, fn in vars(mod).items()
        if callable(fn) and name not in leave_out
        and (name.startswith("test_") or classes and name.startswith("Test")
             and isinstance(fn, type))
    }


def set_defaults(monkeypatch, classes, **values) -> None:
    """The given keyword defaults of each class's `__init__`, the rest as
    they are."""
    import inspect

    for cls in classes:
        init = cls.__init__
        named = [p.name for p in inspect.signature(init).parameters.values()
                 if p.default is not p.empty][-len(init.__defaults__):]
        monkeypatch.setattr(init, "__defaults__", tuple(
            values.get(name, default) for name, default in zip(named, init.__defaults__)))


@pytest.fixture
def host_backends(monkeypatch):
    """The JAX node's backend defaults (`cpu`) for the port's Cluster and
    PrimaryNode (and so NodeRestarter's nodes), whose defaults are the
    card's (`cuda`): the renamed scenarios that name no backend run on the
    host, as they do in the JAX package."""
    from narwhal_tpu_torch import cluster, node

    set_defaults(monkeypatch, (cluster.Cluster, node.PrimaryNode),
                 crypto_backend="cpu", dag_backend="cpu")


_SCENARIOS = {}
for _file in ("test_network.py", "test_auth.py", "test_pool.py"):
    for _name, _fn in port_scenarios(_file, TIMED).items():
        assert _name not in _SCENARIOS and _name not in globals(), _name
        _SCENARIOS[_name] = _fn
globals().update(_SCENARIOS)


PKGS = {
    "port": types.SimpleNamespace(crypto=t_crypto, messages=t_messages, network=t_network,
                                  auth=t_auth, rpc=t_rpc),
    "jax": types.SimpleNamespace(crypto=j_crypto, messages=j_messages, network=j_network,
                                 auth=j_auth, rpc=j_rpc),
}


def force_hash_branch(monkeypatch) -> None:
    """Both packages on the branch a host without `cryptography` takes:
    pure-Python X25519 and the blake2b AEAD."""
    for auth in (t_auth, j_auth):
        monkeypatch.setattr(auth, "_HAVE_OPENSSL", False)
        monkeypatch.setattr(auth, "X25519PrivateKey", auth._RefX25519PrivateKey)
        monkeypatch.setattr(auth, "X25519PublicKey", auth._RefX25519PublicKey)


@pytest.fixture(params=["openssl", "hash"])
def aead(request, monkeypatch):
    if request.param == "openssl":
        if not (t_auth._HAVE_OPENSSL and j_auth._HAVE_OPENSSL):
            pytest.skip("the OpenSSL branch needs the cryptography package")
    else:
        force_hash_branch(monkeypatch)
    return request.param


def test_all_reference_scenarios_collected():
    assert len(_SCENARIOS) >= 25, sorted(_SCENARIOS)
    ref = set()
    for file in ("test_network.py", "test_auth.py", "test_pool.py"):
        ref |= set(re.findall(r"^def (test_\w+)", (TESTS / file).read_text(), re.M))
    assert set(_SCENARIOS) == ref - TIMED


def test_frame_layout_and_handshake_constants_match():
    for name in ("KIND_REQ", "KIND_RESP", "KIND_ERR", "KIND_ONEWAY", "MAX_FRAME",
                 "LANE_PRIMARY", "LANE_UNAVAILABLE", "POOL_HELLO"):
        assert getattr(t_rpc, name) == getattr(j_rpc, name), name
    assert t_rpc._FRAME_HDR.format == j_rpc._FRAME_HDR.format
    for name in ("KIND_HELLO", "KIND_AUTH", "KIND_AUTH_OK", "MAC_LEN", "_CLIENT_DOMAIN",
                 "_SERVER_DOMAIN", "HS_TIMEOUT"):
        assert getattr(t_auth, name) == getattr(j_auth, name), name
    assert t_rpc.worker_lane(3) == j_rpc.worker_lane(3)


class _Sink:
    def __init__(self):
        self.parts = []

    def write(self, data: bytes) -> None:
        self.parts.append(data)


def _frame(rpc, session, body: bytes, lane: int = 2) -> bytes:
    sink = _Sink()
    rpc._write_frame(sink, rpc.KIND_REQ, 7, 41, body, session, None, lane)
    return b"".join(sink.parts)


async def _read(rpc, session, data: bytes):
    reader = asyncio.StreamReader()
    reader.feed_data(data)
    reader.feed_eof()
    return await rpc._read_frame(reader, session)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_sealed_frames_are_the_same_bytes_and_tampering_raises(run, aead, writer, reader):
    w, r = PKGS[writer], PKGS[reader]
    k1, k2 = os.urandom(32), os.urandom(32)
    body = os.urandom(3000)
    # The same keys seal the same bytes in both packages.
    assert _frame(w.rpc, w.auth.Session(k1, k2), body) == _frame(
        r.rpc, r.auth.Session(k1, k2), body)
    assert _frame(w.rpc, None, body) == _frame(r.rpc, None, body)

    sealed = _frame(w.rpc, w.auth.Session(k1, k2), body)
    got = run(_read(r.rpc, r.auth.Session(k2, k1), sealed))
    assert got == (r.rpc.KIND_REQ, 7, 41, 2, body)
    hdr = r.rpc._FRAME_HDR.size
    for at in (hdr + 5, len(sealed) - 1):  # the body, the tag
        bad = bytearray(sealed)
        bad[at] ^= 0x01
        with pytest.raises(r.auth.AuthError):
            run(_read(r.rpc, r.auth.Session(k2, k1), bytes(bad)))
    # The lane byte is associated data: moving the frame to another lane fails.
    bad = bytearray(sealed)
    bad[hdr - 1] ^= 0x01
    with pytest.raises(r.auth.AuthError):
        run(_read(r.rpc, r.auth.Session(k2, k1), bytes(bad)))


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_authenticated_interop(run, aead, client, server):
    """A client of one package against an authenticated server of the other:
    typed request/response, reliable send, a oneway frame; the handler sees
    the client's verified key, and a key outside the allow-set is refused
    before any handler runs."""
    C, S = PKGS[client], PKGS[server]
    server_kp = S.crypto.KeyPair.from_seed(b"interop-server".ljust(32, b"\0"))
    client_kp = C.crypto.KeyPair.from_seed(b"interop-client".ljust(32, b"\0"))
    rogue_kp = C.crypto.KeyPair.from_seed(b"interop-rogue".ljust(32, b"\0"))
    digests = (b"\x11" * 32, b"\x22" * 32)

    async def scenario():
        seen = []
        srv = S.network.RpcServer(auth_keypair=server_kp, counters=S.network.WireCounters())
        allow = lambda peer: peer.key == client_kp.public  # noqa: E731

        async def on_request(msg, peer):
            seen.append(("request", msg.digests, peer.key))
            return S.messages.WorkerBatchResponse(tuple(d * 2 for d in msg.digests))

        async def on_batch(msg, peer):
            seen.append(("batch", msg.serialized_batch, peer.key))

        srv.route(S.messages.WorkerBatchRequest, on_request, allow=allow)
        srv.route(S.messages.WorkerBatchMsg, on_batch, allow=allow)
        port = await srv.start("127.0.0.1", 0)
        addr = f"127.0.0.1:{port}"

        def client_of(kp):
            resolve = lambda a: server_kp.public if a == addr else None  # noqa: E731
            return C.network.NetworkClient(
                credentials=C.network.Credentials(kp, resolve),
                counters=C.network.WireCounters())

        net, rogue = client_of(client_kp), client_of(rogue_kp)
        try:
            resp = await net.request(addr, C.messages.WorkerBatchRequest(digests), timeout=10.0)
            assert type(resp).__name__ == "WorkerBatchResponse"
            assert resp.batches == tuple(d * 2 for d in digests)
            assert await asyncio.wait_for(
                net.send(addr, C.messages.WorkerBatchMsg(b"reliable")).task, 10.0)
            assert await net.oneway_send(addr, C.messages.WorkerBatchMsg(b"oneway"))
            assert not await rogue.unreliable_send(
                addr, C.messages.WorkerBatchMsg(b"rogue"), timeout=10.0)
            with pytest.raises(C.network.RpcError, match="unauthorized"):
                await rogue.request(addr, C.messages.WorkerBatchRequest(digests), timeout=10.0)
            for _ in range(200):
                if len(seen) == 3:
                    break
                await asyncio.sleep(0.01)
        finally:
            net.close()
            rogue.close()
            await srv.stop()
        assert seen == [("request", digests, client_kp.public),
                        ("batch", b"reliable", client_kp.public),
                        ("batch", b"oneway", client_kp.public)]
        assert net._counters.frames_sent == 3 and srv._counters.frames_received >= 3

    run(scenario())


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_wrong_server_identity_refused_across_packages(run, aead, client, server):
    C, S = PKGS[client], PKGS[server]
    server_kp = S.crypto.KeyPair.from_seed(b"imposter".ljust(32, b"\0"))
    expected = C.crypto.KeyPair.from_seed(b"the-real-one".ljust(32, b"\0")).public
    client_kp = C.crypto.KeyPair.from_seed(b"interop-client".ljust(32, b"\0"))

    async def scenario():
        srv = S.network.RpcServer(auth_keypair=server_kp)
        srv.route(S.messages.WorkerBatchMsg, lambda m, p: None, allow=lambda p: True)
        port = await srv.start("127.0.0.1", 0)
        net = C.network.NetworkClient(
            credentials=C.network.Credentials(client_kp, lambda a: expected))
        try:
            with pytest.raises(C.network.RpcError, match="handshake"):
                await net.request(f"127.0.0.1:{port}", C.messages.WorkerBatchMsg(b"x"),
                                  timeout=10.0)
        finally:
            net.close()
            await srv.stop()

    run(scenario())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_deadline_miss_escalates_and_keeps_the_connection(run, pkg):
    """A handler that never answers its first two calls: each of those
    attempts misses its deadline whatever the host's speed. The port raises
    RpcTimeout, keeps the connection and doubles the next attempt's
    deadline (RpcTimeout's contract). The JAX package, on Python 3.11 and
    later, catches the deadline miss as an OSError (asyncio.TimeoutError is
    the builtin TimeoutError there), raises a plain RpcError, tears the
    connection down and never escalates: the cause of its red
    test_reliable_send_escalates_deadline_for_slow_peer."""
    P = PKGS[pkg]

    async def scenario():
        calls, never = 0, asyncio.Event()

        async def handler(msg, peer):
            nonlocal calls
            calls += 1
            if calls <= 2:
                await never.wait()

        srv = P.network.RpcServer()
        srv.route(P.messages.WorkerBatchMsg, handler)
        port = await srv.start("127.0.0.1", 0)
        addr = f"127.0.0.1:{port}"
        net = P.network.NetworkClient(P.network.RetryConfig(initial=0.001, max_elapsed=None,
                                                            jitter=0))
        peer = net.peer(addr)
        attempts, real = [], peer.request

        async def recorded(msg, timeout):
            try:
                await real(msg, timeout)
            except Exception as e:
                attempts.append((timeout, type(e).__name__, peer._writer is not None))
                raise
            attempts.append((timeout, "ok", peer._writer is not None))

        peer.request = recorded
        try:
            assert await asyncio.wait_for(
                net.send(addr, P.messages.WorkerBatchMsg(b"x"), timeout=0.5).task, 30.0)
        finally:
            never.set()
            net.close()
            await srv.stop()
        return attempts, calls

    attempts, calls = run(scenario(), timeout=60.0)
    if pkg == "port":
        assert attempts == [(0.5, "RpcTimeout", True), (1.0, "RpcTimeout", True),
                            (2.0, "ok", True)]
        assert calls == 3
    else:
        # Every miss a torn-down connection and a plain RpcError, at the
        # configured deadline: no escalation.
        assert [a[:1] for a in attempts] == [(0.5,)] * len(attempts)
        assert attempts[0][1:] == ("RpcError", False)
        assert attempts[-1][1] == "ok" and len(attempts) >= 3
