"""Mutual transport authentication for the validator mesh.

Port copy of `narwhal_tpu/network/auth.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: the anemo network gives every peer an ed25519 identity — a
`PeerId` derived from its network key — and mutually-authenticated TLS
(narwhal/network/src/p2p.rs:26-158; worker keys registered as known
peers at narwhal/worker/src/worker.rs:137-146). Connections from
unknown identities never reach the validator-internal RPC handlers, and all
post-handshake traffic is protected by the TLS channel.

Here the same guarantee comes from a signed authenticated key exchange plus
per-frame AEAD:

1. The server opens with a nonce, its network key and an ephemeral X25519
   public key; the client answers with its network key, a nonce, its own
   ephemeral key and an ed25519 signature over the whole transcript; the
   server signs the transcript back. Both signatures bind the ephemeral
   keys to the committee identities (config.Authority.network_key for
   primaries, WorkerInfo.name for workers), so a relay cannot substitute
   its own ephemerals.
2. X25519(eph, eph') gives a shared secret only the two endpoints know;
   per-direction AES-256-GCM keys are derived from it and the transcript,
   and every subsequent frame body is encrypted and authenticated with a
   counter nonce and the frame header as associated data. An on-path
   attacker can therefore neither read, inject, replay nor reorder frames
   after the handshake.

Routes attach `allow` predicates on the verified identity (control-plane
frames accept only the node's own primary, etc. — the authorization matrix
lives in worker.py / primary.py). Public edges (tx ingest, the consensus
API) stay unauthenticated, exactly like the reference's tonic gRPC plane.

"""

from __future__ import annotations

import asyncio
import hashlib
import os
from dataclasses import dataclass
from typing import Callable, Optional

try:
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives import serialization as _ser

    _HAVE_OPENSSL = True
except ImportError:  # pragma: no cover - exercised only without OpenSSL
    _HAVE_OPENSSL = False
    _ser = None

from ..crypto import KeyPair, verify
from ..types import PublicKey

HS_TIMEOUT = 5.0
MAC_LEN = 16  # AES-GCM authentication tag appended to every sealed body
# v5: the frame header grew a lane byte (rpc._FRAME_HDR) which is part of
# the AEAD associated data — both ends must speak the same header layout.
_CLIENT_DOMAIN = b"narwhal-hs-client-v5"
_SERVER_DOMAIN = b"narwhal-hs-server-v5"

# Handshake frame kinds (share the RPC frame header; rid/tag are zero).
KIND_HELLO = 3  # server -> client: nonce_s(32) | server_pub(32) | server_eph(32)
KIND_AUTH = 4  # client -> client_pub(32) | nonce_c(32) | client_eph(32) | sig(64)
KIND_AUTH_OK = 5  # server -> client: sig(64)


class AuthError(Exception):
    pass


# -- no-OpenSSL fallbacks ----------------------------------------------------
#
# Containers without the `cryptography` bindings still need the mesh to
# authenticate: X25519 is the RFC 7748 montgomery ladder over Python ints
# (handshake-only, two scalarmults per connection), and the per-frame AEAD is
# a keyed-blake2b keystream XOR with an encrypt-then-MAC 16-byte tag — the
# same seal/open framing as AES-GCM, used symmetrically by both endpoints of
# an in-process mesh, so the wire stays self-consistent. Both sides must run
# the same build; that is always true for the single-container clusters this
# fallback exists for.

_X_P = 2**255 - 19


def _x25519_scalarmult(k_bytes: bytes, u_bytes: bytes) -> bytes:
    k = int.from_bytes(k_bytes, "little")
    k &= (1 << 254) - 8
    k |= 1 << 254
    u = int.from_bytes(u_bytes, "little") & ((1 << 255) - 1)
    x1, x2, z2, x3, z3, swap = u, 1, 0, u, 1, 0
    for t in reversed(range(255)):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        A = (x2 + z2) % _X_P
        AA = A * A % _X_P
        B = (x2 - z2) % _X_P
        BB = B * B % _X_P
        E = (AA - BB) % _X_P
        C = (x3 + z3) % _X_P
        Dm = (x3 - z3) % _X_P
        DA = Dm * A % _X_P
        CB = C * B % _X_P
        x3 = (DA + CB) % _X_P
        x3 = x3 * x3 % _X_P
        z3 = (DA - CB) % _X_P
        z3 = z3 * z3 % _X_P * x1 % _X_P
        x2 = AA * BB % _X_P
        z2 = E * ((AA + 121665 * E) % _X_P) % _X_P
    if swap:
        x2, z2 = x3, z3
    return (x2 * pow(z2, _X_P - 2, _X_P) % _X_P).to_bytes(32, "little")


class _RefX25519PublicKey:
    __slots__ = ("_raw",)

    def __init__(self, raw: bytes):
        self._raw = raw

    @staticmethod
    def from_public_bytes(raw: bytes) -> "_RefX25519PublicKey":
        return _RefX25519PublicKey(raw)


class _RefX25519PrivateKey:
    __slots__ = ("_k", "_pub")

    def __init__(self, k: bytes):
        self._k = k
        self._pub = _x25519_scalarmult(k, (9).to_bytes(32, "little"))

    @staticmethod
    def generate() -> "_RefX25519PrivateKey":
        # Draw through the module entropy seam (resolved at call time, so
        # set_entropy() installed later still governs): when the reference
        # backend is aliased as X25519PrivateKey, seeded scenarios must get
        # deterministic ephemeral keys here too.
        return _RefX25519PrivateKey(_entropy(32))

    def public_key(self) -> _RefX25519PublicKey:
        return _RefX25519PublicKey(self._pub)

    def exchange(self, peer: _RefX25519PublicKey) -> bytes:
        return _x25519_scalarmult(self._k, peer._raw)


class _HashAEAD:
    """Encrypt-then-MAC AEAD on keyed blake2b: CTR keystream XOR for
    confidentiality, 16-byte keyed tag over (nonce, aad, ciphertext) for
    integrity. Interface-compatible with AESGCM's encrypt/decrypt.

    The bytes are the JAX package's, computed faster: the keystream's
    blocks are joined once and XORed as two integers, not byte by byte in
    Python."""

    __slots__ = ("_key",)

    def __init__(self, key: bytes):
        self._key = key

    def _stream(self, nonce: bytes, n: int) -> bytes:
        # blake2b(key, nonce || ctr) per 64-byte block; the keyed state
        # after the nonce is built once and copied for each block.
        base = hashlib.blake2b(key=self._key, digest_size=64)
        base.update(nonce)
        blocks = []
        for ctr in range(-(-n // 64)):
            h = base.copy()
            h.update(ctr.to_bytes(8, "little"))
            blocks.append(h.digest())
        return b"".join(blocks)[:n]

    def _xor(self, nonce: bytes, data: bytes) -> bytes:
        n = len(data)
        stream = int.from_bytes(self._stream(nonce, n), "little")
        return (int.from_bytes(data, "little") ^ stream).to_bytes(n, "little")

    def _tag(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
        return hashlib.blake2b(
            len(aad).to_bytes(8, "little") + aad + nonce + ct,
            key=self._key,
            digest_size=MAC_LEN,
        ).digest()

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
        ct = self._xor(nonce, data)
        return ct + self._tag(nonce, aad, ct)

    def decrypt(self, nonce: bytes, ct_tag: bytes, aad: bytes) -> bytes:
        import hmac as _hmac

        if len(ct_tag) < MAC_LEN:
            raise AuthError("sealed frame shorter than its tag")
        ct, tag = ct_tag[:-MAC_LEN], ct_tag[-MAC_LEN:]
        if not _hmac.compare_digest(tag, self._tag(nonce, aad, ct)):
            raise AuthError("frame AEAD authentication failed")
        return self._xor(nonce, ct)


if not _HAVE_OPENSSL:
    X25519PrivateKey = _RefX25519PrivateKey
    X25519PublicKey = _RefX25519PublicKey


# Handshake entropy seam. Production draws from os.urandom; the simnet
# scenario runner installs a seeded stream so handshake nonces/ephemerals —
# and therefore the whole wire transcript — replay bit-identically per
# seed. (Simulated committees run inside one trusted process; deterministic
# ephemerals there cost nothing security-wise and buy exact replay.)
_entropy = os.urandom


def set_entropy(fn) -> "Callable[[int], bytes]":
    """Install a bytes-producing entropy source (n -> n bytes); returns
    the previous one so harnesses can restore it."""
    global _entropy
    previous = _entropy
    _entropy = fn if fn is not None else os.urandom
    return previous


def _eph_private_key():
    """A fresh X25519 ephemeral from the entropy seam (both the OpenSSL
    and the in-tree backend accept raw 32-byte scalars)."""
    raw = _entropy(32)
    if _HAVE_OPENSSL:
        return X25519PrivateKey.from_private_bytes(raw)
    return X25519PrivateKey(raw)


@dataclass
class Peer:
    """Identity of the remote end of a connection, as seen by handlers:
    `key` is the handshake-verified network public key, or None on
    unauthenticated (public-plane) servers."""

    addr: str
    key: Optional[PublicKey] = None

    def __str__(self) -> str:  # handlers log the peer; keep it readable
        return self.addr


class Session:
    """Per-connection frame protection: independent AES-256-GCM keys and
    counter nonces for each direction. Every frame body is encrypted and
    authenticated (AEAD) with the frame header as associated data — the
    full confidentiality+authenticity of the reference's TLS channel, at
    AES-NI speed."""

    def __init__(self, send_key: bytes, recv_key: bytes):
        if _HAVE_OPENSSL:
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM

            self._send = AESGCM(send_key)
            self._recv = AESGCM(recv_key)
        else:
            self._send = _HashAEAD(send_key)
            self._recv = _HashAEAD(recv_key)
        self._send_seq = 0
        self._recv_seq = 0

    @staticmethod
    def _aad(kind: int, rid: int, tag: int, lane: int = 0) -> bytes:
        return (
            bytes([kind])
            + rid.to_bytes(8, "little")
            + tag.to_bytes(2, "little")
            + bytes([lane])
        )

    def seal_body(
        self, kind: int, rid: int, tag: int, body: bytes, lane: int = 0
    ) -> bytes:
        """Encrypt+authenticate a frame body; returns ciphertext||tag(16).
        The counter nonce is unique per (key, direction) by construction."""
        nonce = self._send_seq.to_bytes(12, "little")
        self._send_seq += 1
        return self._send.encrypt(nonce, body, self._aad(kind, rid, tag, lane))

    def open_body(
        self, kind: int, rid: int, tag: int, ct: bytes, lane: int = 0
    ) -> bytes:
        """Decrypt+verify; raises AuthError on any tampering, injection,
        replay or reordering (the nonce is the expected sequence number)."""
        if _HAVE_OPENSSL:
            from cryptography.exceptions import InvalidTag
        else:
            InvalidTag = AuthError

        nonce = self._recv_seq.to_bytes(12, "little")
        try:
            body = self._recv.decrypt(nonce, ct, self._aad(kind, rid, tag, lane))
        except InvalidTag:
            raise AuthError("frame AEAD authentication failed") from None
        self._recv_seq += 1
        return body


class Credentials:
    """A node's network identity plus its view of who should answer at each
    mesh address. `resolve(addr)` returns the expected network key for a
    mesh address (primary_address / worker_address) or None for public
    endpoints — None skips the handshake entirely."""

    def __init__(
        self,
        keypair: KeyPair,
        resolve: Callable[[str], Optional[PublicKey]],
    ):
        self.keypair = keypair
        self.resolve = resolve


def committee_resolver(get_committee, get_worker_cache) -> Callable[[str], Optional[PublicKey]]:
    """Resolve mesh addresses against the *current* committee/worker-cache
    (callables, so epoch changes are picked up live): primary addresses map
    to Authority.network_key, worker mesh addresses to WorkerInfo.name.
    Transaction-ingest addresses are deliberately absent (public plane)."""

    def resolve(addr: str) -> Optional[PublicKey]:
        committee = get_committee()
        for auth in committee.authorities.values():
            if auth.primary_address == addr:
                return auth.network_key
        worker_cache = get_worker_cache()
        if worker_cache is not None:
            for workers in worker_cache.workers.values():
                for info in workers.values():
                    if info.worker_address == addr:
                        return info.name
        return None

    return resolve


def cached_allow_sets(holder, committee, worker_cache, build):
    """Identity-keyed memo of a node's allowed-key frozensets: the hot
    protocol plane pays two `is` compares per frame instead of an O(N)
    rebuild, and an epoch change (which swaps the committee/worker-cache
    objects) invalidates the cache. The cache tuple holds strong references
    to the keyed objects — keying on id() could serve a stale set to a new
    committee allocated at a recycled address after the old one is freed.

    `build()` returns the tuple of frozensets for the current objects; the
    same tuple shape is returned on every call. The memo is stored on
    `holder._auth_cache`."""
    cached = getattr(holder, "_auth_cache", None)
    if cached is None or cached[0] is not committee or cached[1] is not worker_cache:
        cached = (committee, worker_cache, build())
        holder._auth_cache = cached
    return cached[2]


def _raw_x25519_pub(priv) -> bytes:
    if not _HAVE_OPENSSL:
        return priv.public_key()._raw
    return priv.public_key().public_bytes(_ser.Encoding.Raw, _ser.PublicFormat.Raw)


def _transcript(
    nonce_s: bytes, nonce_c: bytes, server_pub: bytes, client_pub: bytes,
    server_eph: bytes, client_eph: bytes,
) -> bytes:
    return hashlib.blake2b(
        nonce_s + nonce_c + server_pub + client_pub + server_eph + client_eph,
        digest_size=32,
    ).digest()


def _derive_keys(shared: bytes, transcript: bytes) -> tuple[bytes, bytes]:
    """(client->server key, server->client key)."""
    c2s = hashlib.blake2b(shared + transcript + b"c2s", digest_size=32).digest()
    s2c = hashlib.blake2b(shared + transcript + b"s2c", digest_size=32).digest()
    return c2s, s2c


async def client_handshake(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    credentials: Credentials,
    expected_key: PublicKey,
    read_frame,
    write_frame,
) -> Session:
    """Client half: await HELLO, check the server presents the key the
    committee lists for this address, run the signed X25519 exchange and
    return the frame-MAC session. Raises AuthError on any mismatch."""
    kind, _, _, _, body = await asyncio.wait_for(read_frame(reader), HS_TIMEOUT)
    if kind != KIND_HELLO or len(body) != 96:
        raise AuthError("peer did not open with a handshake HELLO")
    nonce_s, server_pub, server_eph = body[:32], body[32:64], body[64:]
    if server_pub != expected_key:
        raise AuthError("server identity does not match committee network key")
    client_pub = credentials.keypair.public
    nonce_c = _entropy(32)
    eph_priv = _eph_private_key()
    client_eph = _raw_x25519_pub(eph_priv)
    transcript = _transcript(
        nonce_s, nonce_c, server_pub, client_pub, server_eph, client_eph
    )
    sig = credentials.keypair.sign(_CLIENT_DOMAIN + transcript)
    write_frame(writer, KIND_AUTH, 0, 0, client_pub + nonce_c + client_eph + sig)
    await writer.drain()
    kind, _, _, _, body = await asyncio.wait_for(read_frame(reader), HS_TIMEOUT)
    if kind != KIND_AUTH_OK or len(body) != 64:
        raise AuthError("server rejected handshake")
    if not verify(server_pub, _SERVER_DOMAIN + transcript, body):
        raise AuthError("server handshake signature invalid")
    shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(server_eph))
    c2s, s2c = _derive_keys(shared, transcript)
    return Session(send_key=c2s, recv_key=s2c)


async def server_handshake(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    keypair: KeyPair,
    read_frame,
    write_frame,
) -> tuple[PublicKey, Session]:
    """Server half: send HELLO with our ephemeral, verify the client's
    signed transcript, sign it back. Returns the client's verified network
    key and the frame-MAC session."""
    nonce_s = _entropy(32)
    server_pub = keypair.public
    eph_priv = _eph_private_key()
    server_eph = _raw_x25519_pub(eph_priv)
    write_frame(writer, KIND_HELLO, 0, 0, nonce_s + server_pub + server_eph)
    await writer.drain()
    kind, _, _, _, body = await asyncio.wait_for(read_frame(reader), HS_TIMEOUT)
    if kind != KIND_AUTH or len(body) != 160:
        raise AuthError("client did not authenticate")
    client_pub, nonce_c, client_eph, sig = (
        body[:32],
        body[32:64],
        body[64:96],
        body[96:],
    )
    transcript = _transcript(
        nonce_s, nonce_c, server_pub, client_pub, server_eph, client_eph
    )
    if not verify(client_pub, _CLIENT_DOMAIN + transcript, sig):
        raise AuthError("client handshake signature invalid")
    write_frame(writer, KIND_AUTH_OK, 0, 0, keypair.sign(_SERVER_DOMAIN + transcript))
    await writer.drain()
    shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(client_eph))
    c2s, s2c = _derive_keys(shared, transcript)
    return client_pub, Session(send_key=s2c, recv_key=c2s)
