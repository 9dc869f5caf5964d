"""Parameters, Committee and WorkerCache.

Port copy of `narwhal_tpu/config.py` (the JAX package's counterpart). The PyTorch
port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/config/src/lib.rs — Parameters :107-138 (defaults
:259-275), Committee + stake math :488-685, WorkerCache :360-473, JSON
Import/Export traits :65-97. With them: the environment knob readers the
worker reads (`pacing_enabled`, `env_float`, `env_int`,
`connection_pool_effective`), the ones the primary reads
(`relay_fanout_effective`, `header_wire_effective`) and the
port-placeholder allocator the RPC server binds through. The hot-swap
holder `Shared` of the JAX package's module comes with the node.

Addresses here are plain "host:port" strings. Durations are float seconds in
memory, serialized as milliseconds in JSON.
"""

from __future__ import annotations

import json
import logging
import os
import socket
from collections import deque
from dataclasses import asdict, dataclass, replace
from typing import Mapping

from .bounded_cache import BoundedCache
from .crypto import digest256
from .types import Epoch, PublicKey, WorkerId

logger = logging.getLogger("narwhal.config")

Stake = int


class ConfigError(ValueError):
    """Operator-facing misconfiguration (mis-sized shard count, bad flag
    combination): always fatal at boot, never fallback-able. Distinct from
    plain ValueError so callers with a documented degradation path (e.g.
    strict-rule nodes falling back to host crypto when the device verifier
    fails for NON-config reasons) can re-raise config mistakes while still
    degrading on environmental ones."""


@dataclass
class Parameters:
    """Tuning knobs (narwhal/config/src/lib.rs:107-275 defaults)."""

    header_size: int = 1_000  # bytes of payload digests before sealing a header
    max_header_delay: float = 0.1  # s; reference default 100ms
    gc_depth: int = 50  # rounds
    sync_retry_delay: float = 5.0  # s
    sync_retry_nodes: int = 3  # lucky-broadcast fan-out
    batch_size: int = 500_000  # bytes
    max_batch_delay: float = 0.1  # s
    max_concurrent_requests: int = 500_000
    block_synchronizer_range_timeout: float = 30.0
    block_synchronizer_certs_timeout: float = 2.0
    block_synchronizer_payload_timeout: float = 2.0
    block_synchronizer_payload_retries: int = 5
    consensus_api_grpc_address: str = "127.0.0.1:0"
    prometheus_address: str = "127.0.0.1:0"
    # Committee-wide ed25519 accept set for PER-ITEM signatures (headers,
    # votes, full-format certificate vote vectors) — every node MUST use
    # the same rule or adversarially crafted torsion-component signatures
    # make honest nodes disagree (a consensus-split vector; see
    # narwhal_tpu/tpu/verifier.py msm_epilogue_check). Validated at node
    # assembly (ConfigError on anything else):
    #   strict     — the host library's cofactorless rule (ed25519-dalek
    #                `verify` semantics); supported by every crypto backend.
    #   cofactored — RFC 8032 batch rule (ed25519-dalek `batch_verify`
    #                semantics); only the tpu backend's msm kernel applies
    #                it per-item, so cpu/pool nodes refuse to start under
    #                this rule. Note compact-certificate PROOFS are
    #                cofactored on every backend by construction (the
    #                half-aggregated equation admits no other rule) —
    #                verify_rule only governs per-item checks.
    verify_rule: str = "strict"
    # Certificate wire form — committee-wide (mixed committees would
    # disagree about certificate bytes):
    #   compact — the DEFAULT: half-aggregated, 32-byte R per signer + one
    #             32-byte aggregate scalar (~2x smaller proofs, and the
    #             broadcast sheds the header body via CertificateRefMsg —
    #             3.2x smaller announcements measured at N=50; see types.py
    #             Certificate). Every backend verifies proofs batched: the
    #             tpu backend fuses groups into one device msm dispatch,
    #             cpu/pool run the same randomized-linear-combination rule
    #             over one host bucket-method MSM per flush
    #             (types.host_batch_verify_aggregates), amortizing the
    #             group math across every certificate in a dispatch.
    #   full    — the opt-out: one 64-byte ed25519 signature per signer
    #             (reference-like). Every node always ACCEPTS both forms on
    #             the wire; this picks what the committee assembles.
    cert_format: str = "compact"
    # Byte budget for the executor's speculative payload prefetcher
    # (executor/prefetcher.py): unclaimed pre-commit payload held in the
    # temp batch store never exceeds this; 0 disables prefetching entirely.
    # Env override: NARWHAL_PREFETCH_BUDGET (bytes, read at node assembly).
    prefetch_budget: int = 64 << 20
    # -- adaptive pacing (pacing.PacingController) -------------------------
    # max_batch_delay / max_header_delay become CEILINGS: the effective
    # delay shrinks toward these floors when the channel-depth EWMA says
    # queues are shallow (latency mode) and grows back toward the ceiling
    # under load (throughput mode). NARWHAL_PACING=0 disables adaptation
    # (fixed ceilings, the seed behavior); NARWHAL_BATCH_DELAY_FLOOR /
    # NARWHAL_HEADER_DELAY_FLOOR override the floors (seconds).
    batch_delay_floor: float = 0.005
    header_delay_floor: float = 0.02
    pacing_low_occupancy: float = 0.05  # EWMA at/below -> floor delay
    pacing_high_occupancy: float = 0.5  # EWMA at/above -> ceiling delay
    pacing_ewma_alpha: float = 0.2
    # -- end-to-end admission control (pacing.IngestGate) ------------------
    # Policy at the worker's client-facing ingest once the admission level
    # (max of local ingest occupancy and the primary-pushed downstream
    # backlog) crosses the high watermark: 'shed' answers RESOURCE_EXHAUSTED
    # immediately, 'block' holds the submission until the level falls below
    # the low watermark (bounded, then sheds), 'off' restores the seed's
    # unbounded queueing. Env override: NARWHAL_INGEST_POLICY.
    ingest_policy: str = "shed"
    backpressure_high_watermark: float = 0.75  # occupancy fraction
    backpressure_low_watermark: float = 0.5  # hysteresis release
    backpressure_poll_interval: float = 0.25  # primary->worker push period, s
    backpressure_stale_after: float = 2.0  # worker fails OPEN past this, s
    # Overload is mostly SERVICE-TIME saturation, not queue depth (items on
    # the hot channels are whole batches/certificates, so channels stay
    # shallow while rounds take seconds): the admission level also tracks
    # the commit-stage latency EWMA against this target — EWMA == target
    # lands on the high watermark, and a commit STALL longer than the
    # target pins the level at 1.0. 0 disables the latency signals.
    # Env override: NARWHAL_COMMIT_LATENCY_TARGET (seconds).
    commit_latency_target: float = 4.0
    # -- payload-plane wire diet (primary/fanout.py, primary/delta.py) -----
    # Fanout-tree dissemination of header/certificate broadcasts: the
    # origin sends to at most `relay_fanout` children of a deterministic
    # stake-weighted per-round tree and every receiver forwards to its own
    # children in the same tree; peers the origin has not heard an ack from
    # within relay_fallback_timeout get the original message by direct
    # reliable send, so reliable-broadcast semantics survive crashed
    # relays. Relaying engages only when the committee is large enough for
    # the tree to have depth >= 2 (more others than relay_fanout); 0
    # disables it outright. Env overrides: NARWHAL_RELAY_FANOUT, and
    # NARWHAL_RELAY=0 as a kill-switch.
    relay_fanout: int = 3
    relay_fallback_timeout: float = 0.5
    # Header/certificate announcement wire form — committee-interoperable
    # (every node always ACCEPTS both forms; this picks what we SEND):
    #   full  — self-describing HeaderMsg/CertificateMsg (seed behavior).
    #   delta — DeltaHeaderMsg (the payload pairs added since the sender's
    #           last header + 2-byte parent refs into the receiver's
    #           recent-certificate index) and CertificateDeltaMsg
    #           (signatures by header reference). Receivers that cannot
    #           reconstruct fall back to the full-map resync path
    #           (HeaderResyncRequest keyed off their last-seen round).
    # Env override: NARWHAL_HEADER_WIRE.
    header_wire: str = "delta"
    # -- connection pool (network/pool.py) ---------------------------------
    # One multiplexed authenticated connection per peer NODE pair: every
    # lane (primary plane + each worker plane) of the pair shares one
    # socket with a lane id in the frame header, taking an N-node W-worker
    # mesh from O(N^2 * (1+W)) sockets to one per unordered pair (the anemo
    # one-QUIC-connection-per-peer model). False restores per-role-pair
    # dedicated connections. Env kill-switch: NARWHAL_POOL=0.
    connection_pool: bool = True
    # Crossed-dial damping: the pool end whose network key sorts HIGHER
    # than the peer's waits this long for the peer's inbound connection to
    # be adopted before dialing itself (the canonical connection is the one
    # dialed by the lower key; a crossed dial is resolved by closing the
    # higher side's, so this wait turns a boot-time close/redial churn into
    # a no-op for all but the slowest pairs).
    pool_passive_dial_delay: float = 0.2
    # Grace period before the losing connection of a crossed dial is torn
    # down, letting responses already in flight on it drain.
    pool_linger: float = 1.0
    # Byte budget of the per-server relay dedup cache (digest-keyed decoded
    # messages; duplicate RelayMsg/Relay2Msg copies skip the codec).
    relay_dedup_cache_bytes: int = 32 << 20

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Parameters":
        data = json.loads(text)
        known = {f for f in Parameters.__dataclass_fields__}
        return Parameters(**{k: v for k, v in data.items() if k in known})

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def import_(path: str) -> "Parameters":
        with open(path) as f:
            return Parameters.from_json(f.read())


def connection_pool_effective(parameters: "Parameters") -> bool:
    """Whether the node runs the per-peer-pair connection pool after the
    NARWHAL_POOL env kill-switch (0/false/off forces dedicated per-role
    connections, the pre-pool behavior)."""
    if os.environ.get("NARWHAL_POOL", "1").lower() in ("0", "false", "off"):
        return False
    return bool(parameters.connection_pool)


def pacing_enabled() -> bool:
    """NARWHAL_PACING=0/false/off pins the seal/header delays at their
    configured ceilings (the pre-pacing behavior); anything else adapts."""
    return os.environ.get("NARWHAL_PACING", "1").lower() not in ("0", "false", "off")


def env_float(name: str, default: float) -> float:
    """Environment override for a float knob; non-numeric values are
    ignored loudly rather than crashing the boot."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r (using %s)", name, raw, default)
        return default


def env_int(name: str, default: int) -> int:
    """Environment override for an int knob; non-numeric values are
    ignored loudly rather than crashing the boot."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r (using %s)", name, raw, default)
        return default


def relay_fanout_effective(parameters: "Parameters") -> int:
    """The relay fanout after env overrides: NARWHAL_RELAY=0/false/off is
    the kill-switch (forces direct all-to-all broadcast), NARWHAL_RELAY_FANOUT
    overrides the branching factor."""
    if os.environ.get("NARWHAL_RELAY", "1").lower() in ("0", "false", "off"):
        return 0
    return max(0, env_int("NARWHAL_RELAY_FANOUT", parameters.relay_fanout))


def header_wire_effective(parameters: "Parameters") -> str:
    """The header/certificate announcement wire form after the
    NARWHAL_HEADER_WIRE env override (full | delta)."""
    return os.environ.get("NARWHAL_HEADER_WIRE", parameters.header_wire)


@dataclass(frozen=True)
class Authority:
    """Stake + addresses of one validator
    (narwhal/config/src/lib.rs:475-486)."""

    stake: Stake
    primary_address: str
    network_key: PublicKey


class Committee:
    """The validator set with stake math
    (narwhal/config/src/lib.rs:488-685)."""

    def __init__(self, authorities: Mapping[PublicKey, Authority], epoch: Epoch = 0):
        # Canonical order: sorted by public key. Index in this order is the
        # authority's dense id used by certificates' signer lists and by every
        # TPU DAG tensor ([rounds x authorities] layout).
        self.authorities: dict[PublicKey, Authority] = dict(
            sorted(authorities.items())
        )
        self.epoch = epoch
        self._keys: list[PublicKey] = list(self.authorities)
        self._index: dict[PublicKey, int] = {pk: i for i, pk in enumerate(self._keys)}
        self._total_stake: Stake = sum(a.stake for a in self.authorities.values())
        self._transcript_digest: bytes | None = None
        # Structural signer-set memo (see signer_group): one computation
        # per distinct certificate signer tuple under this committee.
        self._signer_groups = BoundedCache(max_entries=1 << 16)

    # -- size / stake -----------------------------------------------------
    def size(self) -> int:
        return len(self.authorities)

    def stake(self, name: PublicKey) -> Stake:
        a = self.authorities.get(name)
        return a.stake if a else 0

    def total_stake(self) -> Stake:
        return self._total_stake

    def quorum_threshold(self) -> Stake:
        """2f+1 equivalent: ceil((2N+1)/3) of total stake
        (narwhal/config/src/lib.rs:537-544)."""
        return (2 * self._total_stake) // 3 + 1

    def validity_threshold(self) -> Stake:
        """f+1 equivalent (narwhal/config/src/lib.rs:546-550)."""
        return (self._total_stake + 2) // 3

    # -- identity ---------------------------------------------------------
    def authority_keys(self) -> list[PublicKey]:
        return self._keys

    def transcript_digest(self) -> bytes:
        """Content identity of this validator set (memoized): epoch plus
        the canonical (public key, stake) sequence. Keys the process-wide
        aggregate-verdict front cache, where verdicts reached under
        different committees with overlapping signer indices must never
        collide. Committees are immutable after construction (reconfigure
        builds a new one), so memoizing is safe."""
        d = self._transcript_digest
        if d is None:
            parts = [int(self.epoch).to_bytes(8, "little")]
            for pk, a in self.authorities.items():
                parts.append(pk)
                parts.append(int(a.stake).to_bytes(8, "little"))
            d = self._transcript_digest = digest256(b"".join(parts))
        return d

    def index_of(self, name: PublicKey) -> int:
        return self._index[name]

    def key_of(self, index: int) -> PublicKey:
        return self._keys[index]

    def stakes_array(self) -> list[Stake]:
        return [self.authorities[pk].stake for pk in self._keys]

    def signer_group(
        self, signers: tuple[int, ...]
    ) -> tuple[tuple[PublicKey, ...], Stake]:
        """Memoized structural resolution of a certificate signer set:
        `(signer public keys in order, their total stake)`, validated for
        duplicates and index range — computed ONCE per (committee, signer
        tuple) instead of per certificate COPY. In the relay fan-out every
        member re-verifies the same certificate, so at N=200 the per-copy
        O(N) index/stake walk was a top-3 term of the liveness wall; the
        same few thousand distinct signer sets recur across copies and
        sanitize/verify stages. Committees are immutable after construction
        (reconfigure builds a new one), so memoizing on the instance is
        safe. Raises ValueError on malformed sets (config cannot import the
        DAG error types; callers wrap)."""
        group = self._signer_groups.get(signers)
        if group is None:
            if len(set(signers)) != len(signers):
                raise ValueError("duplicate signers")
            keys = self._keys
            pks = []
            stake = 0
            for idx in signers:
                if idx >= len(keys):
                    raise ValueError(f"signer index {idx} out of range")
                pk = keys[idx]
                stake += self.authorities[pk].stake
                pks.append(pk)
            group = (tuple(pks), stake)
            # First write wins (deterministic values), so a concurrent
            # resolution of the same tuple settles on one canonical group.
            self._signer_groups.put(signers, group)
        return group

    # -- leader election --------------------------------------------------
    def leader(self, seed: int) -> PublicKey:
        """Stake-weighted deterministic leader
        (narwhal/config/src/lib.rs:553-567): a seeded PRNG pick
        weighted by stake. We derive the pick from digest256(seed) so every
        implementation (host Python, JAX kernel) agrees bit-for-bit."""
        h = digest256(seed.to_bytes(8, "little") + self.epoch.to_bytes(8, "little"))
        ticket = int.from_bytes(h[:8], "little") % self._total_stake
        acc = 0
        for pk in self._keys:
            acc += self.authorities[pk].stake
            if ticket < acc:
                return pk
        return self._keys[-1]

    def leader_index(self, seed: int) -> int:
        return self._index[self.leader(seed)]

    # -- addressing -------------------------------------------------------
    def primary_address(self, name: PublicKey) -> str:
        return self.authorities[name].primary_address

    def network_key(self, name: PublicKey) -> PublicKey:
        return self.authorities[name].network_key

    def others_primaries(self, me: PublicKey) -> list[tuple[PublicKey, str, PublicKey]]:
        """(name, address, network_key) of every other primary
        (narwhal/config/src/lib.rs:585-600)."""
        return [
            (pk, a.primary_address, a.network_key)
            for pk, a in self.authorities.items()
            if pk != me
        ]

    def update_primary_network_info(
        self, updates: Mapping[PublicKey, tuple[Stake, str]]
    ) -> None:
        """Mid-epoch address updates
        (narwhal/config/src/lib.rs:621-685): every authority must be
        covered and stakes must match."""
        if set(updates) != set(self.authorities):
            raise ValueError("updates must cover exactly the current committee")
        for pk, (stake, addr) in updates.items():
            if self.authorities[pk].stake != stake:
                raise ValueError(f"stake mismatch for {pk.hex()[:16]}")
        for pk, (stake, addr) in updates.items():
            self.authorities[pk] = replace(self.authorities[pk], primary_address=addr)

    # -- serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "epoch": self.epoch,
                "authorities": {
                    pk.hex(): {
                        "stake": a.stake,
                        "primary_address": a.primary_address,
                        "network_key": a.network_key.hex(),
                    }
                    for pk, a in self.authorities.items()
                },
            },
            indent=2,
            sort_keys=True,
        )

    @staticmethod
    def from_json(text: str) -> "Committee":
        data = json.loads(text)
        return Committee(
            {
                bytes.fromhex(pk): Authority(
                    stake=a["stake"],
                    primary_address=a["primary_address"],
                    network_key=bytes.fromhex(a["network_key"]),
                )
                for pk, a in data["authorities"].items()
            },
            epoch=data["epoch"],
        )

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def import_(path: str) -> "Committee":
        with open(path) as f:
            return Committee.from_json(f.read())

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Committee)
            and self.epoch == other.epoch
            and self.authorities == other.authorities
        )


@dataclass(frozen=True)
class WorkerInfo:
    """(narwhal/config/src/lib.rs:348-358): name = worker network key,
    transactions = client-facing tx ingest address, worker_address = the
    worker<->worker mesh address."""

    name: PublicKey
    transactions: str
    worker_address: str


class WorkerCache:
    """Worker topology of the whole committee
    (narwhal/config/src/lib.rs:360-473)."""

    def __init__(
        self, workers: Mapping[PublicKey, Mapping[WorkerId, WorkerInfo]], epoch: Epoch = 0
    ):
        self.workers: dict[PublicKey, dict[WorkerId, WorkerInfo]] = {
            pk: dict(ws) for pk, ws in workers.items()
        }
        self.epoch = epoch

    def worker(self, authority: PublicKey, worker_id: WorkerId) -> WorkerInfo:
        return self.workers[authority][worker_id]

    def has_worker(self, authority: PublicKey, worker_id: WorkerId) -> bool:
        return worker_id in self.workers.get(authority, {})

    def our_workers(self, authority: PublicKey) -> dict[WorkerId, WorkerInfo]:
        return self.workers[authority]

    def others_workers(
        self, me: PublicKey, worker_id: WorkerId
    ) -> list[tuple[PublicKey, WorkerInfo]]:
        """Same-id workers at every other authority
        (narwhal/config/src/lib.rs:432-450)."""
        return [
            (pk, ws[worker_id])
            for pk, ws in self.workers.items()
            if pk != me and worker_id in ws
        ]

    def all_workers(self) -> list[WorkerInfo]:
        return [w for ws in self.workers.values() for w in ws.values()]

    def to_json(self) -> str:
        return json.dumps(
            {
                "epoch": self.epoch,
                "workers": {
                    pk.hex(): {
                        str(wid): {
                            "name": w.name.hex(),
                            "transactions": w.transactions,
                            "worker_address": w.worker_address,
                        }
                        for wid, w in ws.items()
                    }
                    for pk, ws in self.workers.items()
                },
            },
            indent=2,
            sort_keys=True,
        )

    @staticmethod
    def from_json(text: str) -> "WorkerCache":
        data = json.loads(text)
        return WorkerCache(
            {
                bytes.fromhex(pk): {
                    int(wid): WorkerInfo(
                        name=bytes.fromhex(w["name"]),
                        transactions=w["transactions"],
                        worker_address=w["worker_address"],
                    )
                    for wid, w in ws.items()
                }
                for pk, ws in data["workers"].items()
            },
            epoch=data["epoch"],
        )

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def import_(path: str) -> "WorkerCache":
        with open(path) as f:
            return WorkerCache.from_json(f.read())


_HANDED_OUT: set[int] = set()
_HANDED_ORDER: deque[int] = deque()
# Placeholder sockets keep every handed-out port BOUND (with SO_REUSEPORT)
# until the real server co-binds: between assignment and bind the kernel
# would otherwise happily hand the same port to an ephemeral *outbound*
# connection — with a 20-node committee (~100 pre-assigned ports, thousands
# of mesh dials) that collision is routine, and the server's bind then fails
# with EADDRINUSE. Outbound sockets don't set SO_REUSEPORT so they can never
# share a placeheld port; servers do (RpcServer reuse_port, gRPC's default),
# so they bind straight through the placeholder.
_PLACEHOLDERS: dict[int, socket.socket] = {}
# Only the recent tail matters: servers bind within moments of assignment,
# and an unbounded set would eventually exhaust the 64 bind attempts in a
# long-lived process that keeps building clusters.
_HANDED_WINDOW = 1024


def get_available_port(host: str = "127.0.0.1") -> int:
    """(narwhal/config/src/utils.rs:9-33). Ports are pre-assigned
    before servers bind them: hand out a port at most once per window and
    keep it placeheld (see _PLACEHOLDERS) until its server binds.

    The probe binds WITHOUT SO_REUSEPORT — the kernel then never selects a
    port owned by a live reuse-port listener (which a REUSEPORT probe would
    happily co-bind, silently splitting that listener's traffic). The
    placeholder then re-binds the probed port with SO_REUSEPORT so the real
    server can bind through it; losing the tiny re-bind race just retries.
    """
    for _ in range(64):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, 0))
            port = s.getsockname()[1]
        except OSError:
            s.close()
            continue
        s.close()
        if port in _HANDED_OUT:
            continue
        ph = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ph.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        try:
            ph.bind((host, port))
        except OSError:
            ph.close()  # an ephemeral connection won the re-bind race
            continue
        _HANDED_OUT.add(port)
        _HANDED_ORDER.append(port)
        _PLACEHOLDERS[port] = ph
        while len(_HANDED_ORDER) > _HANDED_WINDOW:
            old = _HANDED_ORDER[0]
            if old in _PLACEHOLDERS:
                # Still placeheld: its server has not bound yet. Closing the
                # placeholder here would re-open the exact collision it
                # exists to prevent (an ephemeral connection or a fresh
                # hand-out grabbing the port before the server binds), so
                # keep it and let the window grow. Loud, because a window
                # full of unbound ports usually means someone is leaking
                # placeholders (forgot release_port/release_all_ports).
                logger.warning(
                    "port window (%d) full of still-placeheld ports; "
                    "oldest=%d not evicted — check for placeholder leaks",
                    _HANDED_WINDOW,
                    old,
                )
                break
            _HANDED_ORDER.popleft()
            _HANDED_OUT.discard(old)
        return port
    raise OSError("no available port after 64 attempts")


def placeheld_ports() -> list[int]:
    """The ports this process currently reserves with live placeholders.
    Harness parents advertise exactly this list (NARWHAL_PLACEHELD_PORTS)
    to their node children, so the children co-bind only genuinely
    placeheld ports and every other duplicate bind still fails fast."""
    return sorted(_PLACEHOLDERS)


# Ports with a live server bound by THIS process. The parent's
# NARWHAL_PLACEHELD_PORTS advertisement is spawn-time static, so without
# this set a second server in the same child (same node started twice, a
# committee file assigning one port to two roles) would still co-bind
# "through" an advertisement whose placeholder its sibling already consumed.
_BOUND_IN_PROCESS: set[int] = set()


def mark_port_bound(port: int) -> None:
    """Record that a server in this process holds `port` (RpcServer.start)."""
    _BOUND_IN_PROCESS.add(port)


def mark_port_unbound(port: int) -> None:
    """The server on `port` has stopped; a later bind (node restart) may
    again co-bind through a parent's still-live placeholder."""
    _BOUND_IN_PROCESS.discard(port)


def port_is_placeheld(port: int) -> bool:
    """True when `port` is reserved by a live SO_REUSEPORT placeholder —
    this process's (_PLACEHOLDERS) or a harness parent's, advertised via
    NARWHAL_PLACEHELD_PORTS ("all", or a comma-separated port list). Servers
    use this to decide whether co-binding with reuse_port is intended
    (binding through a placeholder) or a misconfiguration that should fail
    fast with EADDRINUSE (two servers on one address). A port already bound
    by a live server in this process is never placeheld — the placeholder
    behind any advertisement has done its job."""
    if port in _BOUND_IN_PROCESS:
        return False
    if port in _PLACEHOLDERS:
        return True
    env = os.environ.get("NARWHAL_PLACEHELD_PORTS", "")
    if env == "all":
        return True
    return any(tok.strip() == str(port) for tok in env.split(",") if tok.strip())


def release_port(port: int) -> None:
    """Drop the placeholder for `port` once its real server has bound (or
    will never bind). Safe to call for ports this process never placeheld —
    a subprocess binding a parent-assigned port simply co-binds via
    SO_REUSEPORT and the parent releases via release_all_ports."""
    s = _PLACEHOLDERS.pop(port, None)
    if s is not None:
        s.close()


def release_all_ports() -> None:
    """Drop every live placeholder. For multi-process harness parents: the
    children bind the assigned ports themselves, so the parent must free
    its placeholder fds once the fleet is up (a sweep would otherwise
    accumulate them toward the fd ulimit)."""
    while _PLACEHOLDERS:
        _, s = _PLACEHOLDERS.popitem()
        s.close()
