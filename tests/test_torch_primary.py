"""The port's `primary/` against the JAX package's.

- The JAX package's primary scenarios (`tests/test_primary.py`) run against
  the port: the module's source with the package name swapped.
- The fanout tree (`relay_order`, `relay_children`) and the wire forms
  (`encode_relay2` / `decode_relay2`, `HeaderDeltaCodec`,
  `encode_announcement`, `encode_certificate_announcement`) give equal
  trees and equal bytes in both packages, on seeded signed headers and
  full and compact certificates, under both header wires.
- A mixed committee of 4, two port primaries and two JAX primaries, each
  with its worker and consensus runner, over authenticated loopback TCP,
  through `chip_smoke.primary_wire` (the `primary` path): every
  transaction committed once, every runner's sequence a prefix-equal of
  authority 0's, authority 0's accepted stream replayed through the host
  Bullshark, and certificates whose signers span both packages.
- `VerifierStage` over the port's `VerifyService` on the CPU forwards and
  drops exactly what the JAX stage over its `AsyncVerifierPool` does.
- The config readers `relay_fanout_effective` and `header_wire_effective`
  equal the JAX ones under their environment knobs.
"""

import asyncio
import re
import types
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import narwhal_tpu.channels as j_channels
import narwhal_tpu.config as j_config
import narwhal_tpu.consensus as j_consensus
import narwhal_tpu.crypto as j_crypto
import narwhal_tpu.fixtures as j_fixtures
import narwhal_tpu.messages as j_messages
import narwhal_tpu.network as j_network
import narwhal_tpu.primary as j_primary
import narwhal_tpu.primary.delta as j_delta
import narwhal_tpu.primary.fanout as j_fanout
import narwhal_tpu.primary.verifier_stage  # noqa: F401  (m.primary.verifier_stage)
import narwhal_tpu.stores as j_stores
import narwhal_tpu.types as j_types
import narwhal_tpu.worker as j_worker
import narwhal_tpu_torch.config as t_config
import narwhal_tpu_torch.primary.delta as t_delta
import narwhal_tpu_torch.primary.fanout as t_fanout
import narwhal_tpu_torch.primary.verifier_stage  # noqa: F401
from test_torch_network import port_scenarios

TESTS = Path(__file__).resolve().parent


_SCENARIOS = port_scenarios("test_primary.py")
assert not set(_SCENARIOS) & set(globals())
globals().update(_SCENARIOS)

PORT = chip_smoke.primary_modules()
JAX = types.SimpleNamespace(channels=j_channels, config=j_config, consensus=j_consensus,
                            crypto=j_crypto, fixtures=j_fixtures, messages=j_messages,
                            network=j_network, primary=j_primary, stores=j_stores,
                            types=j_types, worker=j_worker)
WIRE = {"port": (PORT, t_fanout, t_delta), "jax": (JAX, j_fanout, j_delta)}


def test_all_reference_primary_scenarios_collected():
    ref = set(re.findall(r"^def (test_\w+)", (TESTS / "test_primary.py").read_text(), re.M))
    assert set(_SCENARIOS) == ref and len(ref) >= 10


# -- fanout tree and wire forms --------------------------------------------


@pytest.mark.parametrize("n", [4, 10, 50])
def test_relay_trees_equal(n):
    rng = np.random.default_rng(n)
    fx_t, fx_j = PORT.fixtures.CommitteeFixture(size=n), JAX.fixtures.CommitteeFixture(size=n)
    keys = [a.public for a in fx_t.authorities]
    assert keys == [a.public for a in fx_j.authorities]
    for _ in range(12):
        epoch, rnd = int(rng.integers(0, 5)), int(rng.integers(0, 1 << 20))
        origin = keys[int(rng.integers(0, n))]
        order = t_fanout.relay_order(fx_t.committee, epoch, rnd, origin)
        assert order == j_fanout.relay_order(fx_j.committee, epoch, rnd, origin)
        assert sorted(order) == sorted(k for k in keys if k != origin)
        for me in keys:
            for fanout in (1, 3, 7):
                got = t_fanout.relay_children(fx_t.committee, epoch, rnd, origin, me, fanout)
                assert got == j_fanout.relay_children(fx_j.committee, epoch, rnd, origin, me,
                                                      fanout)


def signed_rounds(m, n: int, rounds: int, seed: int):
    """Signed headers of `rounds` rounds of an n-committee in package `m`,
    each with a seeded payload, and each round's full and compact
    certificates (every authority votes). Ed25519 signing is deterministic,
    so both packages build byte-equal objects."""
    fx = m.fixtures.CommitteeFixture(size=n)
    committee = fx.committee
    rng = np.random.default_rng(seed)
    parents = {c.digest for c in m.types.Certificate.genesis(committee)}
    out = []
    for r in range(1, rounds + 1):
        row = []
        for a in fx.authorities:
            payload = {rng.bytes(32): int(rng.integers(0, 3))
                       for _ in range(int(rng.integers(0, 4)))}
            header = m.types.Header.build(a.public, r, committee.epoch, payload, parents,
                                          a.keypair)
            votes = sorted((committee.index_of(v.public),
                            m.types.Vote.for_header(header, v.public, v.keypair).signature)
                           for v in fx.authorities)
            signers, sigs = tuple(i for i, _ in votes), tuple(s for _, s in votes)
            row.append((header, m.types.Certificate(header, signers, sigs),
                        m.types.Certificate.compact_from_votes(header, signers, sigs)))
        out.append(row)
        parents = {full.digest for _, full, _ in row}
    return fx, out


def wire_bytes(m, msg) -> tuple[int, bytes]:
    return m.messages.encode_message(msg)


@pytest.mark.parametrize("wire", ["full", "delta"])
def test_announcements_and_relay2_byte_equal(wire):
    n, rounds = 7, 4
    built = {name: signed_rounds(m, n, rounds, seed=5) for name, (m, _f, _d) in WIRE.items()}
    codecs = {name: WIRE[name][2].HeaderDeltaCodec(built[name][0].committee) for name in WIRE}
    kinds = set()
    for r in range(rounds):
        for i in range(n):
            got = {}
            for name, (m, fanout, delta) in WIRE.items():
                fx, rows = built[name]
                header, full, compact = rows[r][i]
                codec = codecs[name]
                msgs = [delta.encode_announcement(codec, header, wire),
                        delta.encode_certificate_announcement(full, wire),
                        delta.encode_certificate_announcement(compact, wire)]
                enc = [wire_bytes(m, x) for x in msgs]
                relays = [fanout.encode_relay2(fx.committee, header.author, header.round, x)
                          for x in msgs]
                back = [fanout.decode_relay2(fx.committee, x) for x in relays]
                assert [wire_bytes(m, x) for x in back] == enc
                if isinstance(msgs[0], m.messages.DeltaHeaderMsg):
                    rebuilt = codec.decode_header(msgs[0])
                    assert rebuilt is not None and rebuilt.digest == header.digest
                got[name] = (enc, [wire_bytes(m, x) for x in relays],
                             [type(x).__name__ for x in msgs])
            assert got["port"] == got["jax"], (r, i)
            kinds.update(got["port"][2])
        for name, (m, _f, _d) in WIRE.items():
            for header, full, _c in built[name][1][r]:
                codecs[name].note_certificate(full)
    assert kinds == ({"HeaderMsg", "CertificateMsg", "CertificateRefMsg"} if wire == "full"
                     else {"DeltaHeaderMsg", "CertificateDeltaMsg", "CertificateRefMsg"})
    # Parents collected below the codec's index: the delta form falls back
    # to the full header in both packages.
    fallback = []
    for name, (m, _f, delta) in WIRE.items():
        codecs[name].gc(rounds - 1)
        header = built[name][1][rounds - 1][0][0]
        msg = delta.encode_announcement(codecs[name], header, wire)
        fallback.append((type(msg).__name__, wire_bytes(m, msg)))
    assert fallback[0] == fallback[1] and fallback[0][0] == "HeaderMsg"


# -- a mixed committee through the primary path ----------------------------


@pytest.mark.parametrize("first", ["port", "jax"])
def test_mixed_committee_forms_votes_and_commits(run, tmp_path, first):
    """Authorities 0 and 1 from one package, 2 and 3 from the other; with
    the port first, authority 0's runner drives GpuBullshark on the CPU (the
    plain versions). Clients submit to workers 0 and 2, one of each
    package."""
    from narwhal_tpu_torch.gpu.dag_kernels import GpuBullshark

    a, b = (PORT, JAX) if first == "port" else (JAX, PORT)

    def engine0(m, fx, storage):
        return GpuBullshark(fx.committee, storage.consensus_store, fx.parameters.gc_depth,
                            device="cpu")

    out = run(chip_smoke.primary_wire(
        [a, a, b, b], str(tmp_path), clients=2, txs_per_client=40, targets=[0, 2],
        engine0=engine0 if first == "port" else None, timeout=60.0),
        timeout=90.0)
    assert out["transactions"] == 80 and out["batches"] >= 2
    # Each package's primaries voted on the other's headers.
    assert all(k > 0 for k in out["mixed_signers_by_package"]), out
    assert min(out["runner_lengths"]) > 0 and out["committed"] == out["runner_lengths"][0]


@pytest.mark.slow
def test_port_committee_of_50(run, tmp_path):
    out = run(chip_smoke.primary_wire([PORT] * 50, str(tmp_path), clients=10,
                                      txs_per_client=200, timeout=300.0), timeout=400.0)
    assert out["transactions"] == 2000 and out["committed"] > 0


@pytest.mark.slow
def test_port_committee_verifies_through_the_service(run, tmp_path):
    """The card path's shape on the CPU: every primary's stage on one
    VerifyService of the plain versions."""
    from narwhal_tpu_torch.gpu.verifier import GpuVerifier, VerifyService

    svc = VerifyService(GpuVerifier(max_bucket=64, msm_min_bucket=16, mode="item",
                                    device="cpu"), max_batch=64)
    try:
        out = run(chip_smoke.primary_wire([PORT] * 4, str(tmp_path), clients=2,
                                          txs_per_client=40, pool=svc, timeout=300.0),
                  timeout=400.0)
    finally:
        svc.shutdown()
    assert out["transactions"] == 80


# -- the verifier stage on the port's service ------------------------------


def stage_inputs(m):
    """An honest header, vote and compact certificate, a vote with a
    flipped signature byte and a compact certificate with a flipped agg_s
    byte (`chip_smoke.tampered_messages`), in package `m`."""
    fx = m.fixtures.CommitteeFixture(size=4)
    committee = fx.committee
    a0, a1 = fx.authorities[0], fx.authorities[1]
    genesis = frozenset(c.digest for c in m.types.Certificate.genesis(committee))
    header = m.types.Header.build(a0.public, 1, committee.epoch, {b"\x07" * 32: 0}, genesis,
                                  a0.keypair)
    vote = m.types.Vote.for_header(header, a1.public, a1.keypair)
    votes = sorted((committee.index_of(v.public),
                    m.types.Vote.for_header(header, v.public, v.keypair).signature)
                   for v in fx.authorities[:3])
    cert = m.types.Certificate.compact_from_votes(header, tuple(i for i, _ in votes),
                                                  tuple(s for _, s in votes))
    bad_vote, bad_cert = chip_smoke.tampered_messages(m, fx)
    return fx, {"header": header, "vote": vote, "certificate": cert, "bad_vote": bad_vote,
                "bad_certificate": bad_cert}


async def stage_verdicts(m, pool) -> tuple[dict, object]:
    fx, msgs = stage_inputs(m)
    out = m.channels.Channel(16)
    stage = m.primary.verifier_stage.VerifierStage(fx.committee, fx.worker_cache, pool, out)
    try:
        for msg in msgs.values():
            await stage.submit(msg)
        while stage._tasks:
            await asyncio.sleep(0.01)
    finally:
        stage.shutdown()
    passed = []
    while (got := out.try_recv()) is not None:
        assert isinstance(got, m.primary.verifier_stage.PreVerified)
        passed.append(got.inner)
    return {name: any(p is msg for p in passed) for name, msg in msgs.items()}, stage


def test_verifier_stage_on_the_port_service_matches_jax(run):
    from narwhal_tpu.tpu.verifier import AsyncVerifierPool
    from narwhal_tpu_torch.gpu.verifier import GpuVerifier, VerifyService

    svc = VerifyService(GpuVerifier(max_bucket=64, msm_min_bucket=16, mode="item",
                                    device="cpu"), max_batch=64)
    try:
        mine, stage = run(stage_verdicts(PORT, svc), timeout=120.0)
    finally:
        svc.shutdown()
    pool = AsyncVerifierPool(max_delay=0.01)

    async def jax_side():
        try:
            return (await stage_verdicts(JAX, pool))[0]
        finally:
            await pool.close()

    ref = run(jax_side(), timeout=120.0)
    assert mine == ref == {"header": True, "vote": True, "certificate": True,
                           "bad_vote": False, "bad_certificate": False}
    assert dict(stage.drops) == {("Vote", "signature"): 1, ("Certificate", "signature"): 1}


# -- the config readers ------------------------------------------------------


@pytest.mark.parametrize("env", [
    {},
    {"NARWHAL_RELAY": "0"},
    {"NARWHAL_RELAY": "off", "NARWHAL_RELAY_FANOUT": "5"},
    {"NARWHAL_RELAY_FANOUT": "7"},
    {"NARWHAL_RELAY_FANOUT": "-2"},
    {"NARWHAL_RELAY_FANOUT": "many"},
    {"NARWHAL_HEADER_WIRE": "full"},
    {"NARWHAL_HEADER_WIRE": "delta", "NARWHAL_RELAY": "1"},
])
def test_config_readers_match(monkeypatch, env):
    for k in ("NARWHAL_RELAY", "NARWHAL_RELAY_FANOUT", "NARWHAL_HEADER_WIRE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for params in ({}, {"relay_fanout": 0}, {"relay_fanout": 5, "header_wire": "full"}):
        t_params = replace(t_config.Parameters(), **params)
        j_params = replace(j_config.Parameters(), **params)
        assert t_config.relay_fanout_effective(t_params) == \
            j_config.relay_fanout_effective(j_params)
        assert t_config.header_wire_effective(t_params) == \
            j_config.header_wire_effective(j_params)
