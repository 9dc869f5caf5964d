"""The port's `worker/` and `pacing` against the JAX package's.

- The JAX package's worker scenarios (`tests/test_worker.py`) run against
  the port: the module's source with the package name swapped.
- A mixed committee of 4, two port workers and two JAX workers on real
  loopback TCP with authentication, disseminates batches through
  `chip_smoke.worker_wire` (the `wire` path's second leg): every
  transaction in exactly one batch, the same digests and bytes in every
  store, each batch quorum-acknowledged before its author's primary hears
  of it, one OurBatchMsg to the author's primary and one OthersBatchMsg to
  every other, and a new worker of the other package synchronizing every
  batch from both packages' workers.
- `chip_smoke.certificate_wire` (the `wire` path's first leg) over each
  package's network hands its consumer the signed stream byte for byte.
- `PacingController`, `BackpressureState`, `IngestGate` and
  `backpressure_level` give equal outputs on seeded traces, and the
  worker's environment knobs keep their names.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import narwhal_tpu.channels as j_channels
import narwhal_tpu.config as j_config
import narwhal_tpu.crypto as j_crypto
import narwhal_tpu.fixtures as j_fixtures
import narwhal_tpu.messages as j_messages
import narwhal_tpu.network as j_network
import narwhal_tpu.pacing as j_pacing
import narwhal_tpu.stores as j_stores
import narwhal_tpu.types as j_types
import narwhal_tpu.worker as j_worker
import narwhal_tpu_torch.fixtures as t_fixtures
import narwhal_tpu_torch.pacing as t_pacing
import narwhal_tpu_torch.stores as t_stores
import narwhal_tpu_torch.worker as t_worker
from test_torch_network import force_hash_branch, port_scenarios

TESTS = Path(__file__).resolve().parent


_SCENARIOS = port_scenarios("test_worker.py")
assert not set(_SCENARIOS) & set(globals())
globals().update(_SCENARIOS)

PORT = chip_smoke.wire_modules()
JAX = types.SimpleNamespace(channels=j_channels, config=j_config, crypto=j_crypto,
                            fixtures=j_fixtures, messages=j_messages, network=j_network,
                            stores=j_stores, types=j_types, worker=j_worker)


def test_all_reference_worker_scenarios_collected():
    ref = set(re.findall(r"^def (test_\w+)", (TESTS / "test_worker.py").read_text(), re.M))
    assert set(_SCENARIOS) == ref and len(ref) >= 6


@pytest.mark.parametrize("sync", ["port", "jax"])
def test_mixed_committee_disseminates_batches(run, tmp_path, sync):
    """Authorities 0 and 1 run port workers, 2 and 3 JAX workers; clients
    submit to workers 0 (port) and 2 (JAX). Authority 3's worker is then
    replaced by a `sync` worker on an empty store that fetches every batch."""
    out = run(chip_smoke.worker_wire(
        [PORT, PORT, JAX, JAX], str(tmp_path), clients=2, txs_per_client=60, chunk=20,
        parameters={"batch_size": 8_000, "max_batch_delay": 0.05},
        sync_mods=PORT if sync == "port" else JAX, timeout=60.0), timeout=90.0)
    assert out["transactions"] == 120 and out["batches"] >= 2
    assert out["quorum"] == 3 and out["synchronized"] == out["batches"]


@pytest.mark.parametrize("aead", ["openssl", "hash"])
def test_port_committee_on_both_aead_branches(run, tmp_path, monkeypatch, aead):
    if aead == "hash":
        force_hash_branch(monkeypatch)
    elif not PORT.network.auth._HAVE_OPENSSL:
        pytest.skip("the OpenSSL branch needs the cryptography package")
    assert chip_smoke.aead_branch(PORT).startswith("blake2b" if aead == "hash" else "AES")
    out = run(chip_smoke.worker_wire([PORT] * 5, str(tmp_path), clients=2, txs_per_client=40,
                                     chunk=10, timeout=60.0), timeout=90.0)
    assert out["transactions"] == 80 and out["quorum"] == 4


@pytest.mark.slow
def test_port_committee_of_50(run, tmp_path):
    out = run(chip_smoke.worker_wire([PORT] * 50, str(tmp_path), clients=10,
                                     txs_per_client=100, timeout=300.0), timeout=400.0)
    assert out["transactions"] == 1000 and out["quorum"] == 34


# -- pacing ---------------------------------------------------------------


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def test_pacing_controller_traces_equal():
    rng = np.random.default_rng(3)
    for _ in range(5):
        kw = dict(ceiling=float(rng.uniform(0.01, 0.5)), floor=float(rng.uniform(0, 0.2)),
                  low_occupancy=float(rng.uniform(0, 0.4)),
                  high_occupancy=float(rng.uniform(0.2, 0.9)),
                  ewma_alpha=float(rng.uniform(0.05, 0.9)))
        occ = {"v": 0.0}
        mine = t_pacing.PacingController(sources=[lambda: occ["v"]], **kw)
        ref = j_pacing.PacingController(sources=[lambda: occ["v"]], **kw)
        for v in rng.uniform(-0.2, 1.2, 200):
            occ["v"] = float(v)
            assert mine.delay() == ref.delay()
        for v in rng.uniform(-0.2, 1.2, 20):
            assert mine.observe(float(v)) == ref.observe(float(v))


def test_backpressure_state_and_ingest_gate_traces_equal(run):
    rng = np.random.default_rng(4)
    clock_t, clock_j = Clock(), Clock()
    bp_t = t_pacing.BackpressureState(high=0.7, low=0.4, stale_after=1.0, clock=clock_t)
    bp_j = j_pacing.BackpressureState(high=0.7, low=0.4, stale_after=1.0, clock=clock_j)
    local = {"v": 0.0}
    gate_t = t_pacing.IngestGate("shed", [lambda: local["v"]], bp_t, high=0.8, low=0.3)
    gate_j = j_pacing.IngestGate("shed", [lambda: local["v"]], bp_j, high=0.8, low=0.3)
    for step in range(400):
        dt = float(rng.exponential(0.3))
        clock_t.t += dt
        clock_j.t += dt
        if rng.random() < 0.5:
            level = float(rng.uniform(-0.1, 1.1))
            bp_t.update(level)
            bp_j.update(level)
        local["v"] = float(rng.uniform(0, 1))
        assert bp_t.level() == bp_j.level(), step
        assert bp_t.overloaded() == bp_j.overloaded(), step
        assert gate_t.level() == gate_j.level(), step
        assert gate_t.admits() == gate_j.admits(), step

    async def shed():
        local["v"] = 1.0
        outcomes = []
        for gate in (gate_t, gate_j):
            try:
                await gate.admit()
                outcomes.append("admitted")
            except Exception as e:
                outcomes.append((type(e).__name__, str(e)))
        return outcomes

    mine, ref = run(shed())
    assert mine == ref and mine[0] == "IngestOverloadError"
    assert mine[1].startswith(t_pacing.RESOURCE_EXHAUSTED + ": ")
    with pytest.raises(ValueError):
        t_pacing.IngestGate("drop")


def test_backpressure_level_equal():
    rng = np.random.default_rng(5)
    for _ in range(300):
        occ = list(rng.uniform(-0.5, 1.5, int(rng.integers(0, 4))))
        ewma = None if rng.random() < 0.3 else float(rng.uniform(0, 3))
        since = None if rng.random() < 0.3 else float(rng.uniform(0, 3))
        args = (occ, ewma, since, float(rng.uniform(0, 2)), float(rng.uniform(0.1, 1)))
        assert t_pacing.backpressure_level(*args) == j_pacing.backpressure_level(*args)


@pytest.mark.parametrize("env", [{}, {"NARWHAL_INGEST_POLICY": "block"},
                                 {"NARWHAL_PACING": "0"},
                                 {"NARWHAL_BATCH_DELAY_FLOOR": "0.03"},
                                 {"NARWHAL_BATCH_DELAY_FLOOR": "fast"}])
def test_worker_environment_knobs_keep_their_names(monkeypatch, env):
    for k in ("NARWHAL_INGEST_POLICY", "NARWHAL_PACING", "NARWHAL_BATCH_DELAY_FLOOR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def knobs(fixtures, worker_mod, stores):
        f = fixtures.CommitteeFixture(size=4)
        a = f.authorities[0]
        w = worker_mod.Worker(a.public, 0, f.committee, f.worker_cache, f.parameters,
                              stores.NodeStorage(None).batch_store)
        pacing = w.batch_pacing
        return (w.ingest_gate.policy, pacing is None,
                None if pacing is None else (pacing.floor, pacing.ceiling))

    assert knobs(t_fixtures, t_worker, t_stores) == knobs(j_fixtures, j_worker, j_stores)


# -- the wire path's first leg --------------------------------------------


def signed_stream(m):
    """Four signed rounds of a committee of 7 from package `m`, the tenth
    certificate forged (one vote signature's S)."""
    f = m.fixtures.CommitteeFixture(size=7)
    genesis = {c.digest for c in m.types.Certificate.genesis(f.committee)}
    certs, _ = m.fixtures.make_signed_certificates(f, 1, 4, genesis)
    sigs = list(certs[9].signatures)
    sigs[2] = sigs[2][:40] + bytes([sigs[2][40] ^ 0x10]) + sigs[2][41:]
    certs[9] = m.types.Certificate(certs[9].header, certs[9].signers, tuple(sigs))
    return f, certs


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_certificates_over_the_wire_arrive_as_sent(run, pkg):
    """`chip_smoke.certificate_wire` over each package's network: the
    consumer is handed the signed stream (a forged certificate included)
    byte for byte, whole rounds in order, in batches of the given size;
    both packages' networks hand over the same bytes."""
    m = PORT if pkg == "port" else JAX
    f, certs = signed_stream(m)
    fed = []
    out = run(chip_smoke.certificate_wire(m, f, certs, 5, fed.append), timeout=60.0)
    assert [len(b) for b in fed] == [5] * 5 + [3]
    got = [c.to_bytes() for b in fed for c in b]
    assert got == [c.to_bytes() for c in signed_stream(PORT)[1]]
    assert got == [c.to_bytes() for c in signed_stream(JAX)[1]]
    assert out["senders"] == 6 and out["handled"] - out["resent"] == 24
    assert [who for who, _ in out["refused"]] == ["outside key", "no credentials"]
