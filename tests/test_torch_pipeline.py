"""The port's certificate path end to end on the CPU: verify -> window sync
-> chain_commit through `narwhal_tpu_torch.gpu.pipeline`, held against the
JAX package's host `Bullshark` fed the same fully signed stream one
certificate at a time (the stream is built by each package's own
fixtures from the same seeds, so the two carry identical bytes). The
full-format stream goes through the item lane, its compact form through the
group lane (the msm kernel's plain version)."""

import pytest

from narwhal_tpu.consensus import Bullshark, ConsensusState as JState
from narwhal_tpu.fixtures import CommitteeFixture as JFixture
from narwhal_tpu.fixtures import make_signed_certificates as j_make_signed
from narwhal_tpu.stores import NodeStorage as JStorage
from narwhal_tpu.types import Certificate as JCert
from narwhal_tpu_torch.consensus import ConsensusState
from narwhal_tpu_torch.fixtures import CommitteeFixture, make_signed_certificates
from narwhal_tpu_torch.gpu.dag_kernels import GpuBullshark
from narwhal_tpu_torch.gpu.pipeline import FusedCertificatePipeline
from narwhal_tpu_torch.gpu.verifier import GpuVerifier
from narwhal_tpu_torch.stores import NodeStorage
from narwhal_tpu_torch.types import Certificate

ROUNDS = 6


@pytest.fixture(scope="module")
def streams():
    jf, f = JFixture(size=4), CommitteeFixture(size=4)
    jc, _ = j_make_signed(jf, 1, ROUNDS, {c.digest for c in JCert.genesis(jf.committee)})
    c, _ = make_signed_certificates(f, 1, ROUNDS, {x.digest for x in Certificate.genesis(f.committee)})
    assert [x.to_bytes() for x in jc] == [x.to_bytes() for x in c]
    return jf, f, jc, c


def _pipeline(f, depth=2):
    verifier = GpuVerifier(max_bucket=32, mode="item", fixed_bucket=True, device="cpu")
    state = ConsensusState(Certificate.genesis(f.committee))
    engine = GpuBullshark(f.committee, NodeStorage(None).consensus_store, 50, device="cpu")
    return FusedCertificatePipeline(verifier, engine, state, depth=depth), state


def test_pipeline_matches_jax_host_bullshark(streams):
    jf, f, jc, c = streams
    host_state = JState(JCert.genesis(jf.committee))
    host = Bullshark(jf.committee, JStorage(None).consensus_store, 50)
    want, i = [], 0
    for cert in jc:
        outs = host.process_certificate(host_state, i, cert)
        i += len(outs)
        want.extend((o.certificate.digest, o.consensus_index) for o in outs)
    assert want

    pipe, state = _pipeline(f)
    for lo in range(0, len(c), 8):  # 8 certificates x 4 votes = one 32 bucket
        pipe.feed(c[lo:lo + 8])
        assert len(pipe._inflight) <= pipe.depth
    out = pipe.drain()
    assert not pipe.rejected
    assert [(o.certificate.digest, o.consensus_index) for o in out] == want
    assert {k.hex(): v for k, v in state.last_committed.items()} == {
        k.hex(): v for k, v in host_state.last_committed.items()
    }


def test_pipeline_rejects_bad_signatures(streams):
    """A certificate with a corrupted vote signature is rejected by the
    verify stage and never reaches the window; its batch-mates are placed."""
    _jf, f, _jc, c = streams
    good = c[:7]
    victim = c[7]
    bad = Certificate(victim.header, victim.signers, victim.signatures[:-1] + (b"\x00" * 64,))
    pipe, _state = _pipeline(f, depth=1)
    pipe.run([good + [bad]])
    assert pipe.rejected == [bad]
    win = pipe.engine.win
    idx = f.committee.index_of(bad.origin)
    assert win.present[win._off(bad.round), idx] == 0
    for cert in good:
        assert win.present[win._off(cert.round), f.committee.index_of(cert.origin)] == 1


def _compact(cert):
    """The compact (half-aggregated) form of a full certificate, built from
    its own vote signatures with no committee, so no verdict is pre-seeded."""
    if cert.is_genesis():
        return cert
    return Certificate.compact_from_votes(cert.header, cert.signers, cert.signatures)


def _host_sequence(jf, jc):
    host_state = JState(JCert.genesis(jf.committee))
    host = Bullshark(jf.committee, JStorage(None).consensus_store, 50)
    want, i = [], 0
    for cert in jc:
        outs = host.process_certificate(host_state, i, cert)
        i += len(outs)
        want.extend((o.certificate.digest, o.consensus_index) for o in outs)
    return want


def _group_pipeline(f):
    verifier = GpuVerifier(max_bucket=64, mode="item", fixed_bucket=False, device="cpu")
    state = ConsensusState(Certificate.genesis(f.committee))
    engine = GpuBullshark(f.committee, NodeStorage(None).consensus_store, 50, device="cpu")
    return FusedCertificatePipeline(verifier, engine, state), state


def test_pipeline_compact_stream_matches_jax_host_bullshark(streams):
    """Compact certificates go through the group lane; a compact
    certificate's digest is its header's, so the commit sequence equals the
    JAX host Bullshark's over the full-format stream."""
    jf, f, jc, c = streams
    want = _host_sequence(jf, jc)
    assert want
    pipe, _state = _group_pipeline(f)
    compact = [_compact(x) for x in c]
    assert all(x.is_compact for x in compact)
    for lo in range(0, len(compact), 8):  # 8 groups x 4 signers x 2 rows = 64
        pipe.feed(compact[lo:lo + 8])
    out = pipe.drain()
    assert not pipe.rejected
    assert [(o.certificate.digest, o.consensus_index) for o in out] == want


def test_pipeline_mixed_full_and_compact_batches(streams):
    """One batch carries both wire forms (items and groups in flight
    together); verdicts route back to the right certificates."""
    jf, f, jc, c = streams
    pipe, _state = _group_pipeline(f)
    mixed = [_compact(x) if i % 2 else x for i, x in enumerate(c)]
    bad_full = mixed[10]
    assert not bad_full.is_compact
    mixed[10] = Certificate(bad_full.header, bad_full.signers,
                            bad_full.signatures[:-1] + (b"\x00" * 64,))
    for lo in range(0, len(mixed), 6):
        pipe.feed(mixed[lo:lo + 6])
    out = pipe.drain()
    assert pipe.rejected == [mixed[10]]
    want = _host_sequence(jf, [x for i, x in enumerate(jc) if i != 10])
    assert want
    assert [(o.certificate.digest, o.consensus_index) for o in out] == want


def test_pipeline_rejects_forged_aggregate(streams, monkeypatch):
    """A compact certificate whose agg_s has one bit flipped is rejected,
    exactly it; the others of its chunk are accepted after the solo
    re-launch, and only the forged group is re-checked on the host."""
    from narwhal_tpu_torch import types as types_mod

    _jf, f, _jc, c = streams
    compact = [_compact(x) for x in c[:8]]
    victim = compact[5]
    forged = Certificate(victim.header, victim.signers, victim.signatures,
                         bytes([victim.agg_s[0] ^ 0x04]) + victim.agg_s[1:])
    compact[5] = forged
    host_calls = []
    real_host = types_mod.host_verify_aggregate
    monkeypatch.setattr(types_mod, "host_verify_aggregate",
                        lambda *g: host_calls.append(g) or real_host(*g))
    pipe, _state = _group_pipeline(f)
    pipe.run([compact])
    assert pipe.rejected == [forged]
    assert len(host_calls) == 1
    win = pipe.engine.win
    assert win.present[win._off(forged.round), f.committee.index_of(forged.origin)] == 0
    for cert in compact[:5] + compact[6:]:
        assert win.present[win._off(cert.round), f.committee.index_of(cert.origin)] == 1


class _SpanLog:
    """The tracer interface the pipeline calls, keeping every span."""

    enabled = True

    def __init__(self):
        self.spans: list[tuple] = []

    def sampled(self, key) -> bool:
        return True

    def span(self, name, key, t0, t1, attrs=None) -> None:
        self.spans.append((name, key, t0, t1))


def test_pipeline_spans_time_each_stage(streams, monkeypatch):
    """Each batch's staging splits device_pack into two real intervals, and
    device_mask_readback covers the copies alone: the group lane's msm
    epilogue and host re-checks fall inside group_epilogue."""
    from narwhal_tpu_torch import clock
    from narwhal_tpu_torch import types as types_mod
    from narwhal_tpu_torch.gpu import verifier as verifier_mod

    _jf, f, _jc, c = streams
    mixed = [_compact(x) if i % 2 else x for i, x in enumerate(c)]
    victim = mixed[9]
    assert victim.is_compact
    mixed[9] = Certificate(victim.header, victim.signers, victim.signatures,
                           bytes([victim.agg_s[0] ^ 0x04]) + victim.agg_s[1:])
    calls = []

    def timed(module, name):
        real = getattr(module, name)

        def wrapper(*args):
            t0 = clock.now()
            try:
                return real(*args)
            finally:
                calls.append((name, t0, clock.now()))

        monkeypatch.setattr(module, name, wrapper)

    timed(verifier_mod, "msm_epilogue_check")
    timed(types_mod, "host_verify_aggregate")
    pipe, _state = _group_pipeline(f)
    log = _SpanLog()
    pipe.tracer = log
    for lo in range(0, len(mixed), 6):
        pipe.feed(mixed[lo:lo + 6])
    pipe.drain()
    assert pipe.rejected == [mixed[9]]
    by_name: dict = {}
    for name, key, t0, t1 in log.spans:
        by_name.setdefault(name, {})[key] = (t0, t1)
    batches = by_name["device_pack"]
    assert len(batches) == -(-len(mixed) // 6)
    for key, (p0, p1) in batches.items():
        i0, i1 = by_name["pack_items"][key]
        g0, g1 = by_name["pack_groups"][key]
        assert p0 == i0 <= i1 == g0 <= g1 == p1
        r0, r1 = by_name["device_mask_readback"][key]
        e0, e1 = by_name["item_epilogue"][key]
        q0, q1 = by_name["group_epilogue"][key]
        assert r0 <= r1 == e0 <= e1 == q0 <= q1
    assert {n for n, *_ in calls} == {"msm_epilogue_check", "host_verify_aggregate"}
    for _name, t0, t1 in calls:
        assert any(q0 <= t0 <= t1 <= q1 for q0, q1 in by_name["group_epilogue"].values())
        assert not any(r0 < t1 and t0 < r1 for r0, r1 in by_name["device_mask_readback"].values())
