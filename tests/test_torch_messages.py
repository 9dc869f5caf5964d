"""The port's `messages` against the JAX package's: the same registry, the
same wire bytes for every registered message, decodes that agree across
the packages, and the same process-wide decode cache.

Instances are made from a seed (numpy) once per package by the same
maker, so the two sides are built independently and must encode to the
same bytes. `BackpressureMsg` and `RelayMsg`, which the JAX package's fuzz
registry has no strategy for, get hypothesis strategies here.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import narwhal_tpu.messages as j_messages
import narwhal_tpu.types as j_types
import narwhal_tpu_torch.messages as t_messages
import narwhal_tpu_torch.types as t_types

SEEDS = (0, 1, 2)


class Draw:
    """Seeded field values: the same seed gives the same values in both
    packages' makers."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def bytes(self, n: int) -> bytes:
        return self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def d(self) -> bytes:  # a digest or a public key
        return self.bytes(32)

    def sig(self) -> bytes:
        return self.bytes(64)

    def n(self, hi: int = 2**31) -> int:
        return int(self.rng.integers(0, hi))

    def small(self) -> int:
        return self.n(1000)

    def k(self, hi: int = 4) -> int:  # a sequence length
        return self.n(hi)

    def ds(self) -> tuple:
        return tuple(self.d() for _ in range(self.k()))

    def blob(self) -> bytes:
        return self.bytes(self.n(96))

    def text(self) -> str:
        return "".join(chr(0x41 + self.n(58)) for _ in range(self.n(24))) + "é✓"

    def signers(self) -> tuple:
        return tuple(sorted(set(int(i) for i in self.rng.integers(0, 200, self.k(5)))))

    def header(self, T):
        return T.Header(
            author=self.d(), round=self.n(), epoch=self.small(),
            payload={self.d(): self.n() for _ in range(self.k())},
            parents=frozenset(self.ds()), signature=self.sig())

    def vote(self, T):
        return T.Vote(self.d(), self.n(), self.small(), self.d(), self.d(), self.sig())

    def certificate(self, T):
        header, signers = self.header(T), self.signers()
        if self.n(2):  # compact: 32-byte nonce points and an aggregate scalar
            return T.Certificate(header, signers, tuple(self.d() for _ in signers), self.d())
        return T.Certificate(header, signers, tuple(self.sig() for _ in signers))


def _stream(M, g):
    txs = tuple(g.blob() for _ in range(g.k()))
    return M.SubmitTransactionStreamMsg(txs)


# Class name -> maker(M, T, g): M the package's messages module, T its types.
BUILD = {
    "Ack": lambda M, T, g: M.Ack(),
    "HeaderMsg": lambda M, T, g: M.HeaderMsg(g.header(T)),
    "VoteMsg": lambda M, T, g: M.VoteMsg(g.vote(T)),
    "CertificateMsg": lambda M, T, g: M.CertificateMsg(g.certificate(T)),
    "CertificatesRequest": lambda M, T, g: M.CertificatesRequest(g.ds(), g.d()),
    "CertificatesBatchRequest": lambda M, T, g: M.CertificatesBatchRequest(g.ds(), g.d()),
    "CertificatesBatchResponse": lambda M, T, g: M.CertificatesBatchResponse(tuple(
        (g.d(), g.certificate(T) if g.n(2) else None) for _ in range(g.k(3)))),
    "CertificatesRangeRequest": lambda M, T, g: M.CertificatesRangeRequest(g.n(), g.n(),
                                                                           g.d()),
    "CertificatesRangeResponse": lambda M, T, g: M.CertificatesRangeResponse(g.ds()),
    "PayloadAvailabilityRequest": lambda M, T, g: M.PayloadAvailabilityRequest(g.ds(), g.d()),
    "PayloadAvailabilityResponse": lambda M, T, g: M.PayloadAvailabilityResponse(tuple(
        (g.d(), bool(g.n(2))) for _ in range(g.k()))),
    "SynchronizeMsg": lambda M, T, g: M.SynchronizeMsg(g.ds(), g.d()),
    "CleanupMsg": lambda M, T, g: M.CleanupMsg(g.n()),
    "RequestBatchMsg": lambda M, T, g: M.RequestBatchMsg(g.d()),
    "DeleteBatchesMsg": lambda M, T, g: M.DeleteBatchesMsg(g.ds()),
    "ReconfigureMsg": lambda M, T, g: M.ReconfigureMsg(g.text(), g.text()),
    "RequestBatchesMsg": lambda M, T, g: M.RequestBatchesMsg(g.ds()),
    "BackpressureMsg": lambda M, T, g: M.BackpressureMsg(g.n(10_001)),
    "OurBatchMsg": lambda M, T, g: M.OurBatchMsg(g.d(), g.n()),
    "OthersBatchMsg": lambda M, T, g: M.OthersBatchMsg(g.d(), g.n()),
    "RequestedBatchMsg": lambda M, T, g: M.RequestedBatchMsg(g.d(), g.blob(), bool(g.n(2))),
    "DeletedBatchesMsg": lambda M, T, g: M.DeletedBatchesMsg(g.ds()),
    "WorkerErrorMsg": lambda M, T, g: M.WorkerErrorMsg(g.text()),
    "RequestedBatchesMsg": lambda M, T, g: M.RequestedBatchesMsg(tuple(
        (g.d(), bool(g.n(2)), g.blob()) for _ in range(g.k(3)))),
    "WorkerBatchMsg": lambda M, T, g: M.WorkerBatchMsg(
        T.Batch(tuple(g.blob() for _ in range(g.k()))).to_bytes()),
    "WorkerBatchRequest": lambda M, T, g: M.WorkerBatchRequest(g.ds()),
    "WorkerBatchResponse": lambda M, T, g: M.WorkerBatchResponse(
        tuple(g.blob() for _ in range(g.k(3)))),
    "SubmitTransactionMsg": lambda M, T, g: M.SubmitTransactionMsg(g.blob()),
    "SubmitTransactionStreamMsg": lambda M, T, g: _stream(M, g),
    "GetCollectionsRequest": lambda M, T, g: M.GetCollectionsRequest(g.ds()),
    "GetCollectionsResponse": lambda M, T, g: M.GetCollectionsResponse(tuple(
        (g.d(), tuple((g.d(), tuple(g.blob() for _ in range(g.k(2))))
                      for _ in range(g.k(2))), g.text())
        for _ in range(g.k(2)))),
    "RemoveCollectionsRequest": lambda M, T, g: M.RemoveCollectionsRequest(g.ds()),
    "ReadCausalRequest": lambda M, T, g: M.ReadCausalRequest(g.d()),
    "ReadCausalResponse": lambda M, T, g: M.ReadCausalResponse(g.ds()),
    "RoundsRequest": lambda M, T, g: M.RoundsRequest(g.d()),
    "RoundsResponse": lambda M, T, g: M.RoundsResponse(g.n(), g.n()),
    "NodeReadCausalRequest": lambda M, T, g: M.NodeReadCausalRequest(g.d(), g.n()),
    "NewNetworkInfoRequest": lambda M, T, g: M.NewNetworkInfoRequest(g.n(), tuple(
        (g.d(), g.n(), g.text()) for _ in range(g.k(3)))),
    "GetPrimaryAddressRequest": lambda M, T, g: M.GetPrimaryAddressRequest(),
    "GetPrimaryAddressResponse": lambda M, T, g: M.GetPrimaryAddressResponse(g.text()),
    "NewEpochRequest": lambda M, T, g: M.NewEpochRequest(g.n()),
    "CertificateRefMsg": lambda M, T, g: (lambda s: M.CertificateRefMsg(
        g.d(), g.n(), g.small(), g.d(), s, tuple(g.d() for _ in s), g.d()))(g.signers()),
    "RelayMsg": lambda M, T, g: (lambda inner: M.RelayMsg(
        g.d(), g.n(), g.small(), *M.encode_message(inner)))(M.VoteMsg(g.vote(T))),
    "RelayAckMsg": lambda M, T, g: M.RelayAckMsg(g.d(), g.d()),
    "DeltaHeaderMsg": lambda M, T, g: M.DeltaHeaderMsg(
        g.d(), g.n(), g.small(), g.d(), tuple((g.d(), g.n()) for _ in range(g.k())),
        g.signers(), g.sig()),
    "HeaderResyncRequest": lambda M, T, g: M.HeaderResyncRequest(g.d(), g.d(), g.n(), g.d()),
    "HeaderResyncResponse": lambda M, T, g: M.HeaderResyncResponse(
        tuple(g.header(T) for _ in range(g.k(3)))),
    "CertificateDeltaMsg": lambda M, T, g: (lambda s: M.CertificateDeltaMsg(
        g.d(), g.n(), g.small(), g.d(), s, tuple(g.sig() for _ in s)))(g.signers()),
    "Relay2Msg": lambda M, T, g: M.Relay2Msg(g.small(), g.n(), g.small(), g.n(3), g.blob()),
    "RelayAck2Msg": lambda M, T, g: M.RelayAck2Msg(g.d(), g.small()),
    "Vote2Msg": lambda M, T, g: M.Vote2Msg(g.d(), g.d(), g.sig()),
    "TelemetryScrapeMsg": lambda M, T, g: M.TelemetryScrapeMsg(),
    "TelemetryScrapeResponse": lambda M, T, g: M.TelemetryScrapeResponse(g.text()),
    "FlightDumpMsg": lambda M, T, g: M.FlightDumpMsg(g.n()),
    "FlightDumpResponse": lambda M, T, g: M.FlightDumpResponse(g.blob()),
}

# Decoded lazily into the wire form: fields differ from the built instance,
# the transactions and the bytes do not.
NORMALIZING = {"SubmitTransactionStreamMsg"}


def plain(x):
    """A value with every dataclass of either package turned into
    (class name, fields), so objects of the two packages compare."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, plain(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, (tuple, list)):
        return tuple(plain(v) for v in x)
    if isinstance(x, frozenset):
        return ("frozenset", tuple(sorted(x)))
    if isinstance(x, dict) or type(x).__name__ == "mappingproxy":
        return ("map", tuple(sorted((k, plain(v)) for k, v in x.items())))
    return x


def fields_of(name: str, msg):
    if name in NORMALIZING:
        return msg.txs
    return plain(msg)


def test_registries_have_the_same_tags_and_names():
    assert {t: c.__name__ for t, c in t_messages.REGISTRY.items()} == {
        t: c.__name__ for t, c in j_messages.REGISTRY.items()}
    assert set(BUILD) == {c.__name__ for c in t_messages.REGISTRY.values()}
    for cls in t_messages.REGISTRY.values():
        assert cls.__module__ == "narwhal_tpu_torch.messages"


@pytest.mark.parametrize("name", sorted(BUILD))
def test_wire_bytes_equal_and_decode_across(name):
    for seed in SEEDS:
        mine = BUILD[name](t_messages, t_types, Draw(seed))
        ref = BUILD[name](j_messages, j_types, Draw(seed))
        tag, body = t_messages.encode_message(mine)
        assert (tag, body) == j_messages.encode_message(ref), (name, seed)
        assert t_messages.REGISTRY[tag].__name__ == name
        # The reference's bytes decode in the port, and the port's in the
        # reference, to the fields the other side built.
        into_port = t_messages.decode_message(tag, body)
        into_ref = j_messages.decode_message(tag, body)
        assert type(into_port).__module__ == "narwhal_tpu_torch.messages"
        assert fields_of(name, into_port) == fields_of(name, ref)
        assert fields_of(name, into_ref) == fields_of(name, mine)
        # Canonical: re-encoding a decode is a fixed point in both.
        assert t_messages.encode_message(into_port)[1] == body
        assert j_messages.encode_message(into_ref)[1] == body


@pytest.mark.parametrize("M,T", [(t_messages, t_types), (j_messages, j_types)],
                         ids=["port", "jax"])
def test_decode_cache_shares_small_bodies_only(M, T):
    g = Draw(7)
    small = M.encode_message(M.CertificateMsg(g.certificate(T)))
    first = M.decode_message(*small)
    assert M.decode_message(small[0], bytes(bytearray(small[1]))) is first
    # The shared object is the one the reference shares too: the header's
    # payload mapping included (ROADMAP queue 3 keeps this on purpose).
    assert M.decode_message(*small).certificate.header.payload is \
        first.certificate.header.payload
    big = M.encode_message(M.WorkerBatchMsg(T.Batch((g.bytes(70_000),)).to_bytes()))
    assert len(big[1]) > M._DECODE_MAX_BODY == 1 << 16
    one, two = M.decode_message(*big), M.decode_message(*big)
    assert one is not two and one == two
    at_limit = M.encode_message(M.WorkerBatchMsg(g.bytes(1 << 16)))
    assert len(at_limit[1]) == 1 << 16
    assert M.decode_message(*at_limit) is M.decode_message(*at_limit)


# -- port-only fuzz strategies (the JAX fuzz registry has none for these) --

_pubkey = st.binary(min_size=32, max_size=32)
backpressure_msgs = st.builds(t_messages.BackpressureMsg, st.integers(0, 10_000))
relay_msgs = st.builds(
    t_messages.RelayMsg,
    origin=_pubkey,
    round=st.integers(0, 2**62),
    epoch=st.integers(0, 2**62),
    inner_tag=st.sampled_from(sorted(t_messages.REGISTRY)),
    inner_body=st.binary(max_size=200),
)


@settings(max_examples=60, deadline=None)
@given(msg=st.one_of(backpressure_msgs, relay_msgs))
def test_fuzz_backpressure_and_relay_roundtrip_and_match_the_reference(msg):
    tag, body = t_messages.encode_message(msg)
    back = t_messages.decode_message(tag, body)
    assert back == msg
    assert t_messages.encode_message(back)[1] == body
    ref = j_messages.decode_message(tag, body)
    assert plain(ref) == plain(msg)
    assert j_messages.encode_message(ref) == (tag, body)


@settings(max_examples=40, deadline=None)
@given(level=st.floats(-1.0, 2.0, allow_nan=False))
def test_fuzz_backpressure_level_clamps_like_the_reference(level):
    mine = t_messages.BackpressureMsg.from_level(level)
    ref = j_messages.BackpressureMsg.from_level(level)
    assert mine.level_bp == ref.level_bp and 0 <= mine.level_bp <= 10_000
    assert mine.level == ref.level
