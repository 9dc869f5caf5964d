"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card (the CPU tests of
the same functions are the parity tests in tests/test_torch_*.py). This
file imports only torch, numpy, the port and `chip_smoke.py` (for its
inputs), so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Exact everywhere: verdicts, masks and validity are compared bit for bit;
msm_accumulate's, msm_window's and the shard reduce's window lanes and
verify_straus's accumulators as affine points, verify_decompress's
coordinates mod p (the kernels write canonical limbs, the plain versions
loose ones; both are the same values).
"""

import asyncio
import random

import numpy as np
import pytest
import torch

import chip_smoke
from narwhal_tpu_torch.crypto import KeyPair
from narwhal_tpu_torch.gpu import dag_kernels as td
from narwhal_tpu_torch.gpu import ed25519 as tk
from narwhal_tpu_torch.gpu import kernel_registry
from narwhal_tpu_torch.gpu.verifier import GpuVerifier

pytestmark = pytest.mark.cuda


def _need_card(kernel: str, source: str) -> None:
    if not torch.cuda.is_available():
        pytest.skip(f"{kernel} CUDA kernel ({source}) needs a card")


def _window(seed, w, n, density=0.7):
    rng = np.random.default_rng(seed)
    parent = (rng.random((w, n, n)) < density).astype(np.uint8)
    present = (rng.random((w, n)) < 0.85).astype(np.uint8)
    return rng, torch.from_numpy(parent).cuda(), torch.from_numpy(present).cuda()


def test_verify_batch_kernel_matches_plain():
    _need_card("verify_batch", "csrc/ed25519_verify.cu")
    rng = random.Random(1)
    items = []
    for i in range(40):
        kp = KeyPair.from_seed(bytes([i]) * 32)
        msg = bytes([i]) * (1 + i % 9)
        sig = kp.sign(msg)
        if i % 3 == 1:
            bad = bytearray(sig)
            bad[32 + rng.randrange(31)] ^= 1 << rng.randrange(8)
            sig = bytes(bad)
        items.append((kp.public, msg, sig))
    v = GpuVerifier(mode="item", device="cuda")
    idx, packed = v.pack(items)
    arrays = GpuVerifier.bucket_arrays(packed, 0, idx.size, 64 - idx.size)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    kernel_registry.reset_launch_counts()
    got = tk.verify_batch(*t)
    assert kernel_registry.launch_counts()["verify_batch"] == 1
    plain = tk.verify_batch_plain(*t)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert v(items) == [i % 3 != 1 for i in range(40)]


def test_verify_batch_kernel_matches_plain_full_bucket():
    """A1 at the main path's 2048 bucket, bit-equal after the field layer
    moved to csrc/ed25519_field.cuh."""
    _need_card("verify_batch", "csrc/ed25519_verify.cu")
    arrays, _checked, _m = chip_smoke.signature_bucket(7, 120, 2048)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    got, plain = tk.verify_batch(*t), tk.verify_batch_plain(*t)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


@pytest.mark.parametrize("bucket", [64, 2048])
def test_msm_accumulate_kernel_matches_plain(bucket):
    """A2 in the group-lane shape (compact proofs as doubled rows, zero
    padding, the R slot all zero) and the item shape (real R and z digits, a
    torsion row, an invalid encoding): validity bit-equal, every window lane
    equal as an affine point, the epilogue verdict equal."""
    _need_card("msm_accumulate", "csrc/ed25519_msm.cu")
    from narwhal_tpu_torch.fixtures import CommitteeFixture
    from narwhal_tpu_torch.gpu.verifier import msm_epilogue_check

    f = CommitteeFixture(size=4 if bucket == 64 else 50)
    group = chip_smoke.msm_group_bucket(f, bucket)
    item = chip_smoke.msm_item_bucket(3, 40, bucket)
    for arrays, sum_s, want_ok in ((group[0], group[1], True), (item[0], item[1], False)):
        t = [torch.from_numpy(a).cuda() for a in arrays]
        kernel_registry.reset_launch_counts()
        va, vr, valid = tk.msm_accumulate(*t)
        assert kernel_registry.launch_counts()["msm_accumulate"] == 1
        pva, pvr, pvalid = tk.msm_accumulate_plain(*t)
        assert torch.equal(valid, pvalid)
        host = [x.cpu().numpy() for x in (va, vr, pva, pvr)]
        assert chip_smoke._affine_lanes(host[0]) == chip_smoke._affine_lanes(host[2])
        assert chip_smoke._affine_lanes(host[1]) == chip_smoke._affine_lanes(host[3])
        assert msm_epilogue_check(host[0], host[1], sum_s) is want_ok
        assert msm_epilogue_check(host[2], host[3], sum_s) is want_ok
    assert set(np.flatnonzero(~valid.cpu().numpy()).tolist()) == item[2]


@pytest.fixture(scope="module")
def staged_bucket():
    """The item bucket of chip_smoke.signature_bucket at B = 2048 (forged,
    torsion, zero and random-limb rows) on the card, and A3's kernel
    outputs for its A and R sets."""
    if not torch.cuda.is_available():
        pytest.skip("verify_decompress CUDA kernel (csrc/ed25519_staged.cu) needs a card")
    arrays, _checked, _m = chip_smoke.signature_bucket(7, 120, 2048)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    return t, tk.verify_decompress(t[0], t[1]), tk.verify_decompress(t[2], t[3])


def test_verify_decompress_kernel_matches_plain(staged_bucket):
    t, a, r = staged_bucket
    for (pts, valid), y, sign in ((a, t[0], t[1]), (r, t[2], t[3])):
        p_pts, p_valid = tk.verify_decompress_plain(y, sign)
        assert torch.equal(valid, p_valid)
        assert chip_smoke._mod_p(pts.cpu().numpy()) == chip_smoke._mod_p(p_pts.cpu().numpy())
    assert not bool(r[1].all())  # the corrupt R encodings are flagged


def test_staged_kernels_match_plain_and_verify_batch(staged_bucket):
    """A4 equal to its plain version as affine points, A5 bit-equal, and
    A3 -> A4 -> A5 bit-equal to A1 on both lanes."""
    t, (a_pt, a_valid), (r_pt, r_valid) = staged_bucket
    kernel_registry.reset_launch_counts()
    acc = tk.verify_straus(a_pt, t[4], t[5])
    strict, cof = tk.verify_verdict(acc, r_pt, t[2], t[3], a_valid, r_valid)
    counts = kernel_registry.launch_counts()
    assert counts["verify_straus"] == 1 and counts["verify_verdict"] == 1
    chip_smoke._same_points("verify_straus", acc, tk.verify_straus_plain(a_pt, t[4], t[5]))
    p_strict, p_cof = tk.verify_verdict_plain(acc, r_pt, t[2], t[3], a_valid, r_valid)
    assert torch.equal(strict, p_strict) and torch.equal(cof, p_cof)
    m_strict, m_cof = tk.verify_batch(*t)
    assert torch.equal(strict, m_strict) and torch.equal(cof, m_cof)
    assert 0 < int(strict.sum()) < int(cof.sum()) < 2048  # torsion rows: cofactored only


@pytest.mark.parametrize("shape", ["item", "group"])
def test_msm_window_kernel_matches_plain_and_msm_accumulate(shape):
    """A6 over the A (64 lanes) and R (32 lanes) sets of the msm buckets at
    B = 2048, equal to its plain version as affine points; A3 -> A6 equal
    to A2 (lanes as points, validity bit for bit)."""
    _need_card("msm_window", "csrc/ed25519_msm.cu")
    from narwhal_tpu_torch.fixtures import CommitteeFixture

    host = (chip_smoke.msm_item_bucket(3, 40, 2048)[0] if shape == "item"
            else chip_smoke.msm_group_bucket(CommitteeFixture(size=50), 2048)[0])
    t = [torch.from_numpy(a).cuda() for a in host]
    va, vr, valid = tk.msm_accumulate(*t)
    pa, a_valid = tk.verify_decompress(t[0], t[1])
    pr, r_valid = tk.verify_decompress(t[2], t[3])
    for pts, digits, mono in ((pa, t[4], va), (pr, t[5], vr)):
        kernel_registry.reset_launch_counts()
        v = tk.msm_window(pts, digits)
        assert kernel_registry.launch_counts()["msm_window"] == 1
        chip_smoke._same_points("msm_window", v, tk.msm_window_plain(pts, digits))
        chip_smoke._same_points("A3 -> A6 against msm_accumulate", v, mono)
    assert torch.equal(a_valid & r_valid, valid)


@pytest.mark.parametrize("k", [2, 4])
def test_msm_shard_reduce_kernel_matches_plain(k):
    """The reduce over k shards of the msm item bucket's A set equals its
    plain version, and the unsharded A2's V_a, as affine points."""
    _need_card("msm_shard_reduce", "csrc/ed25519_msm.cu")
    t = [torch.from_numpy(a).cuda() for a in chip_smoke.msm_item_bucket(3, 40, 2048)[0]]
    pa, _ = tk.verify_decompress(t[0], t[1])
    n = 2048 // k
    lanes = torch.stack([tk.msm_window(pa[..., i * n:(i + 1) * n].contiguous(),
                                       t[4][i * n:(i + 1) * n]) for i in range(k)])
    got = tk.msm_shard_reduce(lanes)
    chip_smoke._same_points("msm_shard_reduce", got, tk.msm_shard_reduce_plain(lanes))
    chip_smoke._same_points("shards against msm_accumulate", got, tk.msm_accumulate(*t)[0])


@pytest.mark.parametrize("layout", ["one card twice", "every card"])
def test_sharded_verifier_matches_unsharded(layout):
    """GpuVerifier over one card twice (two shards), or over every card
    (which needs two or more), gives the unsharded verifier's verdicts in
    both modes, and launches no monolith."""
    _need_card("the staged kernels", "csrc/ed25519_staged.cu, csrc/ed25519_msm.cu")
    from narwhal_tpu_torch.gpu.verifier import data_mesh

    n_cards = torch.cuda.device_count()
    if layout == "every card" and n_cards < 2:
        pytest.skip("a mesh over every card needs two or more cards")
    mesh = (data_mesh(2, devices=["cuda:0", "cuda:0"]) if layout == "one card twice"
            else data_mesh(n_cards))
    items = []
    for i in range(60):
        kp = KeyPair.from_seed(bytes([i, 9]) * 16)
        msg = b"sharded %d" % i
        items.append((kp.public, msg if i % 7 else msg + b"!", kp.sign(msg)))
    for mode in ("item", "msm"):
        flat = GpuVerifier(max_bucket=64, msm_min_bucket=16, mode=mode, device="cuda")
        want = flat(items)
        kernel_registry.reset_launch_counts()
        got = GpuVerifier(max_bucket=64, msm_min_bucket=16, mode=mode, mesh=mesh)(items)
        counts = kernel_registry.launch_counts()
        assert got == want == [bool(i % 7) for i in range(60)]
        assert counts["verify_batch"] == counts["msm_accumulate"] == 0
        assert counts["verify_verdict"] > 0


@pytest.mark.parametrize("shift", [0, 1, 63, 64])
def test_roll_window_kernel_matches_plain(shift):
    _need_card("roll_window", "csrc/dag_window.cu")
    _rng, p, q = _window(3, 64, 50)
    a, b = td.roll_window(p, q, shift), td.roll_window_plain(p, q, shift)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_place_batch_kernel_matches_plain():
    _need_card("place_batch", "csrc/dag_window.cu")
    rng, p, q = _window(4, 64, 50)
    cells = rng.choice(64 * 50, 16, replace=False)
    offs = torch.from_numpy((cells // 50).astype(np.int32)).cuda()
    idxs = torch.from_numpy((cells % 50).astype(np.int32)).cuda()
    rows = torch.from_numpy((rng.random((16, 50)) < 0.5).astype(np.uint8)).cuda()
    offs[9], idxs[9], rows[9] = offs[2], idxs[2], rows[2]  # duplicate slot
    valid = torch.ones(16, dtype=torch.uint8).cuda()
    valid[12:] = 0  # padding
    a = td.place_batch(p.clone(), q.clone(), offs, idxs, rows, valid)
    b = td.place_batch_plain(p.clone(), q.clone(), offs, idxs, rows, valid)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("K", [1, 2, 4])
def test_chain_commit_kernel_matches_plain(K):
    """At the main path's shapes (W = 64, N = 50, gc_depth = 50), on a
    chain after a healed partition where the gc filter drops certificates
    and the newest leader's filter depends on the lcr that its earlier
    leaders advanced (with K = 4 the last slot is padding)."""
    _need_card("chain_commit", "csrc/dag_window.cu")
    live = 3 if K == 4 else K
    host = chip_smoke.healed_partition_chain(np.random.default_rng(5 + K), 64, 50, 50, K, live)
    parent, present, lc, lcr, offs, onehots = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in host)
    counts, want = chip_smoke.gc_filter_effects(parent, present, 50, lc, lcr, offs, onehots)
    assert counts["dropped"] > 0 and counts["by_own_round"] > 0
    assert live == 1 or counts["by_advanced_lcr"] > 0
    t = [x.cuda() for x in (parent, present, lc, offs, onehots)]
    a = td.chain_commit(t[0], t[1], 50, t[2], lcr, t[3], t[4])
    b = td.chain_commit_plain(t[0], t[1], 50, t[2], lcr, t[3], t[4])
    assert torch.equal(a, b) and torch.equal(a.cpu(), want) and bool(a.any())


@pytest.mark.parametrize("w,K,live", [(64, 1, 1), (64, 64, 56), (128, 1, 1), (128, 64, 61)])
def test_reach_many_kernel_matches_plain(w, K, live):
    """B6 at the Dag service's shapes (N = 50, the default W = 64 and the
    grown W = 128): K distinct starts, the rest padding slots, bit-equal
    to the plain version, padding rows empty."""
    _need_card("reach_many", "csrc/dag_window.cu")
    host = chip_smoke.reach_many_inputs(np.random.default_rng(w + K), w, 50, K, live)
    t = [torch.from_numpy(a).cuda() for a in host]
    kernel_registry.reset_launch_counts()
    a = td.reach_many(*t)
    assert kernel_registry.launch_counts()["reach_many"] == 1
    b = td.reach_many_plain(*t)
    assert torch.equal(a, b) and bool(a[:live].any()) and not bool(a[live:].any())


def test_dag_service_on_card_matches_host():
    """Dag(backend="cuda") on the card answers coalesced reads as the host
    Dag does, through one reach_many launch per burst."""
    _need_card("reach_many", "csrc/dag_window.cu")
    from narwhal_tpu_torch.consensus import Dag
    from narwhal_tpu_torch.fixtures import CommitteeFixture

    f = CommitteeFixture(size=7)
    certs = chip_smoke.service_stream(f.committee, 30, 5)

    async def scenario():
        dev = Dag(f.committee, backend="cuda", window=16, policy="device")
        host = Dag(f.committee)
        for c in certs:
            await dev.insert(c)
            await host.insert(c)
        starts = certs[-40::3]
        kernel_registry.reset_launch_counts()
        got = await asyncio.gather(*(dev.read_causal(c.digest) for c in starts))
        assert kernel_registry.launch_counts()["reach_many"] == 1
        for c, answer in zip(starts, got):
            assert answer == await host.read_causal(c.digest) and answer[0] == c.digest
        assert dev._win.W > 16  # no removals: the window grew

    asyncio.run(asyncio.wait_for(scenario(), 120.0))


def test_engine_on_card_matches_cpu():
    _need_card("place_batch/roll_window/chain_commit", "csrc/dag_window.cu")
    from narwhal_tpu_torch.consensus import ConsensusState
    from narwhal_tpu_torch.fixtures import CommitteeFixture, make_certificates
    from narwhal_tpu_torch.types import Certificate

    f = CommitteeFixture(size=7)
    genesis = {c.digest for c in Certificate.genesis(f.committee)}
    certs, _ = make_certificates(f.committee, 1, 60, genesis, failure_probability=0.3,
                                 rng=random.Random(2))
    outs = {}
    for dev in ("cpu", "cuda"):
        state = ConsensusState(Certificate.genesis(f.committee))
        eng = td.GpuBullshark(f.committee, None, 10, window=16, device=dev)
        seq, i = [], 0
        for lo in range(0, len(certs), 9):
            got = eng.process_batch(state, i, certs[lo:lo + 9])
            i += len(got)
            seq.extend((o.certificate.digest, o.consensus_index) for o in got)
        outs[dev] = seq
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) > 100
