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


VERIFY_SIZES = (1, 7, 1024, 2048, 8192)  # 2048 the main path's bucket, 1024 a shard's


def _torsion_verdicts(strict, cof) -> None:
    """verify_rows' torsion-defect rows pass only the cofactored rule."""
    if strict.numel() < 1024:
        assert not bool(strict[0]) and bool(cof[0])
    else:
        assert 0 < int(strict.sum()) < int(cof.sum()) < strict.numel()


@pytest.mark.parametrize("B", VERIFY_SIZES)
def test_verify_batch_kernel_matches_plain_full_bucket(B):
    """A1 (a quad of threads a signature) on chip_smoke.verify_rows at B
    rows (forged, torsion, zero and random-limb rows; B = 7 leaves quads of
    a warp past the batch), bit-equal to its plain version, one launch a
    call."""
    _need_card("verify_batch", "csrc/ed25519_verify.cu")
    t = [torch.from_numpy(a).cuda() for a in chip_smoke.verify_rows(7, 120, B)]
    kernel_registry.reset_launch_counts()
    got = tk.verify_batch(*t)
    assert kernel_registry.launch_counts()["verify_batch"] == 1
    plain = tk.verify_batch_plain(*t)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    _torsion_verdicts(*got)


MSM_BUCKETS = [16, 64, 512, 1024, 2048, 8192]  # smallest .. largest; 1024 a shard's


@pytest.mark.parametrize("bucket", MSM_BUCKETS)
def test_msm_accumulate_kernel_matches_plain(bucket):
    """A2 in the group-lane shape (compact proofs as doubled rows, zero
    padding, the R slot all zero) and the item shape (real R and z digits, a
    torsion row, an invalid encoding): validity bit-equal, every window lane
    equal as an affine point, the epilogue verdict equal. At 8192 rows the
    kernel takes its rows in two tiles of shared memory."""
    _need_card("msm_accumulate", "csrc/ed25519_msm.cu")
    from narwhal_tpu_torch.fixtures import CommitteeFixture
    from narwhal_tpu_torch.gpu.verifier import msm_epilogue_check

    f = CommitteeFixture(size=4 if bucket <= 64 else 50)
    group = chip_smoke.msm_group_bucket(f, bucket)
    item = chip_smoke.msm_item_bucket(3, 40 if bucket >= 64 else 4, bucket)
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


@pytest.mark.parametrize("B", [0, 1, 7, 1024, 2048, 8192])
def test_verify_decompress_kernel_matches_plain(staged_bucket, B):
    """B = 0: the item bucket's A and R sets (corrupt R encodings among
    them); else chip_smoke.decompress_rows at B rows (the edge encodings,
    y = 0, y = p - 1 and non-canonical y with both signs, points with either
    sign, random y). Coordinates equal mod p, validity bit for bit, one
    launch a call."""
    t, a, r = staged_bucket
    if B == 0:
        cases = ((a, t[0], t[1]), (r, t[2], t[3]))
        assert not bool(r[1].all())  # the corrupt R encodings are flagged
    else:
        rows, signs = chip_smoke.decompress_rows(np.random.default_rng(B), B)
        y, sign = torch.from_numpy(rows).cuda(), torch.from_numpy(signs).cuda()
        kernel_registry.reset_launch_counts()
        cases = ((tk.verify_decompress(y, sign), y, sign),)
        assert kernel_registry.launch_counts()["verify_decompress"] == 1
    for (pts, valid), y, sign in cases:
        p_pts, p_valid = tk.verify_decompress_plain(y, sign)
        assert torch.equal(valid, p_valid)
        assert chip_smoke._mod_p(pts.cpu().numpy()) == chip_smoke._mod_p(p_pts.cpu().numpy())
        assert B in (1, 7) or 0 < int(valid.sum()) < valid.numel()


@pytest.mark.parametrize("B", VERIFY_SIZES)
def test_staged_kernels_match_plain_and_verify_batch(B):
    """A4 equal to its plain version as affine points, A5 bit-equal, and
    A3 -> A4 -> A5 bit-equal to A1 on both lanes, on chip_smoke.verify_rows
    at B rows."""
    _need_card("verify_straus", "csrc/ed25519_staged.cu")
    t = [torch.from_numpy(a).cuda() for a in chip_smoke.verify_rows(7, 120, B)]
    a_pt, a_valid = tk.verify_decompress(t[0], t[1])
    r_pt, r_valid = tk.verify_decompress(t[2], t[3])
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
    _torsion_verdicts(strict, cof)


@pytest.mark.parametrize("B", VERIFY_SIZES)
def test_verify_verdict_kernel_matches_plain(B):
    """A5 alone (ten lanes a row) on chip_smoke.verdict_inputs at B rows:
    R from the plain A3 (loose limbs), rows of random limbs, validity bits
    flipped; strict and cofactored bit-equal to the plain version, one
    launch a call."""
    _need_card("verify_verdict", "csrc/ed25519_staged.cu")
    t = [torch.from_numpy(a).cuda() for a in chip_smoke.verify_rows(7, 120, B)]
    a_pt, a_valid = tk.verify_decompress(t[0], t[1])
    _r_pt, r_valid = tk.verify_decompress(t[2], t[3])
    acc = tk.verify_straus(a_pt, t[4], t[5])
    v = chip_smoke.verdict_inputs(np.random.default_rng(B), acc, t[2], t[3], a_valid, r_valid)
    kernel_registry.reset_launch_counts()
    strict, cof = tk.verify_verdict(*v)
    assert kernel_registry.launch_counts()["verify_verdict"] == 1
    p_strict, p_cof = tk.verify_verdict_plain(*v)
    assert torch.equal(strict, p_strict) and torch.equal(cof, p_cof)
    assert B < 1024 or (0 < int(strict.sum()) < B and 0 < int(cof.sum()) < B
                        and bool((strict != cof).any()))


@pytest.mark.parametrize("bucket", [16, 512, 1024, 2048, 8192])
@pytest.mark.parametrize("shape", ["item", "group"])
def test_msm_window_kernel_matches_plain_and_msm_accumulate(shape, bucket):
    """A6 over the A (64 lanes) and R (32 lanes) sets of the msm buckets,
    equal to its plain version as affine points; A3 -> A6 equal to A2
    (lanes as points, validity bit for bit)."""
    _need_card("msm_window", "csrc/ed25519_msm.cu")
    from narwhal_tpu_torch.fixtures import CommitteeFixture

    host = (chip_smoke.msm_item_bucket(3, 40 if bucket >= 64 else 4, bucket)[0]
            if shape == "item"
            else chip_smoke.msm_group_bucket(CommitteeFixture(size=50 if bucket > 64 else 4),
                                             bucket)[0])
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
    """The reduce of both lane sets over k shards of the msm item bucket, in
    one launch, equals its plain version on each set (its invalid R row
    included), and the unsharded A2's V_a and V_r (that row's digits
    zeroed: off the curve another grouping gives another point), as affine
    points."""
    _need_card("msm_shard_reduce", "csrc/ed25519_msm.cu")
    t = [torch.from_numpy(a).cuda() for a in chip_smoke.msm_item_bucket(3, 40, 2048)[0]]
    pa, _ = tk.verify_decompress(t[0], t[1])
    pr, r_ok = tk.verify_decompress(t[2], t[3])
    parts_a, parts_r = chip_smoke.shard_lane_sets(pa, pr, t[4], t[5], k)
    kernel_registry.reset_launch_counts()
    got_a, got_r = tk.msm_shard_reduce(parts_a, parts_r)
    assert kernel_registry.launch_counts()["msm_shard_reduce"] == 1
    for got, parts in ((got_a, parts_a), (got_r, parts_r)):
        chip_smoke._same_points("msm_shard_reduce", got,
                                tk.msm_shard_reduce_plain(torch.stack(parts)))
    z = torch.where(r_ok[:, None], t[5], torch.zeros_like(t[5]))
    va, vr, _ = tk.msm_accumulate(*t[:5], z)
    on_curve = tk.msm_shard_reduce(*chip_smoke.shard_lane_sets(pa, pr, t[4], z, k))
    chip_smoke._same_points("shards against msm_accumulate V_a", got_a, va)
    chip_smoke._same_points("shards against msm_accumulate V_r", on_curve[1], vr)


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
    """B4 through window_sync: one launch with no slots, out of place."""
    _need_card("window_sync", "csrc/dag_window.cu")
    _rng, p, q = _window(3, 64, 50)
    kernel_registry.reset_launch_counts()
    a, b = td.roll_window(p, q, shift), td.roll_window_plain(p, q, shift)
    assert kernel_registry.launch_counts()["window_sync"] == 1
    assert a[0].data_ptr() != p.data_ptr()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_place_batch_kernel_matches_plain():
    """B3 through window_sync, in place, the slots as host arrays (padding
    and a duplicate); slot arrays on the card raise."""
    _need_card("window_sync", "csrc/dag_window.cu")
    rng, p, q = _window(4, 64, 50)
    cells = rng.choice(64 * 50, 16, replace=False)
    offs, idxs = (cells // 50).astype(np.int32), (cells % 50).astype(np.int32)
    rows = (rng.random((16, 50)) < 0.5).astype(np.uint8)
    offs[9], idxs[9], rows[9] = offs[2], idxs[2], rows[2]  # duplicate slot
    valid = np.ones(16, np.uint8)
    valid[12:] = 0  # padding
    kernel_registry.reset_launch_counts()
    a = td.place_batch(p.clone(), q.clone(), offs, idxs, rows, valid)
    assert kernel_registry.launch_counts()["window_sync"] == 1
    b = td.place_batch_plain(p.clone(), q.clone(), *(torch.from_numpy(x).cuda()
                                                     for x in (offs, idxs, rows, valid)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="host data"):
        td.place_batch(p, q, torch.from_numpy(offs).cuda(), idxs, rows, valid)


SYNC_CASES = [(w, n, T) for w in (64, 128) for n in (49, 50, 65) for T in (1, 64, "past")]


@pytest.mark.parametrize("w,n,T", SYNC_CASES)
def test_sync_window_kernel_matches_plain(w, n, T):
    """One view's roll and placements at W 64 and 128, N 49, 50 and 65:
    T = 1, 64 (four duplicates, two below the window) and a batch past a
    parameter block's capacity (one launch a block, the first rolling), at
    shifts 0, 1, W - 1 and W, with the default grid and with rows split
    into 48-byte chunks; bit-equal to the plain roll then place."""
    _need_card("window_sync", "csrc/dag_window.cu")
    rng, p, q = _window(w + n, w, n)
    cap, _bits = td.sync_layout(w, n)
    size = cap * 2 + 7 if T == "past" else T
    offs, idxs, rows = chip_smoke.sync_slots(rng, w, n, size, n_below=2 if size >= 8 else 0)
    live = int((offs >= 0).sum())
    for shift in (0, 1, w - 1, w):
        kernel_registry.reset_launch_counts()
        got = td.sync_window(p.clone(), q.clone(), shift, offs, idxs, rows)
        launches = kernel_registry.launch_counts()["window_sync"]
        assert launches == -(-live // cap)
        assert kernel_registry.event_counts().get(td.SYNC_LAUNCHES_PAST_FIRST, 0) == launches - 1
        want = td.sync_window_plain(p.clone(), q.clone(), shift, offs, idxs, rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if shift:
            assert got[0].data_ptr() != p.data_ptr()
        # a row split over CTAs of 48 bytes and 64 threads
        got = td.sync_window(p.clone(), q.clone(), shift, offs, idxs, rows, chunk=48, threads=64)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


CHAIN_CASES = ([("healed", w, K) for w in (64, 128, 512) for K in (1, 2, 4)]
               + [("healed200", 64, K) for K in (1, 2, 4)]
               + [("list", i, 0) for i in range(len(chip_smoke.CHAIN_SHAPES))])


@pytest.mark.parametrize("kind,w,K", CHAIN_CASES)
def test_chain_commit_kernel_matches_plain(kind, w, K):
    """At the main path's shapes (W = 64 and the grown 128, N = 50,
    gc_depth = 50), on a chain after a healed partition where the gc filter
    drops certificates and the newest leader's filter depends on the lcr
    that its earlier leaders advanced (with K = 4 the last slot is padding),
    the same chains at two shapes of the wide walk (W = 512, N = 50 and
    W = 64, N = 200, where the partition leaves columns unreached); and at
    every shape of chip_smoke.CHAIN_SHAPES (`w` its index there): N at a
    word edge (64, 65), 200 and 1024 (W = 8), leaders on the top row and on
    row 1, a 512-row window. One launch a call."""
    _need_card("chain_commit", "csrc/dag_window.cu")
    if kind.startswith("healed"):
        live = 3 if K == 4 else K
        seed = 5 + K + (0 if w == 64 else 100) + (1000 if kind == "healed200" else 0)
        n = 200 if kind == "healed200" else 50
        host = chip_smoke.healed_partition_chain(np.random.default_rng(seed), w, n, 50, K, live)
        gc = 50
    else:
        w_, n, gc, rows = chip_smoke.CHAIN_SHAPES[w]
        host = chip_smoke.chain_inputs(np.random.default_rng(w), w_, n, rows)
    parent, present, lc, lcr, offs, onehots = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in host)
    if kind.startswith("healed"):
        counts, want = chip_smoke.gc_filter_effects(parent, present, gc, lc, lcr, offs, onehots)
        assert counts["dropped"] > 0 and counts["by_own_round"] > 0
        assert live == 1 or counts["by_advanced_lcr"] > 0
    else:
        want = td.chain_commit_plain(parent, present, gc, lc, lcr, offs, onehots)
    t = [x.cuda() for x in (parent, present, lc, offs, onehots)]
    kernel_registry.reset_launch_counts()
    a = td.chain_commit(t[0], t[1], gc, t[2], lcr, t[3], t[4])
    assert kernel_registry.launch_counts()["chain_commit"] == 1
    b = td.chain_commit_plain(t[0], t[1], gc, t[2], lcr, t[3], t[4])
    assert torch.equal(a, b) and torch.equal(a.cpu(), want) and bool(a.any())


REACH_CASES = ([("sparse", 64, 50, K, live, None) for K, live in ((1, 1), (64, 56))]
               + [("sparse", 128, 50, K, live, None) for K, live in ((1, 1), (64, 61))]
               + [c for c in chip_smoke.REACH_SHAPES if c[0] != "sparse"]
               + [("consensus", 64, 50, 64, 64, 0.3)])


@pytest.mark.parametrize("label,w,n,K,live,density", REACH_CASES)
def test_reach_many_kernel_matches_plain(label, w, n, K, live, density):
    """B6 at the Dag service's shapes (N = 50, the default W = 64 and the
    grown W = 128; the kernels phase's sparse window and the service's
    dense one in bursts of K = 1, 8 and 64), the consensus step's window
    with its uncommitted mask, and the wide route (N = 65, 200; W = 512):
    K starts, the rest padding slots, bit-equal to the plain version,
    padding rows empty, one launch, on the route the shape calls for."""
    _need_card("reach_many", "csrc/dag_window.cu")
    rng = np.random.default_rng(w + K + n)
    if label == "consensus":
        host = chip_smoke.consensus_reach_inputs(rng, w, n, K)
    else:
        host = chip_smoke.reach_many_inputs(rng, w, n, K, live, density)
    t = [torch.from_numpy(a).cuda() for a in host]
    kernel_registry.reset_launch_counts()
    a = td.reach_many(*t)
    assert kernel_registry.launch_counts()["reach_many"] == 1
    b = td.reach_many_plain(*t)
    assert torch.equal(a, b) and bool(a[:live].any()) and not bool(a[live:].any())
    wide = n > 64 or w > 256
    assert td.reach_route(w, n, t[0].device) == ("wide" if wide else "packed")


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
    _need_card("window_sync/chain_commit", "csrc/dag_window.cu")
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


@pytest.mark.parametrize("engine", ["GpuBullshark", "GpuTusk"])
def test_runner_restart_on_card_matches_host(engine):
    """The consensus runner over the card engine and a native-engine
    NodeStorage at N = 50, stopped inside a stretch without commits (the
    window grew) and restarted from the same directory: its outputs,
    tx_primary stream and ConsensusStore record equal the host engine's
    over the stream without a stop."""
    _need_card("window_sync/chain_commit", "csrc/dag_window.cu")
    from narwhal_tpu_torch.consensus import Bullshark, Tusk
    from narwhal_tpu_torch.fixtures import CommitteeFixture

    f = CommitteeFixture(size=50)
    certs = chip_smoke.engine_stream(f, 120, 3)
    kernel_registry.reset_launch_counts()
    outs, prim, record, runner, _walls = chip_smoke.runner_restart(
        torch.device("cuda:0"), f, getattr(td, engine), certs, 60)
    launches = kernel_registry.launch_counts()
    host = chip_smoke.host_run(Tusk if engine == "GpuTusk" else Bullshark, f, certs)
    chip_smoke.check_runner(engine, outs, prim, record, runner, host, 60)
    assert launches["window_sync"] > 0 and launches["chain_commit"] > 0


@pytest.mark.parametrize("b", [1, 64, 200])
def test_leader_support_kernel_matches_plain(b):
    _need_card("leader_support", "csrc/dag_window.cu")
    host = chip_smoke.support_inputs(np.random.default_rng(b), 64, 50, b, 0.3)
    parent, present, stakes, offs, _oh, leaders, _last = host
    t = [torch.from_numpy(a).cuda() for a in (parent, present, stakes, offs, leaders)]
    kernel_registry.reset_launch_counts()
    a = td.leader_support(*t)
    assert kernel_registry.launch_counts()["leader_support"] == 1
    assert torch.equal(a, td.leader_support_plain(*t)) and bool((a > 0).any())


@pytest.mark.parametrize("what", ["offset", "leader"])
def test_leader_support_error_word_raises(what):
    """An out-of-range walk among 64 (walk 40: an offset of W, or a leader
    of M) raises the CPU's ValueError from the kernel's error words, after
    one launch; the same call with the walk removed is bit-equal to the
    plain version, and the kernel wrote 0 for the bad walk and the plain
    support for the others."""
    _need_card("leader_support", "csrc/dag_window.cu")
    parent, present, stakes, offs, _oh, leaders, _last = chip_smoke.support_inputs(
        np.random.default_rng(40), 64, 50, 64, 0.3)
    o, l = offs.copy(), leaders.copy()
    (o if what == "offset" else l)[40] = 64 if what == "offset" else 50
    host = (parent, present, stakes, o, l)
    with pytest.raises(ValueError) as cpu_err:
        td.leader_support(*(torch.from_numpy(a) for a in host))
    kernel_registry.reset_launch_counts()
    with pytest.raises(ValueError) as card_err:
        td.leader_support(*(torch.from_numpy(a).cuda() for a in host))
    assert kernel_registry.launch_counts()["leader_support"] == 1
    assert str(card_err.value) == str(cpu_err.value) and "walk 40 " in str(card_err.value)
    keep = np.arange(64) != 40
    t = [torch.from_numpy(a).cuda() for a in (parent, present, stakes, o[keep], l[keep])]
    got = td.leader_support(*t)
    assert torch.equal(got, td.leader_support_plain(*t))
    part, _check = td._leader_support(*(torch.from_numpy(a).cuda() for a in host))
    assert int(part[40]) == 0 and torch.equal(part[torch.from_numpy(keep).cuda()], got)


def test_consensus_step_raises_on_an_out_of_range_leader():
    """consensus_step on the card: its three launches go out, then an
    out-of-range leader raises the CPU's ValueError; in range it equals
    the plain composition."""
    _need_card("leader_support", "csrc/dag_window.cu")
    host = list(chip_smoke.support_inputs(np.random.default_rng(41), 64, 50, 64, 0.3))
    flat = td.consensus_step(*(torch.from_numpy(a).cuda() for a in host))
    for a, b in zip(flat, td.consensus_step(*(torch.from_numpy(a) for a in host))):
        assert torch.equal(a.cpu(), b)
    host[5] = host[5].copy()
    host[5][7] = 50
    with pytest.raises(ValueError) as cpu_err:
        td.consensus_step(*(torch.from_numpy(a) for a in host))
    kernel_registry.reset_launch_counts()
    with pytest.raises(ValueError) as card_err:
        td.consensus_step(*(torch.from_numpy(a).cuda() for a in host))
    counts = kernel_registry.launch_counts()
    assert counts["reach_many"] == counts["leader_support"] == counts["consensus_commit"] == 1
    assert str(card_err.value) == str(cpu_err.value)


@pytest.mark.parametrize("shape", [c[0] for c in chip_smoke.COMMIT_SHAPES])
def test_consensus_commit_kernel_matches_plain(shape):
    """B7 at chip_smoke.COMMIT_SHAPES (the consensus step's on B6's masks,
    shard blocks, N 200 and 1024, one walk, an unaligned slab, a misaligned
    view, a wrapping stake sum): committed and new_last bit-equal to the
    plain version, one launch; walk 0 (at quorum) commits, walk 1 (one
    below) does not."""
    _need_card("consensus_commit", "csrc/dag_window.cu")
    label, b, w, m, s, offset, stakes = next(c for c in chip_smoke.COMMIT_SHAPES
                                             if c[0] == shape)
    rng = np.random.default_rng(6)
    masks = None
    if label == "consensus step":
        host = chip_smoke.reach_many_inputs(rng, w, m, 64, 56)
        masks = td.reach_many(*(torch.from_numpy(a).cuda() for a in host))
    t = chip_smoke.commit_inputs(rng, torch.device("cuda"), b, w, m, s, offset, stakes, masks)
    kernel_registry.reset_launch_counts()
    kc, kl = td.consensus_commit(*t)
    assert kernel_registry.launch_counts()["consensus_commit"] == 1
    pc, pl = td.consensus_commit_plain(*t)
    assert torch.equal(kc, pc) and torch.equal(kl, pl)
    if b > 1:
        assert bool(kc[0].any()) and not bool(kc[1].any()) and not torch.equal(kl, t[3])


def test_sharded_compositions_match_unsharded_kernels():
    """Over [cuda:0, cuda:0], on each route: chain_commit_sharded equals
    chain_commit on a healed-partition chain, reach_many_sharded equals
    reach_many, and consensus_step_sharded (2 x 2) equals consensus_step,
    launching neither unsharded walk, through sharded_walk, on "cluster"
    (the mesh's own route) and on "peer" and "host" (forced)."""
    _need_card("sharded_walk", "csrc/dag_window.cu")
    from narwhal_tpu_torch.gpu.mesh import auth_mesh

    mesh = auth_mesh(2, devices=["cuda:0", "cuda:0"])
    assert mesh.routes == ["cluster"]
    rng = np.random.default_rng(7)
    parent, present, lc, lcr, offs, onehots = chip_smoke.healed_partition_chain(
        rng, 64, 50, 50, 4, 3)
    t = [torch.from_numpy(a).cuda() for a in (parent, present, lc, offs, onehots)]
    want = td.chain_commit(t[0], t[1], 50, t[2], lcr, t[3], t[4])
    rin = chip_smoke.reach_many_inputs(rng, 64, 50, 64, 56)
    want_r = td.reach_many(*(torch.from_numpy(a).cuda() for a in rin))
    host = chip_smoke.support_inputs(rng, 64, 50, 64, 0.3)
    flat = td.consensus_step(*(torch.from_numpy(a).cuda() for a in host))
    grid = auth_mesh(2, devices=["cuda:0"] * 4, data=2)
    for route in ("cluster", "peer", "host"):
        kernel_registry.reset_launch_counts()
        got = td.chain_commit_sharded(mesh, parent, present, 50, lc, lcr, offs, onehots,
                                      route=route)
        got_r = td.reach_many_sharded(mesh, *rin, route=route)
        meshed = td.consensus_step_sharded(grid, *host, route=route)
        counts = kernel_registry.launch_counts()
        assert torch.equal(got, want) and torch.equal(got_r, want_r)
        for a, b in zip(flat, meshed):
            assert torch.equal(a, b)
        assert counts["sharded_walk"] > 0
        assert counts["chain_commit"] == counts["reach_many"] == 0
    assert got.device == torch.device("cuda", 0)


@pytest.mark.parametrize("route", ["cluster", "peer", "host"])
@pytest.mark.parametrize("auth", [2, 4])
def test_sharded_walk_kernel_matches_plain(route, auth):
    """sharded_walk over `auth` shards of the card (N = 50 padded to 52
    over 4) on `route` ("peer" and "host" forced: a launch, a stream and an
    exchange buffer per shard, card memory or pinned host memory),
    bit-equal to its plain version and to B2 / B6: chain mode at K = 1, 2,
    4 on healed-partition chains (a padding slot at K = 4), many mode at
    K = 64 on the sparse read window."""
    _need_card("sharded_walk", "csrc/dag_window.cu")
    from narwhal_tpu_torch.gpu.mesh import auth_mesh

    mesh = auth_mesh(auth, devices=["cuda:0"] * auth)

    def walk(ops, gc_depth, lcr, chain):
        if route == "cluster":
            return td.sharded_walk(*ops, gc_depth, lcr, chain)
        return chip_smoke.walk_exchange(mesh, ops, gc_depth, lcr, chain, route)

    rng = np.random.default_rng(auth)
    for K, live in ((1, 1), (2, 2), (4, 3)):
        parent, present, lc, lcr, offs, onehots = chip_smoke.healed_partition_chain(
            rng, 64, 50, 50, K, live)
        blocks = chip_smoke.walk_blocks(auth, parent, present, lc, onehots)
        ops = [torch.from_numpy(a).cuda() for a in (*blocks[:3], offs, blocks[3])]
        kernel_registry.reset_launch_counts()
        got = walk(ops, 50, lcr, True)
        assert kernel_registry.launch_counts()["sharded_walk"] == (
            1 if route == "cluster" else auth)
        assert torch.equal(got, td.sharded_walk_plain(*ops, 50, lcr, True))
        t = [torch.from_numpy(a).cuda() for a in (parent, present, lc, offs, onehots)]
        want = td.chain_commit(t[0], t[1], 50, t[2], lcr, t[3], t[4])
        assert torch.equal(chip_smoke.unblock(got, 50), want) and bool(want.any())
    rin = chip_smoke.reach_many_inputs(rng, 64, 50, 64, 56)
    pb, qb, _lb, oh = chip_smoke.walk_blocks(auth, rin[0], rin[1], None, rin[3])
    ops = [torch.from_numpy(pb).cuda(), torch.from_numpy(qb).cuda(), None,
           torch.from_numpy(rin[2]).cuda(), torch.from_numpy(oh).cuda()]
    got = walk(ops, 0, -(2**30), False)
    assert torch.equal(got, td.sharded_walk_plain(*ops, 0, -(2**30), False))
    want = td.reach_many(*(torch.from_numpy(a).cuda() for a in rin))
    assert torch.equal(chip_smoke.unblock(got, 50), want)


@pytest.mark.parametrize("route", ["peer", "host"])
def test_sharded_walk_missing_peer_raises_within_deadline(route):
    """Only one of the two launches of a forced exchange route is issued,
    with a 100 ms deadline: the launched one gives up at its deadline and
    the call raises RuntimeError (no hang); the exchange then works again."""
    _need_card("sharded_walk", "csrc/dag_window.cu")
    import time

    from narwhal_tpu_torch.gpu.mesh import auth_mesh

    mesh = auth_mesh(2, devices=["cuda:0", "cuda:0"])
    parent, present, lc, lcr, offs, onehots = chip_smoke.healed_partition_chain(
        np.random.default_rng(3), 64, 50, 50, 1, 1)
    blocks = chip_smoke.walk_blocks(2, parent, present, lc, onehots)
    ops = [torch.from_numpy(a).cuda() for a in (*blocks[:3], offs, blocks[3])]
    want = chip_smoke.walk_exchange(mesh, ops, 50, lcr, True, route)
    assert torch.equal(want, td.sharded_walk(*ops, 50, lcr, True))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="waited more than 100 ms"):
        chip_smoke.walk_exchange(mesh, ops, 50, lcr, True, route, launch=[0], timeout_ms=100)
    assert time.perf_counter() - t0 < 1.1
    assert torch.equal(chip_smoke.walk_exchange(mesh, ops, 50, lcr, True, route), want)


@pytest.mark.parametrize("route", ["peer", "host"])
def test_peer_exchange_reused_across_modes_and_walk_counts(route):
    """One forced exchange of `route` on the card reused by calls that
    change mode and walk count, each on fresh inputs
    (chip_smoke.check_peer_reuse): every result equals B6 / B2, the "host"
    route's host-memory slots reused every second event included."""
    _need_card("sharded_walk", "csrc/dag_window.cu")
    seq = chip_smoke.check_peer_reuse(torch.device("cuda", 0), route=route)
    assert seq[0] == ("many", 64) and ("chain", 2) in seq  # a large layout, then fewer walks


def _cards(k: int) -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < k:
        pytest.skip(f"the sharded walk across cards needs {k} or more cards, found {n}")
    return n


@pytest.mark.parametrize("layout", ["two cards", "every card", "two cards twice"])
def test_sharded_walk_across_cards(layout, capsys):
    """An auth row over distinct cards: its route from the topology ("peer"
    where every pair has peer access, else "host"), the compositions
    equal to chain_commit / reach_many / consensus_step on cuda:0 on that
    route and on "host" forced (a real exchange through host memory over
    PCIe), one sharded_walk launch per card per chain; on each exchange
    route one exchange reused across modes and walk counts stays exact,
    and a missing peer raises within its deadline. Prints the cards, their
    peer access, the route and the host wall of each composition."""
    _need_card("sharded_walk", "csrc/dag_window.cu")
    import time

    from narwhal_tpu_torch.gpu.mesh import auth_mesh

    n = _cards(2)
    devs = {"two cards": ["cuda:0", "cuda:1"],
            "every card": [f"cuda:{i}" for i in range(n)],
            "two cards twice": ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]}[layout]
    mesh = auth_mesh(len(devs), devices=devs)
    route = mesh.routes[0]
    access = all(torch.cuda.can_device_access_peer(a, b)
                 for a in range(n) for b in range(n) if a != b)
    assert route == ("peer" if access else "host")
    rng = np.random.default_rng(11)
    parent, present, lc, lcr, offs, onehots = chip_smoke.healed_partition_chain(
        rng, 64, 50, 50, 4, 3)
    t = [torch.from_numpy(a).cuda() for a in (parent, present, lc, offs, onehots)]
    want = td.chain_commit(t[0], t[1], 50, t[2], lcr, t[3], t[4])
    rin = chip_smoke.reach_many_inputs(rng, 64, 50, 64, 56)
    want_r = td.reach_many(*(torch.from_numpy(a).cuda() for a in rin))
    walls = {}
    for r in dict.fromkeys((route, "host")):
        kernel_registry.reset_launch_counts()
        got = td.chain_commit_sharded(mesh, parent, present, 50, lc, lcr, offs, onehots, route=r)
        counts = kernel_registry.launch_counts()
        assert torch.equal(got.to("cuda:0"), want)
        assert counts["sharded_walk"] == len(mesh.walk(0, r).groups)
        assert torch.equal(td.reach_many_sharded(mesh, *rin, route=r).to("cuda:0"), want_r)
        for name, fn in (("chain_commit_sharded K=4", lambda: td.chain_commit_sharded(
                mesh, parent, present, 50, lc, lcr, offs, onehots, route=r)),
                         ("reach_many_sharded K=64", lambda: td.reach_many_sharded(
                             mesh, *rin, route=r))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            walls[f"{name} {r}"] = (time.perf_counter() - t0) / 10 * 1e3
    host = chip_smoke.support_inputs(rng, 64, 50, 8, 0.3)
    flat = td.consensus_step(*(torch.from_numpy(a).cuda() for a in host))
    grid = (auth_mesh(2, devices=devs, data=len(devs) // 2) if len(devs) % 2 == 0
            else auth_mesh(len(devs), devices=devs))
    for a, b in zip(flat, td.consensus_step_sharded(grid, *host)):
        assert torch.equal(a, b.to("cuda:0"))
    blocks = chip_smoke.walk_blocks(len(devs), parent, present, lc, onehots)
    ops = [torch.from_numpy(a).cuda() for a in (*blocks[:3], offs, blocks[3])]
    for r in dict.fromkeys((route, "host")):
        chip_smoke.check_peer_reuse(torch.device("cuda", 0), devices=devs, route=r)
        got = chip_smoke.walk_exchange(mesh, ops, 50, lcr, True, r)
        assert torch.equal(chip_smoke.unblock(got, 50), want)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="waited more than 100 ms"):
            chip_smoke.walk_exchange(mesh, ops, 50, lcr, True, r, launch=[0], timeout_ms=100)
        walls[f"missing peer raised after ({r})"] = (time.perf_counter() - t0) * 1e3
        assert walls[f"missing peer raised after ({r})"] < 1100
    with capsys.disabled():
        print(f"\n[{layout}] {devs} (peer access between every pair: {access}): route "
              f"{route}; ms a call: " + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()))


def test_meshed_engine_across_cards(capsys):
    """The dag_shards path (GpuBullshark(mesh=auth_mesh(2)) over cuda:0 and
    cuda:1) and the consensus step over a 2 x 2 mesh of four cards, as
    chip_smoke.py's phases run them: the meshed engine's commits equal the
    host Bullshark's and the unmeshed card engine's, one sharded_walk launch
    per card per commit event on the "peer" route; its certificates/s and
    the unmeshed engine's from the same run are printed."""
    _need_card("sharded_walk", "csrc/dag_window.cu")
    from narwhal_tpu_torch.fixtures import CommitteeFixture

    n = _cards(2)
    dev = torch.device("cuda", 0)
    f = CommitteeFixture(size=50)
    with capsys.disabled():
        ctx = chip_smoke.phase_engine(dev, f)
        shards = chip_smoke.phase_dag_shards(dev, f, ctx)
        assert shards["devices"] == ["cuda:0", "cuda:1"]
        if n >= 4:
            step = chip_smoke.phase_consensus_step(dev, f)
            print(f"consensus step over 4 cards: {step['meshed_s_by_route']}")
