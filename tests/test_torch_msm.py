"""Parity of the port's msm lane, group lane and VerifyService with the JAX
package, on the CPU.

- `msm_accumulate_plain` against a Python-bigint sum of digit * (-P) per
  window lane (affine points); its steps after the decompress (the cached
  table, `_select_lanes`, `_accumulate_windows`) raw-limb equal to the JAX
  ones run op by op under `jax.disable_jit()`; and, under `-m slow`, the
  whole of it raw-limb equal to the jitted JAX `msm_accumulate_kernel`
  (minutes of XLA compile);
- the port's `msm_epilogue_check` against the JAX one (pure Python) on the
  same V;
- packing parity: the port's `GpuVerifier` and the JAX `TpuVerifier` hand
  their msm kernel identical host arrays and sum_s for the same items and
  groups, with the same `os.urandom` bytes injected on both sides (no XLA
  compile: the JAX kernel is replaced by a recorder);
- the verdict cases of the JAX msm tests (tests/test_tpu_ed25519.py) through
  the port: valid, corrupted, wrong-message, malformed, padding, small
  buckets, torsion, the group lane through `collect_groups` and through
  `VerifyService`, and the bisect's single host walk.

Exact everywhere. The CUDA kernel is held against the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import asyncio
import os
import random

import numpy as np
import pytest
import torch

from narwhal_tpu.tpu import ed25519 as jk
from narwhal_tpu.tpu import verifier as jverifier
from narwhal_tpu_torch import types as types_mod
from narwhal_tpu_torch.crypto import KeyPair
from narwhal_tpu_torch.fixtures import CommitteeFixture
from narwhal_tpu_torch.gpu import ed25519 as tk
from narwhal_tpu_torch.gpu import ed25519_ref as ref
from narwhal_tpu_torch.gpu import verifier as tverifier
from narwhal_tpu_torch.gpu.verifier import GpuVerifier, VerifyService, msm_epilogue_check
from narwhal_tpu_torch.types import Certificate, Vote

B = 16
CHUNK = 8


def _items(n, tag=0):
    kps = [KeyPair.from_seed(bytes([tag, i]) * 16) for i in range(min(n, 5))]
    out = []
    for i in range(n):
        kp = kps[i % len(kps)]
        msg = bytes([tag, i]) * 10
        out.append((kp.public, msg, kp.sign(msg)))
    return out


def _torsion_item(seed: int):
    """A signature under a torsion-shifted key A' = A + T: strict verification
    rejects it, cofactored accepts it."""
    rng = random.Random(seed)
    while True:
        y = rng.randrange(ref.P)
        x = ref.recover_x(y, 0)
        if x is None:
            continue
        t = ref.point_mul(ref.L, (x, y, 1, x * y % ref.P))
        if t[0] % ref.P != 0 or (t[1] - t[2]) % ref.P != 0:
            break
    while True:
        a = rng.randrange(ref.L)
        pk = ref.compress(ref.point_add(ref.point_mul(a, ref.G), t))
        msg = b"torsion probe"
        r = rng.randrange(ref.L)
        r_bytes = ref.compress(ref.point_mul(r, ref.G))
        k = ref.sha512_mod_l(r_bytes, pk, msg)
        if k % 2 == 1:  # [k]T is not the identity for any 8-torsion T
            break
    sig = r_bytes + ((r + k * a) % ref.L).to_bytes(32, "little")
    assert not ref.verify(pk, msg, sig)
    return pk, msg, sig


def _msm_rows(seed, n_zero=3):
    """B rows of random valid A and R points with random digits, the last
    `n_zero` rows zero (padding). Returns (host arrays, A points, R points)."""
    rng = random.Random(seed)
    ay = np.zeros((B, 32), np.uint8)
    ry = np.zeros((B, 32), np.uint8)
    pts_a, pts_r = [], []
    for i in range(B - n_zero):
        pa = ref.point_mul(rng.randrange(1, ref.L), ref.G)
        pr = ref.point_mul(rng.randrange(1, ref.L), ref.G)
        ay[i] = np.frombuffer(ref.compress(pa), np.uint8)
        ry[i] = np.frombuffer(ref.compress(pr), np.uint8)
        pts_a.append(pa)
        pts_r.append(pr)
    nprng = np.random.default_rng(seed)
    ak = nprng.integers(0, 16, (B, 64)).astype(np.int8)
    z = nprng.integers(0, 16, (B, 32)).astype(np.int8)
    ak[B - n_zero:] = 0
    z[B - n_zero:] = 0
    arrays = [
        tk.bytes_to_limbs(ay).astype(np.int16), (ay[:, 31] >> 7).astype(np.int8),
        tk.bytes_to_limbs(ry).astype(np.int16), (ry[:, 31] >> 7).astype(np.int8), ak, z,
    ]
    return arrays, pts_a, pts_r


def _affine(v, w):
    X, Y, Z, _T = (tk.limbs_to_int(np.asarray(v[c, :, w])) % ref.P for c in range(4))
    zi = pow(Z, ref.P - 2, ref.P)
    return X * zi % ref.P, Y * zi % ref.P


def test_msm_accumulate_plain_matches_bigint_lanes():
    arrays, pts_a, pts_r = _msm_rows(1)
    va, vr, valid = tk.msm_accumulate_plain(*[torch.from_numpy(a) for a in arrays], chunk=CHUNK)
    assert valid.tolist() == [True] * B  # zero rows decompress (x^2 = -1)
    assert tuple(va.shape) == (4, tk.NLIMB, 64) and tuple(vr.shape) == (4, tk.NLIMB, 32)
    for v, pts, digits in ((va, pts_a, arrays[4]), (vr, pts_r, arrays[5])):
        for w in range(v.shape[2]):
            acc = ref.IDENTITY
            for j, p in enumerate(pts):
                acc = ref.point_add(acc, ref.point_mul(int(digits[j, w]), ref.point_neg(p)))
            assert _affine(v.numpy(), w) == ref.affine(acc), w
    # The wrapper on CPU tensors is the plain version (chunk 128 -> one
    # chain per row here: the same sums, another tree).
    wa, wr, wvalid = tk.msm_accumulate(*[torch.from_numpy(a) for a in arrays])
    assert wvalid.tolist() == valid.tolist()
    assert all(_affine(wa.numpy(), w) == _affine(va.numpy(), w) for w in range(64))


@pytest.fixture(scope="module")
def msm_tables():
    """The cached tables of _msm_rows(7)'s 2B points (A then R; the zero
    rows included) from the port's plain decompress, and the int32 digits."""
    arrays, _, _ = _msm_rows(7)
    t = [torch.from_numpy(a) for a in arrays]
    ys = torch.cat([t[0].T, t[2].T], dim=1).to(torch.int32).contiguous()
    signs = torch.cat([t[1], t[3]]).to(torch.int32)
    points, valid = tk.decompress(ys, signs)
    assert bool(valid.all())
    neg = tk.pt_neg(points)
    return neg, tk._pt_cached_table(neg, 2 * B), t[4].to(torch.int32), t[5].to(torch.int32)


def test_cached_table_matches_jax_eager(msm_tables):
    """The 16-entry cached table of every point, raw limbs equal to the JAX
    `_pt_cached_table` run op by op (no XLA compile of the whole kernel)."""
    import jax
    import jax.numpy as jnp

    neg, table, _, _ = msm_tables
    with jax.disable_jit():
        jtable = jk._pt_cached_table(tuple(jnp.asarray(x.numpy()) for x in neg), 2 * B)
    for j, p in zip(jtable, table):
        assert np.array_equal(np.asarray(j), p.numpy())


@pytest.mark.parametrize("slot", ["a", "r"])
def test_window_accumulate_matches_jax_eager(msm_tables, slot):
    """`_select_lanes` and `_accumulate_windows`, the steps of the plain A2
    after the table, raw limbs equal to the JAX ones run op by op on the
    same table and digits (B = 16, chunk 8: two chunks, three tree rounds);
    the A slot has 64 window lanes, the R slot 32."""
    import jax
    import jax.numpy as jnp

    _, table, ak, z = msm_tables
    table_slot = tuple(x[..., :B] if slot == "a" else x[..., B:] for x in table)
    digits = ak if slot == "a" else z
    jtable = tuple(jnp.asarray(x.numpy()) for x in table_slot)
    jdigits = jnp.asarray(digits.numpy())
    with jax.disable_jit():
        jsel = [jk._select_lanes(jt[:, :, :CHUNK], jdigits[:CHUNK]) for jt in jtable]
        jv = jk._accumulate_windows(jtable, jdigits, CHUNK)
    for j, x in zip(jsel, table_slot):
        assert np.array_equal(np.asarray(j), tk._select_lanes(x[:, :, :CHUNK], digits[:CHUNK]).numpy())
    v = tk._accumulate_windows(table_slot, digits, CHUNK)
    assert tuple(v[0].shape) == (tk.NLIMB, digits.shape[1])
    for j, x in zip(jv, v):
        assert np.array_equal(np.asarray(j), x.numpy())


def test_msm_accumulate_flags_invalid_encodings():
    arrays, _, _ = _msm_rows(2)
    rng = random.Random(6)
    while True:  # a y with no x on the curve
        y = rng.randrange(ref.P)
        if ref.recover_x(y, 0) is None:
            break
    arrays[0][2] = tk.int_to_limbs(y).astype(np.int16)
    arrays[2][5] = tk.int_to_limbs(1).astype(np.int16)  # y = 1: x = 0, sign 1 is invalid
    arrays[3][5] = 1
    _, _, valid = tk.msm_accumulate_plain(*[torch.from_numpy(a) for a in arrays], chunk=CHUNK)
    assert [i for i, v in enumerate(valid.tolist()) if not v] == [2, 5]


def test_msm_accumulate_dispatch_rules():
    """CPU tensors run the plain version and launch nothing; other devices
    raise; the kernel's input checks refuse what it does not take."""
    from narwhal_tpu_torch.gpu import kernel_registry

    arrays, _, _ = _msm_rows(5)
    t = [torch.from_numpy(a) for a in arrays]
    kernel_registry.reset_launch_counts()
    tk.msm_accumulate(*t)
    assert kernel_registry.launch_counts()["msm_accumulate"] == 0
    with pytest.raises(ValueError):
        tk.msm_accumulate(*[x.to("meta") for x in t])
    assert tk._check_msm_inputs(*t) == B
    with pytest.raises(ValueError):
        tk._check_msm_inputs(t[0].int(), *t[1:])
    with pytest.raises(ValueError):  # z digits are 32 lanes, not 64
        tk._check_msm_inputs(*t[:5], t[4])
    with pytest.raises(ValueError):  # 24 rows: not a multiple of a power-of-two chain count
        tk._check_msm_inputs(*[torch.cat([x, x[:8]]) for x in t])


def test_msm_field_mul_count():
    per = tk.msm_field_muls_per_signature(2048)
    assert per["sq"] == 510
    assert per["mul"] == 2 * 20 + 2 * 127 + 8 * 96 + 9 * 127 * 96 / 2048
    products = 2048 * (per["mul"] * 100 + per["sq"] * 55)
    assert 1.3e5 * 2048 < products < 1.5e5 * 2048
    full = tk.msm_field_ops(2 * 2048, 2048, 2048, 2048)
    assert full == {"sq": per["sq"] * 2048, "mul": per["mul"] * 2048}
    # The group lane at 2048 rows: 2000 live A points; its zero R slot and
    # 48 zero rows are not counted.
    group = tk.msm_field_ops(2000, 2000, 0, 2048)
    assert group == {"sq": 255 * 2000, "mul": 2000 * (20 + 127 + 8 * 64) + 9 * 127 * 64}


def _urandom_stream(seed):
    rng = random.Random(seed)
    return lambda n: rng.randbytes(n)


def _msm_handle_v(v, items):
    """(V_a, V_r, valid, sum_s) of the one msm bucket of `items`."""
    handle = v.submit(items)
    [(kind, _lo, _hi, _pad, (copy, sum_s))] = handle[2]
    assert kind == "msm"
    va, vr, valid = copy.result()
    return va, vr, valid, sum_s


def test_epilogue_matches_jax_epilogue(monkeypatch):
    monkeypatch.setattr(os, "urandom", _urandom_stream(3))
    v = GpuVerifier(max_bucket=B, msm_min_bucket=B, mode="msm", device="cpu")
    va, vr, valid, sum_s = _msm_handle_v(v, _items(12, tag=1))
    assert valid.all()
    assert msm_epilogue_check(va, vr, sum_s) is True
    assert jverifier.msm_epilogue_check(va, vr, sum_s, jk) is True
    for bad_sum in (sum_s + 1, sum_s + ref.L // 3):
        assert msm_epilogue_check(va, vr, bad_sum) is False
        assert jverifier.msm_epilogue_check(va, vr, bad_sum, jk) is False
    items = _items(12, tag=2)
    items[4] = (items[4][0], b"different", items[4][2])
    va, vr, valid, sum_s = _msm_handle_v(v, items)
    assert msm_epilogue_check(va, vr, sum_s) is False
    assert jverifier.msm_epilogue_check(va, vr, sum_s, jk) is False


# An order-8 point: the cofactored check must not see it.
_TORSION8 = "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a"


def test_epilogue_base_digits_in_the_walk_match_jax_epilogue():
    """The port's epilogue adds [sum_s]B a digit a window inside its Horner
    walk; the JAX one walks [sum_s]B apart. On lanes of random multiples of
    B in unnormalized extended coordinates, both accept where the lanes
    and the base term cancel (an order-8 point in the last lane, which the
    cofactor kills, included) and reject where they are off by B."""
    rng = random.Random(19)
    torsion = ref.decompress(bytes.fromhex(_TORSION8))

    def lanes(ks, extra=None):
        out = np.zeros((4, tk.NLIMB, len(ks)), np.int32)
        for w, k in enumerate(ks):
            pt = ref.point_mul(k, ref.G)
            if extra is not None and w == len(ks) - 1:
                pt = ref.point_add(pt, extra)
            z = rng.randrange(1, ref.P)
            X, Y, Z, T = pt
            for c, val in enumerate((X * z, Y * z, Z * z, T * z)):
                out[c, :, w] = tk.int_to_limbs(val % ref.P)
        return out

    for extra in (None, torsion):
        ka = [rng.randrange(ref.L) for _ in range(64)]
        kr = [rng.randrange(ref.L) for _ in range(32)]
        total = sum(pow(16, 63 - w, ref.L) * (ka[w] + (kr[w - 32] if w >= 32 else 0))
                    for w in range(64))
        va, vr = lanes(ka), lanes(kr, extra)
        sum_s = -total % ref.L
        for s, want in ((sum_s, True), (sum_s + 1, False), (sum_s + ref.L, True)):
            assert msm_epilogue_check(va, vr, s) is want
            assert jverifier.msm_epilogue_check(va, vr, s, jk) is want


def _recorder(calls):
    def record(*arrays):
        calls.append([np.asarray(a).copy() for a in arrays])
        return tuple(np.zeros(1) for _ in range(3))

    return record


def _fixture_groups(fx, rounds, tamper=()):
    groups = []
    for r in rounds:
        h = fx.header(author=r % fx.committee.size(), round=r)
        signers, sigs = [], []
        for a in fx.authorities:
            signers.append(fx.committee.index_of(a.public))
            sigs.append(Vote.for_header(h, a.public, a.keypair).signature)
        cc = Certificate.compact_from_votes(h, tuple(signers), tuple(sigs))
        if r in tamper:
            cc = Certificate(cc.header, cc.signers, cc.signatures,
                             bytes([cc.agg_s[0] ^ 1]) + cc.agg_s[1:])
        groups.append(cc.aggregate_group(fx.committee))
    return groups


@pytest.fixture(scope="module")
def fx():
    return CommitteeFixture(size=4)


def test_packing_matches_jax_verifier(monkeypatch, fx):
    """The same host arrays and sum_s reach the msm kernel on both sides,
    for `submit` (items, zero-row padding) and `submit_groups` (doubled
    rows), with identical os.urandom bytes injected."""
    items = _items(20, tag=3)
    items[6] = (b"\x01" * 31, b"x", b"\x02" * 64)  # malformed: excluded
    groups = _fixture_groups(fx, range(1, 6))

    jv = jverifier.TpuVerifier(max_bucket=64, msm_min_bucket=16, mode="msm")
    tv = GpuVerifier(max_bucket=64, msm_min_bucket=16, mode="msm", device="cpu")
    got = {}
    for name, v, attr in (("jax", jv, "_msm_kernel"), ("port", tv, "_launch_msm")):
        calls = []
        if name == "jax":
            monkeypatch.setattr(v, attr, _recorder(calls))
        else:
            monkeypatch.setattr(v, attr, lambda arrays, calls=calls: _recorder(calls)(*arrays))
        monkeypatch.setattr(os, "urandom", _urandom_stream(11))
        h = v.submit(items)
        hg = v.submit_groups(groups)
        got[name] = (
            calls,
            [entry[4][1] for entry in h[2]],
            [disp[1] for _chunk, disp in hg[2]],
            [entry[4] for entry in hg[1]],
        )
    jcalls, jsums, jgsums, jw = got["jax"]
    tcalls, tsums, tgsums, tw = got["port"]
    assert len(jcalls) == len(tcalls) == 2
    for ja, ta in zip(jcalls, tcalls):
        assert len(ja) == len(ta) == 6
        for x, y in zip(ja, ta):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
    assert tcalls[0][0].shape == (32, tk.NLIMB)  # 19 rows pad to 32 with zero rows
    assert not tcalls[0][4][19:].any() and not tcalls[0][0][19:].any()
    assert tcalls[1][0].shape == (64, tk.NLIMB) and not tcalls[1][2].any()
    assert jsums == tsums and jgsums == tgsums and jw == tw


@pytest.fixture(scope="module")
def msm_verifier():
    # msm_min_bucket lowered so the small batches exercise the msm lane.
    return GpuVerifier(max_bucket=B, msm_min_bucket=B, mode="msm", device="cpu")


def test_msm_valid_batch_passes(msm_verifier, monkeypatch):
    calls = []
    real = msm_verifier._dispatch_items
    monkeypatch.setattr(msm_verifier, "_dispatch_items", lambda *a: calls.append(a) or real(*a))
    assert msm_verifier(_items(16, tag=4)) == [True] * 16
    assert not calls  # the msm check alone, no A1 fallback


@pytest.mark.parametrize("case", ["corrupted", "wrong_message"])
def test_msm_bad_signature_isolated(msm_verifier, case):
    """A failed batch falls back to the per-item kernel and flags exactly
    the bad signature."""
    items = _items(16, tag=5)
    pk, msg, sig = items[7]
    if case == "corrupted":
        items[7] = (pk, msg, sig[:10] + bytes([sig[10] ^ 1]) + sig[11:])
    else:
        items[7] = (pk, b"different", sig)
    assert msm_verifier(items) == [True] * 7 + [False] + [True] * 8


def test_msm_malformed_inputs_excluded(msm_verifier):
    items = _items(16, tag=6)
    items[0] = (b"\x01" * 31, b"x", b"\x02" * 64)  # short key
    items[1] = (items[1][0], items[1][1], items[1][2][:32] + (ref.L + 1).to_bytes(32, "little"))
    assert msm_verifier(items) == [False, False] + [True] * 14


def test_msm_padding_is_inert(msm_verifier):
    """9 items pad to a 16 bucket with zero rows: zero digits make them
    identity terms, so the batch passes on the msm check alone."""
    handle = msm_verifier.submit(_items(9, tag=7))
    assert [(e[0], e[3]) for e in handle[2]] == [("msm", 7)]
    assert msm_verifier.collect(handle) == [True] * 9


def test_small_buckets_stay_on_item_kernel():
    v = GpuVerifier(max_bucket=16, msm_min_bucket=512, mode="msm", device="cpu")
    handle = v.submit(_items(4, tag=8))
    assert [entry[0] for entry in handle[2]] == ["item"]
    assert v.collect(handle) == [True] * 4


def test_msm_torsion_defect_is_deterministic(msm_verifier):
    """The torsion-defect signature is cofactored-accepted whatever the
    random z_i, in a passing bucket and in one whose corrupted co-passenger
    forces the per-item fallback (which answers with the cofactored rule)."""
    torsion = _torsion_item(9)
    items = _items(15, tag=9) + [torsion]
    assert [msm_verifier(items) for _ in range(2)] == [[True] * 16] * 2
    items2 = _items(14, tag=10) + [torsion]
    pk0, msg0, sig0 = items2[0]
    items2[0] = (pk0, msg0, sig0[:8] + bytes([sig0[8] ^ 1]) + sig0[9:])
    assert [msm_verifier(items2) for _ in range(2)] == [[False] + [True] * 14] * 2
    # The item mode keeps the strict rule.
    strict = GpuVerifier(max_bucket=B, mode="item", device="cpu")
    assert strict(items) == [True] * 15 + [False]


def test_group_lane_aggregate_verify(fx):
    """submit_groups fuses several proofs into one launch; honest groups
    pass, a tampered group is isolated without affecting the others, also
    through the service's group lane."""
    groups = _fixture_groups(fx, (1, 2, 3), tamper=(3,))
    v = GpuVerifier(max_bucket=64, msm_min_bucket=16, mode="msm", device="cpu")
    assert v.collect_groups(v.submit_groups(groups)) == [True, True, False]
    svc = VerifyService(v, max_batch=64, max_delay=0.002)
    try:
        async def scenario():
            return await asyncio.wait_for(
                asyncio.gather(*(svc.verify_aggregate(*g) for g in groups)), 120.0)

        assert asyncio.run(scenario()) == [True, True, False]
    finally:
        svc.shutdown()
    assert not svc._submit_thread.is_alive() and not svc._collect_thread.is_alive()


def test_group_chunk_bisect_keeps_honest_groups_off_host(monkeypatch, fx):
    """One bad compact certificate in a fused chunk costs exactly one host
    walk (its own group): the chunk bisects by solo launches."""
    groups = _fixture_groups(fx, range(1, 4)) + _fixture_groups(fx, (4,), tamper=(4,))
    host_calls = []
    real_host = types_mod.host_verify_aggregate

    def counting(items, zs, s_agg):
        host_calls.append(s_agg)
        return real_host(items, zs, s_agg)

    monkeypatch.setattr(types_mod, "host_verify_aggregate", counting)
    v = GpuVerifier(max_bucket=64, msm_min_bucket=16, mode="msm", device="cpu")
    handle = v.submit_groups(groups)
    assert len(handle[2]) == 1  # one fused chunk of 4 groups
    assert v.collect_groups(handle) == [True, True, True, False]
    assert host_calls == [groups[3][2]]


def test_group_lane_empty_and_oversized_groups(fx):
    groups = _fixture_groups(fx, (1, 2))
    items, zs, s_agg = groups[1]
    v = GpuVerifier(max_bucket=4, msm_min_bucket=16, mode="msm", device="cpu")
    # 4 signers = 8 rows > max_bucket 4: host-verified; an empty group fails.
    assert v.collect_groups(v.submit_groups([groups[0], ([], [], 0)])) == [True, False]


def test_service_items_msm_and_errors(monkeypatch):
    """VerifyService's item lane answers with the verifier's verdicts; a
    failing submit resolves the futures with its exception (no host
    fallback); shared() keys instances by mode and shard count, and its
    2-shard msm service (a CPU data mesh) serves the 1-shard one's
    verdicts."""
    v = GpuVerifier(max_bucket=B, msm_min_bucket=B, mode="msm", device="cpu")
    svc = VerifyService(v, max_batch=B, max_delay=0.002)
    items = _items(6, tag=11)
    items[2] = (items[2][0], b"other", items[2][2])
    try:
        async def scenario():
            return await asyncio.wait_for(
                asyncio.gather(*(svc.verify(*it) for it in items)), 120.0)

        assert asyncio.run(scenario()) == [True, True, False, True, True, True]

        def boom(_items):
            raise RuntimeError("launch failed")

        monkeypatch.setattr(v, "submit", boom)

        async def failing():
            return await asyncio.wait_for(svc.verify(*items[0]), 60.0)

        with pytest.raises(RuntimeError, match="launch failed"):
            asyncio.run(failing())
    finally:
        svc.shutdown()

    a = VerifyService.shared("item", device="cpu")
    b = VerifyService.shared("msm", device="cpu")
    c = VerifyService.shared("msm", shards=2, devices=["cpu"] * 2)
    try:
        assert a is VerifyService.shared("item", device="cpu") and a is not b
        assert c is VerifyService.shared("msm", shards=2) and c is not b
        for svc_, mode in ((a, "item"), (b, "msm"), (c, "msm")):
            ver = svc_.verifier
            assert (ver.mode, ver.max_bucket, ver.msm_min_bucket, ver.fixed_bucket) == (
                mode, 2048, 16, True)
        assert b.verifier.mesh is None and c.verifier.mesh.shape == {"data": 2}
        mixed = _items(6, tag=12)
        mixed[4] = (mixed[4][0], b"other", mixed[4][2])  # the fallback runs too

        async def served():
            return await asyncio.wait_for(asyncio.gather(
                asyncio.gather(*(b.verify(*it) for it in mixed)),
                asyncio.gather(*(c.verify(*it) for it in mixed))), 300.0)

        one, two = asyncio.run(served())
        assert one == two == [True] * 4 + [False, True]
    finally:
        a.shutdown()
        b.shutdown()
        c.shutdown()
    assert not {"item:1", "msm:1", "msm:2"} & set(VerifyService._shared)

    async def closed():
        return await a.verify(*items[0])

    with pytest.raises(RuntimeError, match="shut down"):
        asyncio.run(closed())


def test_verifier_rejects_unknown_mode():
    with pytest.raises(ValueError):
        GpuVerifier(mode="fast", device="cpu")
    assert tverifier.GpuVerifier(device="cpu").mode == "msm"


@pytest.mark.slow
def test_msm_accumulate_plain_matches_jax_kernel():
    """Raw limbs equal to the jitted JAX `msm_accumulate_kernel` (about 4-5
    min of XLA compile on a CPU host)."""
    arrays, _, _ = _msm_rows(4)
    va, vr, valid = tk.msm_accumulate_plain(*[torch.from_numpy(a) for a in arrays])
    ja, jr, jvalid = jk.msm_accumulate_kernel(*arrays)
    assert np.array_equal(va.numpy(), np.asarray(ja))
    assert np.array_equal(vr.numpy(), np.asarray(jr))
    assert valid.tolist() == np.asarray(jvalid).tolist()
