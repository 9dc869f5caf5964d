"""Parity of the PyTorch port's ed25519 layer with the JAX package.

`narwhal_tpu_torch.gpu.ed25519` is held against `narwhal_tpu.tpu.ed25519`
(evaluated eagerly, no jit, on the CPU) and against the bigint oracle
`ed25519_ref`: field values compared mod p, points in affine form, verdicts
bit for bit. Inputs come from numpy / random seeds. Exact everywhere.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py; the parity test against the
jitted JAX `verify_batch_kernel` costs minutes of XLA compile on the CPU and
is marked slow.
"""

import random

import numpy as np
import pytest
import torch

from narwhal_tpu.crypto import verify as host_verify
from narwhal_tpu.tpu import ed25519 as jk
from narwhal_tpu_torch.crypto import KeyPair
from narwhal_tpu_torch.gpu import ed25519 as tk
from narwhal_tpu_torch.gpu import ed25519_ref as ref
from narwhal_tpu_torch.gpu.verifier import GpuVerifier

P = ref.P


def _t(limbs):
    return torch.as_tensor(np.asarray(limbs, np.int32))


def _val(limbs) -> int:
    return tk.limbs_to_int(np.asarray(limbs)) % P


def _field_cases():
    rng = random.Random(3)
    cases = [(rng.randrange(P), rng.randrange(P)) for _ in range(3)]
    cases.append((P - 1, P - 2))
    cases.append((0, 1))
    return cases


LOOSE_LIMBS = np.full(tk.NLIMB, tk.LOOSE, np.int32)  # every limb at the loose bound


@pytest.mark.parametrize("case", range(5))
def test_field_ops_match_jax_and_bigint(case):
    a, b = _field_cases()[case]
    la, lb = tk.int_to_limbs(a), tk.int_to_limbs(b)
    for name, want in (
        ("fe_mul", a * b % P),
        ("fe_add", (a + b) % P),
        ("fe_sub", (a - b) % P),
    ):
        got = getattr(tk, name)(_t(la), _t(lb))
        assert _val(got) == want, name
        jgot = getattr(jk, name)(la, lb)
        assert _val(got) == _val(jgot), name
    assert _val(tk.fe_sq(_t(la))) == a * a % P
    assert _val(tk.fe_neg(_t(la))) == (-a) % P == _val(jk.fe_neg(la))
    assert tk.limbs_to_int(tk.fe_canonical(_t(la))) == a % P


def test_field_ops_at_the_loose_bound():
    """Limbs at 9500 (the loose invariant's edge) stay exact and inside
    int32, and agree with the JAX functions bit for bit."""
    x = tk.limbs_to_int(LOOSE_LIMBS)
    y = tk.limbs_to_int(tk.int_to_limbs(P - 7))
    lx, ly = _t(LOOSE_LIMBS), _t(tk.int_to_limbs(P - 7))
    for name, want in (("fe_mul", x * y), ("fe_add", x + y), ("fe_sub", x - y)):
        got = getattr(tk, name)(lx, ly)
        assert _val(got) == want % P
        assert int(got.max()) <= tk.LOOSE and int(got.min()) >= 0
        assert np.array_equal(got.numpy(), np.asarray(getattr(jk, name)(LOOSE_LIMBS, ly.numpy())))
    sq = tk.fe_sq(lx)
    assert np.array_equal(sq.numpy(), np.asarray(jk.fe_sq(LOOSE_LIMBS)))
    assert tk.limbs_to_int(tk.fe_canonical(lx)) == x % P


def test_field_batch_axis_and_inversion():
    rng = np.random.default_rng(0)
    vals = [int(v) for v in rng.integers(1, 2**62, 6)] + [P - 1, 2**255 - 20]
    limbs = np.stack([tk.int_to_limbs(v % P) for v in vals], axis=1)  # [20, B]
    inv = tk.fe_invert(_t(limbs))
    pw = tk.fe_pow22523(_t(limbs))
    for j, v in enumerate(vals):
        assert _val(inv[:, j]) == pow(v, P - 2, P)
        assert _val(pw[:, j]) == pow(v, (P - 5) // 8, P)
    eq = tk.fe_eq(_t(limbs), _t(limbs))
    assert bool(eq.all())
    assert tk.limbs_to_int(tk.fe_canonical(_t(tk.int_to_limbs(P + 5)))) == 5


def test_constants_pinned_to_jax():
    for name in ("_BT", "_SUB_BIAS", "_D", "_2D", "_SQRT_M1", "_P_LIMBS", "_ONE"):
        assert np.array_equal(getattr(tk, name), np.asarray(getattr(jk, name))), name
    assert tk.NLIMB == jk.NLIMB and tk.RADIX == jk.RADIX and tk.WINDOWS == jk.WINDOWS


def test_packing_helpers_match_jax():
    raw = np.random.default_rng(1).integers(0, 256, (9, 32)).astype(np.uint8)
    assert np.array_equal(tk.bytes_to_limbs(raw), jk.bytes_to_limbs(raw))
    assert np.array_equal(tk.bytes_to_digits(raw), jk.bytes_to_digits(raw))


def _ext(p):
    return tuple(_t(tk.int_to_limbs(c % P)) for c in p)


def _affine(e):
    x, y, z = (_val(c) for c in e[:3])
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


@pytest.mark.parametrize("op", ["add", "double", "add_cached", "add_cached_z1", "neg"])
def test_point_ops_match_reference_and_jax(op):
    p1 = ref.point_mul(987654321, ref.G)
    p2 = ref.point_mul(123456789, ref.G)
    j1 = tuple(tk.int_to_limbs(c % P) for c in p1)
    j2 = tuple(tk.int_to_limbs(c % P) for c in p2)
    if op == "add":
        got, want = tk.pt_add(_ext(p1), _ext(p2)), ref.point_add(p1, p2)
        jgot = jk.pt_add(j1, j2)
    elif op == "double":
        got, want = tk.pt_double(_ext(p1)), ref.point_double(p1)
        jgot = jk.pt_double(j1)
    elif op == "add_cached":
        got, want = tk.pt_add_cached(_ext(p1), tk.pt_cache(_ext(p2))), ref.point_add(p1, p2)
        jgot = jk.pt_add_cached(j1, jk.pt_cache(j2))
    elif op == "add_cached_z1":
        x2, y2 = ref.affine(p2)
        p2a = (x2, y2, 1, x2 * y2 % P)
        yp, ym, _z, t2d = tk.pt_cache(_ext(p2a))
        got, want = tk.pt_add_cached_z1(_ext(p1), (yp, ym, t2d)), ref.point_add(p1, p2)
        jyp, jym, _jz, jt2d = jk.pt_cache(tuple(tk.int_to_limbs(c) for c in p2a))
        jgot = jk.pt_add_cached_z1(j1, (jyp, jym, jt2d))
    else:
        got, want = tk.pt_neg(_ext(p1)), ref.point_neg(p1)
        jgot = jk.pt_neg(j1)
    assert _affine(got) == ref.affine(want)
    assert _affine(got) == _affine(tuple(np.asarray(c) for c in jgot))


def test_decompress_valid_and_invalid():
    rng = random.Random(9)
    ys, signs, want = [], [], []
    for _ in range(4):  # valid points, both signs
        pt = ref.point_mul(rng.randrange(1, ref.L), ref.G)
        x, y = ref.affine(pt)
        ys.append(y)
        signs.append(x & 1)
        want.append(x)
    while len(ys) < 7:  # y with no x on the curve
        y = rng.randrange(P)
        if ref.recover_x(y, 0) is None:
            ys.append(y)
            signs.append(0)
            want.append(None)
    ys.append(1)  # x = 0: valid with sign 0, invalid with sign 1
    signs.append(1)
    want.append(None)
    limbs = np.stack([tk.int_to_limbs(y) for y in ys], axis=1)
    (x, y, z, t), valid = tk.decompress(_t(limbs), torch.as_tensor(signs, dtype=torch.int32))
    (jx, _jy, _jz, _jt), jvalid = jk.decompress(limbs, np.asarray(signs, np.int32))
    assert valid.tolist() == [w is not None for w in want]
    assert valid.tolist() == np.asarray(jvalid).tolist()
    for j, w in enumerate(want):
        if w is not None:
            assert _val(x[:, j]) == w == _val(np.asarray(jx)[:, j])
            assert _val(t[:, j]) == w * ys[j] % P


def _torsion_item(rng):
    """A signature under a torsion-shifted key: strict rejects, cofactored
    accepts (the case of tests/test_tpu_ed25519.py, from a seeded rng)."""
    while True:
        y = rng.randrange(P)
        x = ref.recover_x(y, 0)
        if x is None:
            continue
        t = ref.point_mul(ref.L, (x, y, 1, x * y % P))
        if t[0] % P != 0 or (t[1] - t[2]) % P != 0:
            break
    while True:
        a = rng.randrange(ref.L)
        pk = ref.compress(ref.point_add(ref.point_mul(a, ref.G), t))
        msg = b"torsion probe"
        r = rng.randrange(ref.L)
        rb = ref.compress(ref.point_mul(r, ref.G))
        k = ref.sha512_mod_l(rb, pk, msg)
        if k % 2 == 1:
            break
    return pk, msg, rb + ((r + k * a) % ref.L).to_bytes(32, "little")


def _items(seed=2, n=15):
    rng = random.Random(seed)
    keys = [KeyPair.from_seed(bytes([seed, i]) * 16) for i in range(5)]
    items = []
    for i in range(n):
        kp = keys[i % len(keys)]
        msg = bytes([i]) * (1 + i % 17)
        sig = kp.sign(msg)
        kind = i % 5
        if kind == 1:
            bad = bytearray(sig)
            bad[rng.randrange(32)] ^= 1 << rng.randrange(8)
            sig = bytes(bad)
        elif kind == 2:
            bad = bytearray(sig)
            bad[32 + rng.randrange(31)] ^= 1 << rng.randrange(8)
            sig = bytes(bad)
        elif kind == 3:
            msg = msg + b"!"
        elif kind == 4:
            kp = keys[(i + 1) % len(keys)]
        items.append((kp.public, msg, sig))
    return items


def _packed_bucket(items, pad_to):
    v = GpuVerifier(mode="item", device="cpu")
    idx, packed = v.pack(items)
    m = idx.size
    return idx, GpuVerifier.bucket_arrays(packed, 0, m, pad_to - m)


def test_verify_batch_plain_matches_host_library():
    """Valid, corrupt R, corrupt S, wrong message and wrong key, padded to
    a 16 bucket: strict verdicts equal the host library's; the torsion row
    is strict-rejected and cofactored-accepted."""
    items = _items() + [_torsion_item(random.Random(4))]
    idx, arrays = _packed_bucket(items, 16)
    strict, cof = tk.verify_batch(*[torch.from_numpy(a) for a in arrays])
    want = [host_verify(pk, m, s) for pk, m, s in items]
    assert strict[: idx.size].tolist() == [want[i] for i in idx]
    assert strict[15].item() is False and cof[15].item() is True
    # The verdicts of the rows that carry valid signatures agree.
    for j, i in enumerate(idx):
        if want[i]:
            assert cof[j].item() is True


def test_verifier_item_lane_malformed_and_odd_sizes():
    kp = KeyPair.from_seed(b"\x07" * 32)
    sig = kp.sign(b"x")
    high_s = sig[:32] + (ref.L + 1).to_bytes(32, "little")
    noncanon_r = (ref.P + 3).to_bytes(32, "little") + sig[32:]
    items = [
        (kp.public, b"x", b"short"),
        (b"\x00" * 31, b"x", sig),
        (kp.public, b"x", high_s),
        (kp.public, b"x", noncanon_r),
        (b"\xff" * 32, b"x", sig),  # y >= p: non-canonical key
        (kp.public, b"x", sig),
    ]
    v = GpuVerifier(max_bucket=16, mode="item", device="cpu")
    assert v(items) == [False, False, False, False, False, True]
    # Odd sizes across two buckets of a small max_bucket.
    v3 = GpuVerifier(max_bucket=4, mode="item", device="cpu")
    odd = [(kp.public, bytes([j]), kp.sign(bytes([j]))) for j in range(5)]
    odd[3] = (odd[3][0], b"other", odd[3][2])
    assert v3(odd) == [True, True, True, False, True]
    assert v3([]) == []


def test_verify_batch_dispatch_rules():
    """The wrapper runs the plain version on CPU tensors and refuses other
    devices; the kernel path checks dtypes before any launch."""
    idx, arrays = _packed_bucket(_items(n=5), 16)
    t = [torch.from_numpy(a) for a in arrays]
    got = tk.verify_batch(*t)
    plain = tk.verify_batch_plain(*t)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    with pytest.raises(ValueError):
        tk.verify_batch(*[x.to("meta") for x in t])
    with pytest.raises(ValueError):
        tk._check_kernel_inputs(t[0].int(), *t[1:])


def test_field_op_count_matches_kernel_structure():
    per = tk.field_muls_per_signature()
    assert per == {"sq": 1800, "mul": 2185}


@pytest.mark.slow
def test_verify_batch_plain_matches_jax_kernel():
    """Bit-equal verdicts against the jitted JAX `verify_batch_kernel` on
    the same packed rows (about 4-5 min of XLA compile on a CPU host)."""
    items = _items(n=15) + [_torsion_item(random.Random(4))]
    _idx, arrays = _packed_bucket(items, 16)
    strict, cof = tk.verify_batch(*[torch.from_numpy(a) for a in arrays])
    j_strict, j_cof = jk.verify_batch_kernel(*arrays)
    assert strict.tolist() == np.asarray(j_strict).tolist()
    assert cof.tolist() == np.asarray(j_cof).tolist()
