"""Parity of the port's mesh-sharded verifier and its staged kernels (A3-A6)
with the JAX package, on the CPU.

- Each plain stage (`verify_decompress_plain`, `verify_straus_plain`,
  `verify_verdict_plain`, `msm_window_plain`) raw-limb equal to the JAX
  stage (`verify_decompress_kernel`, `verify_straus_kernel`,
  `verify_verdict_kernel`, `msm_window_kernel`) run op by op under
  `jax.disable_jit()`, at B = 8 on a seeded batch of valid rows, forged
  rows, a bad-S row, an invalid R encoding and padding;
- the plain A3 -> A4 -> A5 bit-equal to the plain A1 on both lanes, and
  A3 -> A6 (A and R sets) raw-limb equal to the plain A2: the CPU form of
  `tests/test_tpu_ed25519.py::test_staged_kernels_match_monolith`;
- the plain shard reduce against a pt_add fold of shard lanes, and the
  sharded sum against the unsharded window lanes as affine points;
- `GpuVerifier(mesh=data_mesh(4, ["cpu"] * 4))` in both modes against the
  host library and the unsharded port verifier, without a launch of the
  monoliths; `VerifyService.shared(shards=2)` in
  tests/test_torch_msm.py;
- construction parity: the JAX `TpuVerifier(mesh=...)` over virtual CPU
  devices and the port's `GpuVerifier(mesh=...)` both raise ConfigError or
  both construct, and `data_mesh` refuses too few devices.

Exact everywhere. The CUDA kernels are held against these plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from narwhal_tpu import config as jconfig
from narwhal_tpu.tpu import ed25519 as jk
from narwhal_tpu.tpu import verifier as jverifier
from narwhal_tpu_torch.config import ConfigError
from narwhal_tpu_torch.crypto import KeyPair, _host_batch_verify
from narwhal_tpu_torch.gpu import ed25519 as tk
from narwhal_tpu_torch.gpu import ed25519_ref as ref
from narwhal_tpu_torch.gpu import kernel_registry
from narwhal_tpu_torch.gpu.verifier import DataMesh, GpuVerifier, data_mesh

B = 8


def _staged_items():
    """Five signatures (valid, valid, forged message, bad S, invalid R
    encoding) and one more valid: six precheck-passing rows."""
    rng = random.Random(41)
    kps = [KeyPair.from_seed(bytes([7, i]) * 16) for i in range(3)]
    items = []
    for i in range(6):
        kp = kps[i % 3]
        msg = b"staged %d" % i
        items.append((kp.public, msg, kp.sign(msg)))
    pk, msg, sig = items[2]
    items[2] = (pk, msg + b"!", sig)  # forged: the message changed
    pk, msg, sig = items[3]
    items[3] = (pk, msg, sig[:32] + (12345).to_bytes(32, "little"))  # canonical, wrong S
    while True:  # an R whose y has no x on the curve: only decompression flags it
        y = rng.randrange(ref.P)
        if ref.recover_x(y, 0) is None:
            break
    pk, msg, sig = items[4]
    items[4] = (pk, msg, y.to_bytes(32, "little") + sig[32:])
    return items


@pytest.fixture(scope="module")
def item_rows():
    """The item lane's B = 8 bucket of `_staged_items`: six rows and two
    padding rows repeating row 0, in the kernel dtypes."""
    v = GpuVerifier(mode="item", device="cpu")
    idx, packed = v.pack(_staged_items())
    assert idx.size == 6
    return GpuVerifier.bucket_arrays(packed, 0, 6, B - 6)


@pytest.fixture(scope="module")
def msm_rows(item_rows):
    """The same A and R rows with random digits (64 A lanes, 32 R lanes), the
    last two rows zero (the msm lane's padding)."""
    nprng = np.random.default_rng(43)
    arrays = [np.array(a) for a in item_rows[:4]]
    for a in arrays:
        a[6:] = 0
    ak = nprng.integers(0, 16, (B, 64)).astype(np.int8)
    z = nprng.integers(0, 16, (B, 32)).astype(np.int8)
    ak[6:] = 0
    z[6:] = 0
    return arrays + [ak, z]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _affine(v, w):
    X, Y, Z = (tk.limbs_to_int(np.asarray(v[c, :, w])) % ref.P for c in range(3))
    zi = pow(Z, ref.P - 2, ref.P)
    return X * zi % ref.P, Y * zi % ref.P


@pytest.fixture(scope="module")
def stages(item_rows):
    """The plain stage outputs on the item bucket: A3 on A and R, A4, A5."""
    a_y, a_sign, r_y, r_sign, kd, sd = _t(item_rows)
    a_pt, a_valid = tk.verify_decompress_plain(a_y, a_sign)
    r_pt, r_valid = tk.verify_decompress_plain(r_y, r_sign)
    acc = tk.verify_straus_plain(a_pt, kd, sd)
    strict, cof = tk.verify_verdict_plain(acc, r_pt, r_y, r_sign, a_valid, r_valid)
    return dict(a_pt=a_pt, a_valid=a_valid, r_pt=r_pt, r_valid=r_valid, acc=acc,
                strict=strict, cof=cof)


def test_decompress_matches_jax_eager(item_rows, stages):
    """A3 on the A and the R set at once (16 lanes: the stage is lane-wise)."""
    y = np.concatenate([item_rows[0], item_rows[2]])
    sign = np.concatenate([item_rows[1], item_rows[3]])
    with jax.disable_jit():
        jpts, jvalid = jk.verify_decompress_kernel(jnp.asarray(y), jnp.asarray(sign))
    pts, valid = tk.verify_decompress_plain(*_t([y, sign]))
    assert tuple(pts.shape) == (4, tk.NLIMB, 2 * B) and pts.dtype == torch.int32
    assert np.array_equal(np.asarray(jpts), pts.numpy())
    assert np.asarray(jvalid).tolist() == valid.tolist()
    assert torch.equal(pts[..., :B], stages["a_pt"]) and torch.equal(pts[..., B:], stages["r_pt"])
    # Every A decompresses; the invalid R encoding of row 4 is flagged.
    assert valid.tolist() == [True] * B + [True] * 4 + [False] + [True] * 3


def test_straus_matches_jax_eager(item_rows, stages):
    """A4 over the first 2 windows (the JAX stage scans as many windows as
    its digits have; 2 keep the eager run short): the -A table and the
    window steps. All 64 windows: the slow test against the jitted stage,
    and through A5 the equality with the plain A1 below."""
    kd, sd = item_rows[4][:, :2], item_rows[5][:, :2]
    with jax.disable_jit():
        jacc = jk.verify_straus_kernel(
            jnp.asarray(stages["a_pt"].numpy()), jnp.asarray(kd), jnp.asarray(sd))
    acc = tk.verify_straus_plain(stages["a_pt"], *_t([kd, sd]))
    assert np.array_equal(np.asarray(jacc), acc.numpy())


def test_verdict_matches_jax_eager(item_rows, stages):
    with jax.disable_jit():
        js, jc = jk.verify_verdict_kernel(
            jnp.asarray(stages["acc"].numpy()), jnp.asarray(stages["r_pt"].numpy()),
            jnp.asarray(item_rows[2]), jnp.asarray(item_rows[3]),
            jnp.asarray(stages["a_valid"].numpy()), jnp.asarray(stages["r_valid"].numpy()))
    assert np.asarray(js).tolist() == stages["strict"].tolist()
    assert np.asarray(jc).tolist() == stages["cof"].tolist()
    # Valid rows (and the padding, which repeats row 0) pass; forged, bad S
    # and the invalid R fail under both rules.
    want = [True, True, False, False, False, True, True, True]
    assert stages["strict"].tolist() == want and stages["cof"].tolist() == want


def test_staged_plain_matches_plain_verify_batch(item_rows, stages):
    strict, cof = tk.verify_batch_plain(*_t(item_rows))
    assert torch.equal(strict, stages["strict"]) and torch.equal(cof, stages["cof"])


def test_msm_window_matches_jax_eager(msm_rows):
    """A6 over the R set, raw limbs equal to the JAX stage run op by op
    (B = 8: one chunk of 8 chains, three tree rounds; 32 lanes, with the
    invalid row 4 and two zero rows). The 64-lane A slot runs the same code:
    its accumulate is held to JAX in tests/test_torch_msm.py, and A6 on it
    to A2 below."""
    digits = msm_rows[5]
    pts, _ = tk.verify_decompress_plain(*_t(msm_rows[2:4]))
    v = tk.msm_window_plain(pts, torch.from_numpy(digits))
    with jax.disable_jit():
        jv = jk.msm_window_kernel(jnp.asarray(pts.numpy()), jnp.asarray(digits))
    assert tuple(v.shape) == (4, tk.NLIMB, digits.shape[1])
    assert np.array_equal(np.asarray(jv), v.numpy())


def test_staged_plain_msm_matches_plain_msm_accumulate(msm_rows):
    """A3 -> A6 on each point set is A2 on the bucket, raw limb for raw limb
    (same chains, same tree, same operations), validity bit for bit."""
    t = _t(msm_rows)
    va, vr, valid = tk.msm_accumulate_plain(*t)
    a_pt, a_valid = tk.verify_decompress_plain(t[0], t[1])
    r_pt, r_valid = tk.verify_decompress_plain(t[2], t[3])
    assert torch.equal(tk.msm_window_plain(a_pt, t[4]), va)
    assert torch.equal(tk.msm_window_plain(r_pt, t[5]), vr)
    assert torch.equal(a_valid & r_valid, valid)
    assert valid.tolist() == [True] * 4 + [False] + [True] * 3  # zero rows decompress


def test_shard_reduce_folds_the_shard_lanes(msm_rows):
    """The plain reduce is the pt_add fold of the lane sets in shard order;
    over the four 2-row shards of the bucket's A set (every point on the
    curve) it gives the unsharded A6's lanes as affine points."""
    t = _t(msm_rows)
    a_pt, a_valid = tk.verify_decompress_plain(t[0], t[1])
    assert bool(a_valid.all())
    whole = tk.msm_window_plain(a_pt, t[4])
    lanes = torch.stack([
        tk.msm_window_plain(a_pt[..., 2 * i:2 * i + 2].contiguous(), t[4][2 * i:2 * i + 2])
        for i in range(4)
    ])
    got = tk.msm_shard_reduce_plain(lanes)
    fold = tuple(lanes[0, c] for c in range(4))
    for s in range(1, 4):
        fold = tk.pt_add(fold, tuple(lanes[s, c] for c in range(4)))
    assert torch.equal(got, torch.stack(fold))
    assert all(_affine(got.numpy(), w) == _affine(whole.numpy(), w) for w in range(64))
    assert torch.equal(tk.msm_shard_reduce(lanes), got)  # CPU tensors: the plain version
    assert torch.equal(tk.msm_shard_reduce_plain(lanes[:1]), lanes[0])


def test_staged_wrappers_dispatch_rules(item_rows, msm_rows):
    """CPU tensors run the plain versions and launch nothing; other devices
    raise; the kernels' input checks refuse what they do not take."""
    a_y, a_sign, r_y, r_sign, kd, sd = _t(item_rows)
    kernel_registry.reset_launch_counts()
    pts, valid = tk.verify_decompress(a_y, a_sign)
    acc = tk.verify_straus(pts, kd, sd)
    tk.verify_verdict(acc, pts, r_y, r_sign, valid, valid)
    tk.msm_window(pts, kd)
    assert set(kernel_registry.launch_counts().values()) == {0}
    meta = torch.zeros((4, tk.NLIMB, B), dtype=torch.int32, device="meta")
    for call in (
        lambda: tk.verify_decompress(a_y.to("meta"), a_sign.to("meta")),
        lambda: tk.verify_straus(meta, kd.to("meta"), sd.to("meta")),
        lambda: tk.verify_verdict(meta, meta, r_y, r_sign, valid, valid),
        lambda: tk.msm_window(meta, kd.to("meta")),
        lambda: tk.msm_shard_reduce(meta[None]),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    with pytest.raises(ValueError, match="int16"):
        tk._check_inputs("verify_decompress", {"y_rows": (a_y.int(), torch.int16, (B, 20))},
                         a_y.device)
    with pytest.raises(ValueError, match="contiguous"):
        tk._check_inputs("verify_straus", {"a_pt": (pts.transpose(1, 2), torch.int32,
                                                    (4, B, tk.NLIMB))}, pts.device)
    with pytest.raises(ValueError, match="chains"):
        tk._check_chains("msm_window", 24)
    assert tk._check_chains("msm_window", 512) == 128 and tk._check_chains("msm_window", 8) == 8


def test_staged_field_ops_make_a1():
    """Two A3 rows, one A4 and one A5 cost A1's operations; A6's count is
    A2's lane share without the decompression."""
    ops = tk.staged_field_ops()
    a1 = tk.field_muls_per_signature()
    for kind in ("sq", "mul"):
        assert (2 * ops["verify_decompress"][kind] + ops["verify_straus"][kind]
                + ops["verify_verdict"][kind]) == a1[kind]
    a2 = tk.msm_field_ops(2 * 2048, 2048, 2048, 2048)
    a6 = [tk.msm_window_ops(2048, w, 2048) for w in (64, 32)]
    assert a6[0] + a6[1] + 2 * 2048 * 20 == a2["mul"]
    assert tk.msm_window_ops(0, 64, 2048) == 0


# ---------------------------------------------------------------------------
# The sharded verifier
# ---------------------------------------------------------------------------


def _registry_batch():
    """tests/test_kernel_registry.py's batch: 28 valid, a forgery, a junk
    signature, a short key, a valid tail."""
    kp = KeyPair.from_seed(b"\x05" * 32)
    items = [(kp.public, b"m%d" % i, kp.sign(b"m%d" % i)) for i in range(28)]
    items.append((kp.public, b"forged", kp.sign(b"not-forged")))
    items.append((kp.public, b"mangled", b"\x00" * 64))
    items.append((kp.public[:16], b"short", kp.sign(b"short")))
    items.append((kp.public, b"ok-tail", kp.sign(b"ok-tail")))
    return items


@pytest.mark.parametrize("mode", ["item", "msm"])
def test_sharded_verifier_matches_host_and_unsharded(monkeypatch, mode):
    items = _registry_batch()
    expected = _host_batch_verify(items)
    assert expected[:28] == [True] * 28 and expected[28:31] == [False] * 3
    flat = GpuVerifier(max_bucket=32, msm_min_bucket=16, mode=mode, device="cpu")
    assert flat(items) == expected

    def monolith(*_a):
        raise AssertionError("the sharded verifier ran a monolith")

    monkeypatch.setattr(tk, "verify_batch", monolith)
    monkeypatch.setattr(tk, "msm_accumulate", monolith)
    mesh = data_mesh(4, devices=["cpu"] * 4)
    v = GpuVerifier(max_bucket=32, msm_min_bucket=16, mode=mode, mesh=mesh)
    assert v.device.type == "cpu" and v.mesh is mesh
    handle = v.submit(items)
    assert [e[0] for e in handle[2]] == [mode]
    assert v.collect(handle) == expected


def test_data_mesh_devices_and_refusals():
    mesh = data_mesh(3, devices=["cpu"] * 5)
    assert isinstance(mesh, DataMesh) and mesh.shape == {"data": 3}
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ConfigError, match="pinned"):
        data_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ConfigError, match="at least 1"):
        data_mesh(0, devices=["cpu"])
    # No CPU fallback: more shards than cards raise wherever the test runs.
    with pytest.raises(ConfigError, match="exceeds available devices"):
        data_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="device or a mesh"):
        GpuVerifier(max_bucket=32, device="cpu", mesh=data_mesh(2, devices=["cpu"] * 2))


def _jax_mesh(shards, n_devices):
    cpus = jax.devices("cpu")
    assert len(cpus) >= n_devices, "tests/conftest.py forces 8 host devices"
    return jverifier.data_mesh(shards, devices=cpus[:n_devices])


@pytest.mark.parametrize("shards,max_bucket,fixed,axis,n_devices", [
    (1, 32, False, "data", 1),
    (2, 32, False, "data", 2),
    (3, 32, False, "data", 3),  # 16 % 3
    (4, 32, False, "data", 4),
    (8, 16, False, "data", 8),
    (3, 48, True, "data", 3),  # fixed: only 48 must split
    (3, 48, False, "data", 3),  # 16 % 3
    (4, 2048, True, "data", 4),
    (6, 2048, True, "data", 6),  # 2048 % 6
    (5, 40, True, "data", 5),
    (2, 32, False, "auth", 2),  # no such axis
    (4, 32, False, "data", 2),  # too few pinned devices
])
def test_construction_parity_with_jax(shards, max_bucket, fixed, axis, n_devices):
    """The JAX TpuVerifier(mesh=...) over virtual CPU devices and the port's
    GpuVerifier(mesh=...) both raise ConfigError or both construct
    (building the JAX verifier makes jit wrappers only; it compiles
    nothing)."""
    outcomes = []
    for make_mesh, make_verifier, error in (
        (lambda: _jax_mesh(shards, n_devices),
         lambda m: jverifier.TpuVerifier(max_bucket=max_bucket, mode="item",
                                         fixed_bucket=fixed, mesh=m, data_axis=axis),
         jconfig.ConfigError),
        (lambda: data_mesh(shards, devices=["cpu"] * n_devices),
         lambda m: GpuVerifier(max_bucket=max_bucket, mode="item", fixed_bucket=fixed,
                               mesh=m, data_axis=axis),
         ConfigError),
    ):
        try:
            make_verifier(make_mesh())
        except error:
            outcomes.append("ConfigError")
        else:
            outcomes.append("built")
    assert outcomes[0] == outcomes[1], outcomes


@pytest.mark.slow
def test_staged_plain_matches_jax_jitted_stages(item_rows, stages, msm_rows):
    """Raw limbs equal to the jitted JAX stages (minutes of XLA compile on a
    CPU host)."""
    a_pt, a_valid = jk.verify_decompress_kernel(item_rows[0], item_rows[1])
    assert np.array_equal(np.asarray(a_pt), stages["a_pt"].numpy())
    acc = jk.verify_straus_kernel(a_pt, item_rows[4], item_rows[5])
    assert np.array_equal(np.asarray(acc), stages["acc"].numpy())
    r_pt, r_valid = jk.verify_decompress_kernel(item_rows[2], item_rows[3])
    strict, cof = jk.verify_verdict_kernel(acc, r_pt, item_rows[2], item_rows[3],
                                           a_valid, r_valid)
    assert np.asarray(strict).tolist() == stages["strict"].tolist()
    assert np.asarray(cof).tolist() == stages["cof"].tolist()
    pts, _ = tk.verify_decompress_plain(*_t(msm_rows[:2]))
    v = jk.msm_window_kernel(pts.numpy(), msm_rows[4])
    assert np.array_equal(np.asarray(v), tk.msm_window_plain(pts, _t(msm_rows[4:5])[0]).numpy())
