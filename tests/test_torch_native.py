"""The port's native host library against the JAX package's, and the
verifier's mode reader.

`narwhal_tpu_torch.native` builds its own copies of the C++ sources
(`narwhal_tpu_torch/native_src/`) with g++ into `native_src/_build/`. Here:
the port's `_precheck_native`, `_fold_native` and the group lane's
`scalar_mulmod` are bit-identical to the JAX package's and to their Python
twins on seeded items (bad lengths, S >= L, A and R with y >= p, forged
signatures); the libraries build under a name of their own, to a
temporary file renamed into place, never into the JAX package's `native/`;
NARWHAL_NATIVE=0 turns the native branch off as in the reference; and
`GpuVerifier(mode=None)` reads NARWHAL_TPU_VERIFY_MODE.
"""

import os
import random
import threading

import numpy as np
import pytest

from narwhal_tpu import native as j_native
from narwhal_tpu.tpu.verifier import TpuVerifier
from narwhal_tpu_torch import native as t_native
from narwhal_tpu_torch.config import ConfigError
from narwhal_tpu_torch.crypto import KeyPair
from narwhal_tpu_torch.gpu import ed25519_ref as ref
from narwhal_tpu_torch.gpu.verifier import GpuVerifier

N_ITEMS = 64


def seeded_items(seed: int = 5):
    """64 signature items: valid ones over varied message lengths (0
    included), and at fixed rows a short key, a short signature, S >= L,
    A with y >= p, R with y >= p, and forged signatures (which pass the
    precheck)."""
    rng = random.Random(seed)
    keys = [KeyPair.from_seed(rng.randbytes(32)) for _ in range(8)]
    items = []
    for i in range(N_ITEMS):
        kp = keys[i % len(keys)]
        msg = rng.randbytes(i % 7 * 33)
        items.append((kp.public, msg, kp.sign(msg)))
    pk, msg, sig = items[3]
    items[3] = (pk[:31], msg, sig)
    pk, msg, sig = items[9]
    items[9] = (pk, msg, sig[:63])
    pk, msg, sig = items[11]
    items[11] = (pk, msg, sig[:32] + (ref.L + 5).to_bytes(32, "little"))
    pk, msg, sig = items[17]
    items[17] = ((ref.P + 3).to_bytes(32, "little"), msg, sig)
    pk, msg, sig = items[23]
    items[23] = (pk, msg, (2**255 - 1).to_bytes(32, "little") + sig[32:])
    for i in (30, 41, 52):
        pk, msg, sig = items[i]
        items[i] = (pk, msg, sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:])
    return items


@pytest.fixture(scope="module")
def libs():
    port, jax = t_native.load_scalar(), j_native.load_scalar()
    assert port is not None, "g++ is here: the port's scalar library must build"
    assert jax is not None
    return port, jax


@pytest.fixture(scope="module")
def verifiers():
    return GpuVerifier(device="cpu", mode="item"), TpuVerifier(max_bucket=16)


def test_precheck_native_matches_jax_and_python(libs, verifiers):
    port_lib, jax_lib = libs
    port, jax = verifiers
    items = seeded_items()
    got = port._precheck_native(items, port_lib)
    want = jax._precheck_native(items, jax_lib)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.flatnonzero(~got[0]).tolist() == [3, 9, 11, 17, 23]
    for twin in (port._precheck_py(items), jax._precheck_py(items)):
        assert np.array_equal(got[0], twin[0])
        idx = np.flatnonzero(got[0])
        for a, b in zip(got[1:], twin[1:]):
            assert np.array_equal(a[idx], b[idx])


def test_fold_and_mulmod_native_match_jax_and_python(libs, verifiers):
    port_lib, jax_lib = libs
    port, jax = verifiers
    items = seeded_items()
    pre, _a, _r, s_all, k_all = port._precheck_native(items, port_lib)
    idx = np.flatnonzero(pre)
    k_rows = np.ascontiguousarray(k_all[idx])
    s_rows = np.ascontiguousarray(s_all[idx])
    rnd = random.Random(9).randbytes(16 * idx.size)
    ak, total = port._fold_native(port_lib, k_rows, s_rows, rnd)
    for other in (jax._fold_native(jax_lib, k_rows, s_rows, rnd),
                  port._fold_py(k_rows, s_rows, rnd), jax._fold_py(k_rows, s_rows, rnd)):
        assert np.array_equal(ak, other[0]) and total == other[1]

    # The group lane's effective scalars: w (128-bit) * z, then * k, mod L;
    # rows of L - 1 and of zero too.
    rng = np.random.default_rng(3)
    m = idx.size
    w_rows = np.zeros((m, 32), np.uint8)
    w_rows[:, :16] = rng.integers(0, 256, (m, 16), dtype=np.uint8)
    z_rows = np.zeros((m, 32), np.uint8)
    z_rows[:, :16] = rng.integers(0, 256, (m, 16), dtype=np.uint8)
    w_rows[0] = np.frombuffer((ref.L - 1).to_bytes(32, "little"), np.uint8)
    z_rows[1] = 0
    y = port._mulmod_native(port_lib, w_rows, z_rows)
    ak_items = port._mulmod_native(port_lib, y, k_rows)
    for a, b, got in ((w_rows, z_rows, y), (y, k_rows, ak_items)):
        want = np.empty_like(got)
        jax_lib.scalar_mulmod(m, a.ctypes.data, b.ctypes.data, want.ctypes.data)
        assert np.array_equal(got, want)
        assert np.array_equal(got, port._mulmod_py(a, b))


def test_native_branch_gives_the_python_verdicts(monkeypatch):
    """The CPU verifier's item and group lanes give the same verdicts with
    the native library and with NARWHAL_NATIVE=0's Python twins."""
    from narwhal_tpu_torch.fixtures import CommitteeFixture, make_signed_certificates
    from narwhal_tpu_torch.types import Certificate

    items = seeded_items()[:32]
    f = CommitteeFixture(size=4)
    genesis = {c.digest for c in Certificate.genesis(f.committee)}
    certs, _ = make_signed_certificates(f, 1, 1, genesis)
    groups = [Certificate.compact_from_votes(c.header, c.signers, c.signatures)
              .aggregate_group(f.committee) for c in certs]
    items_g, zs, s_agg = groups[1]
    groups[1] = (items_g, zs, (s_agg + 1) % ref.L)
    v = GpuVerifier(device="cpu", mode="msm", max_bucket=16, msm_min_bucket=16)
    runs = []
    for lib in (t_native.load_scalar(), None):
        monkeypatch.setattr(t_native, "_scalar", lib)
        monkeypatch.setattr(t_native, "_scalar_tried", True)
        runs.append((v(items), v.collect_groups(v.submit_groups(groups))))
    assert runs[0] == runs[1]
    assert runs[0][1] == [True, False, True, True]
    assert [i for i, ok in enumerate(runs[0][0]) if not ok] == [3, 9, 11, 17, 23, 30]


def test_native_disabled_by_environment(monkeypatch):
    monkeypatch.setenv("NARWHAL_NATIVE", "0")
    for lib, tried in (("_lib", "_tried"), ("_scalar", "_scalar_tried")):
        monkeypatch.setattr(t_native, lib, None)
        monkeypatch.setattr(t_native, tried, False)
    assert t_native.load() is None and t_native.load_scalar() is None
    with pytest.raises(RuntimeError, match="unavailable"):
        t_native.NativeEngine(None)


def test_build_is_named_by_source_and_renamed_into_place(monkeypatch, tmp_path):
    """Four threads build one library into an empty directory at once: one
    name, no temporary file left, a library that loads; the name changes
    with the flags; the port's libraries live under its own native_src/."""
    import ctypes

    for lib in (t_native.load(), t_native.load_scalar()):
        assert os.path.dirname(lib._name) == os.path.join(t_native.SRC_DIR, "_build")
    monkeypatch.setattr(t_native, "BUILD_DIR", str(tmp_path))
    paths = [None] * 4

    def build(i):
        paths[i] = t_native._build_lib("scalar_ops")

    threads = [threading.Thread(target=build, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert len(set(paths)) == 1 and paths[0].startswith(str(tmp_path))
    assert os.listdir(tmp_path) == [os.path.basename(paths[0])]
    ctypes.CDLL(paths[0]).scalar_mulmod  # noqa: B018 - the symbol resolves
    assert t_native._target("scalar_ops", ("-lz",)) != paths[0]


@pytest.mark.parametrize("env,mode,want", [
    (None, None, "msm"),
    ("item", None, "item"),
    ("msm", None, "msm"),
    ("item", "msm", "msm"),
    ("itme", None, ConfigError),
    ("", None, ConfigError),
    (None, "bogus", ConfigError),
])
def test_verify_mode_reader(monkeypatch, env, mode, want):
    if env is None:
        monkeypatch.delenv("NARWHAL_TPU_VERIFY_MODE", raising=False)
    else:
        monkeypatch.setenv("NARWHAL_TPU_VERIFY_MODE", env)
    if want is ConfigError:
        with pytest.raises(ConfigError) as err:
            GpuVerifier(device="cpu", mode=mode)
        named = "NARWHAL_TPU_VERIFY_MODE" if mode is None else "verify mode"
        assert named in str(err.value) and repr(mode if mode else env) in str(err.value)
    else:
        assert GpuVerifier(device="cpu", mode=mode).mode == want
