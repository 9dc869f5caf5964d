"""GpuVerifier: (pk, msg, sig) batches -> fixed-shape launches of the ed25519
kernels; VerifyService: the process-wide pipelined front over one of them.

Port of `narwhal_tpu/tpu/verifier.py` (`TpuVerifier`, `msm_epilogue_check`,
`VerifyService`; the JAX package's counterpart). Responsibilities, as in the
reference:

- host prechecks the kernels don't do: length, canonical S (< L), canonical
  R/A encodings (y < p);
- the SHA-512 challenge k = H(R || A || M) mod L (the device only sees
  256-bit scalars as 4-bit window digits);
- the msm lanes' mod-L scalars: ak_i = z_i k_i and sum z_i s_i (item lane),
  y_i = w_g z_i and y_i k_i (group lane). These and the prechecks run in the
  native scalar library (`native.load_scalar()`, native_src/scalar_ops.cpp:
  `_precheck_native`, `_fold_native`, `_mulmod_native`, the GIL released)
  when it builds, else in their bit-identical Python twins (`_precheck_py`,
  `_fold_py`, `_mulmod_py`);
- shape bucketing: each bucket pads to a power of two (or to `max_bucket`
  with `fixed_bucket`);
- two lanes for signature items: `mode="item"` runs the per-item Straus
  kernel (A1, `verify_batch`) and answers with its strict verdict;
  `mode="msm"` (the default) runs one random-linear-combination check per
  bucket of at least `msm_min_bucket` rows through the window-lane kernel
  (A2, `msm_accumulate`) plus the host Horner epilogue, falls back to A1
  for a failed bucket, and answers every verdict with the cofactored rule;
- the group lane for compact certificates (`submit_groups` /
  `collect_groups`): many half-aggregated proofs checked by one A2 launch
  under per-group random outer weights, a failed chunk bisected by solo
  launches, and only groups that still fail re-checked on the host;
- mesh sharding (`--verify-shards k`): `GpuVerifier(mesh=data_mesh(k))`
  splits every bucket into k contiguous shards, one per device, and runs
  the staged kernels on each (`_sharded_kernels`: A3 `verify_decompress`,
  A4 `verify_straus`, A5 `verify_verdict`, A6 `msm_window`), the window
  lanes of the shards summed on the first device by `msm_shard_reduce`.

`submit` / `submit_groups` launch the kernels and start the results' copy to
pinned host memory (`HostCopy`: a non-blocking copy plus a CUDA event), so
several submitted buckets stay in flight and `collect` only waits on the
event.

`GpuVerifier(mode=None)` reads NARWHAL_TPU_VERIFY_MODE (default "msm"), as
the reference does; unlike the reference, which runs item mode for any value
but "msm", a value other than "msm" or "item" raises ConfigError, so a
misspelt variable cannot boot a node on another verdict rule.

`AsyncVerifierPool` is the host pool behind `--crypto-backend pool` (and
behind `cpu` under compact certificates), a copy of the reference's.

No fallback from the card to the host, where the reference has three:
`VerifyService` fails every waiter of a failed submit or collect (the
reference host-verifies a failed item-mode collect, `_finish_failed`);
`make_batch_verifier` raises where the reference returns None, lets a
failed launch's error through, and refuses `fallback_on_error=True` with a
ConfigError; `data_mesh` raises where the reference falls back to virtual
CPU devices.
"""

from __future__ import annotations

import asyncio
import atexit
import collections
import contextlib
import hashlib
import logging
import os
import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..config import ConfigError
from ..crypto import BatchItem
from . import HostCopy, ed25519, named_device as _named
from . import ed25519_ref as ref

logger = logging.getLogger("narwhal.gpu.verifier")

_MIN_BUCKET = 16
_MAX_BUCKET = 8192
_MODES = ("msm", "item")
MODE_ENV = "NARWHAL_TPU_VERIFY_MODE"


def _scalar_lib():
    """The native host scalar pipeline, or None (the Python twins)."""
    from ..native import load_scalar

    return load_scalar()


def verify_mode(mode: str | None = None) -> str:
    """The verify mode: `mode` when given, else NARWHAL_TPU_VERIFY_MODE,
    default "msm". Anything but "msm" or "item" raises ConfigError."""
    if mode is None:
        value = os.environ.get(MODE_ENV, "msm")
        if value not in _MODES:
            raise ConfigError(f"{MODE_ENV}={value!r} is not a verify mode (one of {_MODES})")
        return value
    if mode not in _MODES:
        raise ConfigError(f"verify mode must be one of {_MODES}, got {mode!r}")
    return mode


# The base term of the epilogue rides its Horner walk: [sum_s]B is added a
# 4-bit digit a window from these 16 small multiples of B (extended
# coordinates), in place of a separate double-and-add walk; and a lane
# set's limbs become integers in one weighted sum over an object array.
_BASE_MULTIPLES = tuple(ref.point_mul(d, ref.G) for d in range(16))
_LIMB_WEIGHTS = np.array(
    [1 << (ed25519.RADIX * i) for i in range(ed25519.NLIMB)], dtype=object
)


def _lane_ints(v) -> np.ndarray:
    """[4, lanes] integers (mod p) of a lane set's X/Y/Z/T limbs."""
    arr = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v).astype(object)
    return (arr * _LIMB_WEIGHTS[None, :, None]).sum(axis=1) % ref.P


def msm_epilogue_check(va_limbs, vr_limbs, sum_s: int) -> bool:
    """Host half of the batch check: Horner-collapse the device's
    per-window point sums and test
    [8]([sum z_iS_i]B + sum_w 16^(63-w) (V_a[w] + V_r[w-32])) == identity.

    va_limbs: int32[4, NLIMB, 64] and vr_limbs: int32[4, NLIMB, 32] X/Y/Z/T
    limbs from `msm_accumulate` (loose from the plain version, canonical
    from the kernel; MSB-first window lanes; the R accumulator covers only
    the low 32 windows because z_i < 2^128). The base term's 4-bit digits
    join the same walk, a table add a window (`_BASE_MULTIPLES`): ~420
    bigint point ops, amortized over the whole batch.

    COFACTORED (the [8]): torsion components of adversarial A/R cancel
    deterministically, so acceptance never depends on the random z_i (a
    cofactorless batch would accept a torsion-defect signature with
    probability 1/8 over z, and two honest verifiers of the same bytes
    could disagree). In msm mode every per-item verdict (small buckets,
    fallback) therefore uses the kernel's cofactored output too."""
    Wa = va_limbs.shape[2]
    off = Wa - vr_limbs.shape[2]
    va, vr = _lane_ints(va_limbs), _lane_ints(vr_limbs)
    s = sum_s % ref.L
    # Base digits above the walk's windows (none for 64 windows: s < 2^253)
    # start the accumulator, which the walk's doublings then scale.
    high = s >> (4 * Wa)
    acc = ref.point_mul(high, ref.G) if high else (0, 1, 1, 0)
    for w in range(Wa):
        for _ in range(4):
            acc = ref.point_double(acc)
        acc = ref.point_add(acc, tuple(va[:, w]))
        if w >= off:
            acc = ref.point_add(acc, tuple(vr[:, w - off]))
        d = (s >> (4 * (Wa - 1 - w))) & 15
        if d:
            acc = ref.point_add(acc, _BASE_MULTIPLES[d])
    for _ in range(3):  # cofactor 8
        acc = ref.point_double(acc)
    # Identity <=> X == 0 and Y == Z (mod p).
    return acc[0] % ref.P == 0 and (acc[1] - acc[2]) % ref.P == 0


class DataMesh:
    """The verify-sharding mesh: one 'data' axis over `devices` (a tuple of
    torch.device, one shard each; a device may repeat). The counterpart of
    the JAX package's 1-axis `Mesh`, with the same `.shape` mapping."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        self.shape = {"data": len(self.devices)}


def data_mesh(shards: int, devices=None) -> DataMesh:
    """The verify-sharding mesh of `shards` devices (--verify-shards).

    `devices` pins an explicit list; an entry may name one device more than
    once (the tests pass ["cpu"] * k, as the JAX tests pin virtual CPU
    devices; a single card can run [cuda:0, cuda:0]). By default the first
    `shards` cards. Too few devices raise ConfigError: unlike the JAX
    package, which falls back to virtual CPU devices with a warning, the
    port never moves a sharded verifier off the card unasked."""
    if shards < 1:
        raise ConfigError(f"--verify-shards {shards} must be at least 1")
    if devices is not None:
        devs = [_named(d) for d in devices]
        if len(devs) < shards:
            raise ConfigError(
                f"--verify-shards {shards} exceeds the {len(devs)} pinned devices"
            )
    else:
        count = torch.cuda.device_count()
        if count < shards:
            raise ConfigError(
                f"--verify-shards {shards} exceeds available devices ({count} cuda)"
            )
        devs = [torch.device("cuda", i) for i in range(shards)]
    return DataMesh(devs[:shards])


def _sharded_kernels(mesh: DataMesh):
    """The mesh-sharded verify pipeline: the STAGED kernels on every shard.

    A bucket's host arrays split into k equal contiguous shards, each
    uploaded to its device and run there (every launch under that device's
    guard, on its current stream; launches are asynchronous, so the shards
    of different cards run together):
    - item_fn: A3 on the A set and on the R set, A4, A5; the verdicts of the
      shards concatenated on the first device in shard order;
    - msm_fn: A3 twice, A6 over the A set's 64 lanes and the R set's 32; the
      shards' lane sets brought to the first device (a no-op for a shard
      already there) and both sets summed there by one `msm_shard_reduce`
      (the reduce XLA inserts on the JAX mesh), and valid = a_valid &
      r_valid per row.
    The per-lane arithmetic is A1's and A2's, so verdicts are bit-equal to
    the monoliths', and V is the same sum (as points: the shards' chains
    group the rows differently). Cross-device copies order themselves after
    the work on both devices, so the first device's stream, and the
    HostCopy event recorded on it, follows every shard.

    Returns (item_fn, msm_fn), each taking the six host arrays of the
    monolith's signature and returning its device outputs."""
    devices = mesh.devices
    first = devices[0]

    def guard(dev):
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def upload(arrays, i, dev):
        """Shard i of the six host arrays, on its device."""
        n = arrays[0].shape[0] // len(devices)
        return [torch.from_numpy(np.ascontiguousarray(a[i * n:(i + 1) * n])).to(dev)
                for a in arrays]

    def gather(parts):
        return torch.cat([t.to(first) for t in parts])

    def item_fn(arrays):
        strict, cof = [], []
        for i, dev in enumerate(devices):
            with guard(dev):
                a_y, a_sign, r_y, r_sign, k_digits, s_digits = upload(arrays, i, dev)
                a_pt, a_valid = ed25519.verify_decompress(a_y, a_sign)
                r_pt, r_valid = ed25519.verify_decompress(r_y, r_sign)
                acc = ed25519.verify_straus(a_pt, k_digits, s_digits)
                s, c = ed25519.verify_verdict(acc, r_pt, r_y, r_sign, a_valid, r_valid)
            strict.append(s)
            cof.append(c)
        return gather(strict), gather(cof)

    def msm_fn(arrays):
        v_a, v_r, valid = [], [], []
        for i, dev in enumerate(devices):
            with guard(dev):
                a_y, a_sign, r_y, r_sign, ak_digits, z_digits = upload(arrays, i, dev)
                a_pt, a_valid = ed25519.verify_decompress(a_y, a_sign)
                r_pt, r_valid = ed25519.verify_decompress(r_y, r_sign)
                v_a.append(ed25519.msm_window(a_pt, ak_digits))
                v_r.append(ed25519.msm_window(r_pt, z_digits))
                valid.append(a_valid & r_valid)
        sum_a, sum_r = ed25519.msm_shard_reduce([v.to(first) for v in v_a],
                                                [v.to(first) for v in v_r])
        return sum_a, sum_r, gather(valid)

    return item_fn, msm_fn


class GpuVerifier:
    """Synchronous batch verifier backed by the CUDA kernels (or, with
    `device="cpu"`, by their plain PyTorch versions).

    mode=None reads NARWHAL_TPU_VERIFY_MODE (default "msm"; `verify_mode`).
    mode="msm": one random-linear-combination check per bucket of
    at least `msm_min_bucket` rows — [sum z_iS_i]B - sum[z_ik_i]A_i -
    sum[z_i]R_i == 0 with fresh 128-bit z_i — through A2 and the host
    epilogue; a failed bucket falls back to A1 to locate offenders. Every
    msm-mode verdict (the batch check, small buckets, the fallback) is the
    cofactored rule. mode="item": always A1, strict verdict.

    mesh (a `data_mesh`): every bucket is sharded over the mesh's data axis
    and runs the staged kernels A3-A6 (`_sharded_kernels`) in place of A1
    and A2, with the same verdicts. Every bucket this verifier can pad to
    must split evenly, or construction raises ConfigError."""

    def __init__(
        self,
        max_bucket: int = _MAX_BUCKET,
        mode: str | None = None,
        msm_min_bucket: int = 512,
        fixed_bucket: bool = False,
        device=None,
        mesh: DataMesh | None = None,
        data_axis: str = "data",
    ):
        self.mode = verify_mode(mode)
        self.max_bucket = max_bucket
        self.msm_min_bucket = msm_min_bucket
        self.fixed_bucket = fixed_bucket
        self.mesh = mesh
        if mesh is None:
            self.device = _named(device)
            self._item_fn = lambda arrays: ed25519.verify_batch(*self._upload(arrays))
            self._msm_fn = lambda arrays: ed25519.msm_accumulate(*self._upload(arrays))
            return
        if device is not None:
            raise ValueError("GpuVerifier: pass a device or a mesh, not both")
        # Fail at construction, as the JAX verifier does: every bucket is a
        # power of two in [_MIN_BUCKET, max_bucket] (or max_bucket itself
        # with fixed_bucket), and the data axis must divide each.
        if data_axis not in mesh.shape:
            raise ConfigError(
                f"verifier mesh has no {data_axis!r} axis (axes: {tuple(mesh.shape)})"
            )
        data_size = mesh.shape[data_axis]
        smallest = self.max_bucket if self.fixed_bucket else _MIN_BUCKET
        if smallest % data_size != 0 or self.max_bucket % data_size != 0:
            raise ConfigError(
                f"verify shard count {data_size} must divide every dispatch bucket "
                f"(smallest {smallest}, largest {self.max_bucket}); use a power of "
                f"two <= {smallest}"
            )
        self.device = mesh.devices[0]
        self._item_fn, self._msm_fn = _sharded_kernels(mesh)

    def _precheck(self, items: Sequence[BatchItem]):
        """Canonicality checks + challenge scalars: returns (precheck[n]
        bool, a_raw, r_raw, s_raw, k_raw as uint8[n, 32]), in the native
        library when it loads."""
        lib = _scalar_lib()
        if lib is not None:
            return self._precheck_native(items, lib)
        return self._precheck_py(items)

    def _precheck_native(self, items: Sequence[BatchItem], lib):
        """`_precheck` in C (GIL released for the call)."""
        n = len(items)
        lenok = np.ones(n, bool)
        pk_parts: list[bytes] = []
        sig_parts: list[bytes] = []
        msg_parts: list[bytes] = []
        lens = np.empty(n, np.int64)
        zero32, zero64 = b"\0" * 32, b"\0" * 64
        for i, (pk, msg, sig) in enumerate(items):
            if len(pk) != 32 or len(sig) != 64:
                lenok[i] = False
                pk_parts.append(zero32)
                sig_parts.append(zero64)
                lens[i] = 0
                continue
            pk_parts.append(pk)
            sig_parts.append(sig)
            msg_parts.append(msg)
            lens[i] = len(msg)
        pk_buf = b"".join(pk_parts)
        sig_buf = b"".join(sig_parts)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        k_raw = np.empty((n, 32), np.uint8)
        ok_raw = np.empty(n, np.uint8)
        rc = lib.ed25519_precheck_k(
            n, pk_buf, sig_buf, b"".join(msg_parts), offs.ctypes.data,
            k_raw.ctypes.data, ok_raw.ctypes.data,
        )
        if rc != 0:
            raise RuntimeError(f"ed25519_precheck_k failed: rc={rc}")
        precheck = ok_raw.astype(bool) & lenok
        sig_rows = np.frombuffer(sig_buf, np.uint8).reshape(n, 64)
        a_raw = np.frombuffer(pk_buf, np.uint8).reshape(n, 32)
        return precheck, a_raw, sig_rows[:, :32], sig_rows[:, 32:], k_raw

    def _precheck_py(self, items: Sequence[BatchItem]):
        """Python twin of `_precheck_native`: bit-identical verdicts, and
        bit-identical rows for the items that pass (the rows of a failing
        item are zero here, its own bytes there; neither is packed)."""
        n = len(items)
        precheck = np.zeros(n, bool)
        a_raw = np.zeros((n, 32), np.uint8)
        r_raw = np.zeros((n, 32), np.uint8)
        s_raw = np.zeros((n, 32), np.uint8)
        k_raw = np.zeros((n, 32), np.uint8)
        L = ref.L
        P = ref.P
        sha512 = hashlib.sha512
        top_mask = (1 << 255) - 1
        frombuf = np.frombuffer
        for i, (pk, msg, sig) in enumerate(items):
            if len(pk) != 32 or len(sig) != 64:
                continue
            rs, sb = sig[:32], sig[32:]
            if int.from_bytes(sb, "little") >= L:
                continue
            if (int.from_bytes(pk, "little") & top_mask) >= P:
                continue
            if (int.from_bytes(rs, "little") & top_mask) >= P:
                continue
            k_int = int.from_bytes(sha512(rs + pk + msg).digest(), "little") % L
            a_raw[i] = frombuf(pk, np.uint8)
            r_raw[i] = frombuf(rs, np.uint8)
            s_raw[i] = frombuf(sb, np.uint8)
            k_raw[i] = frombuf(k_int.to_bytes(32, "little"), np.uint8)
            precheck[i] = True
        return precheck, a_raw, r_raw, s_raw, k_raw

    def pack(self, items: Sequence[BatchItem]):
        """Precheck + pack: (precheck-passing indices, packed rows) where the
        rows are (a_y i16 [m, 20], a_sign i8 [m], r_y i16, r_sign i8,
        k_raw u8 [m, 32], s_raw u8 [m, 32]) for the m passing items."""
        precheck, a_all, r_all, s_all, k_all = self._precheck(items)
        idx = np.flatnonzero(precheck)
        a_raw = np.ascontiguousarray(a_all[idx])
        r_raw = np.ascontiguousarray(r_all[idx])
        a_y = ed25519.bytes_to_limbs(a_raw).astype(np.int16)
        r_y = ed25519.bytes_to_limbs(r_raw).astype(np.int16)
        a_sign = (a_raw[:, 31] >> 7).astype(np.int8)
        r_sign = (r_raw[:, 31] >> 7).astype(np.int8)
        packed = (
            a_y, a_sign, r_y, r_sign,
            np.ascontiguousarray(k_all[idx]), np.ascontiguousarray(s_all[idx]),
        )
        return idx, packed

    def bucket(self, n: int) -> int:
        if self.fixed_bucket:
            return self.max_bucket
        bucket = _MIN_BUCKET
        while bucket < n:
            bucket *= 2
        return bucket

    @staticmethod
    def bucket_arrays(packed, lo: int, hi: int, pad: int) -> list[np.ndarray]:
        """The item kernel's six host arrays for rows [lo, hi) padded by
        `pad` repeats of row lo (the reference's padding), in the kernel's
        dtypes: limbs i16 [B, 20], signs i8 [B], digits i8 [B, 64]."""
        a_y, a_sign, r_y, r_sign, k_raw, s_raw = packed

        def pad_to(arr):
            if pad == 0:
                return np.ascontiguousarray(arr[lo:hi])
            return np.concatenate([arr[lo:hi], np.repeat(arr[lo : lo + 1], pad, axis=0)])

        k_digits = ed25519.bytes_to_digits(pad_to(k_raw)).astype(np.int8)
        s_digits = ed25519.bytes_to_digits(pad_to(s_raw)).astype(np.int8)
        return [
            pad_to(a_y), pad_to(a_sign), pad_to(r_y), pad_to(r_sign),
            np.ascontiguousarray(k_digits), np.ascontiguousarray(s_digits),
        ]

    def _upload(self, arrays) -> list[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]

    def _dispatch_items(self, packed, lo, hi, pad) -> HostCopy:
        """A1 (or, on a mesh, A3-A5 on every shard) over one padded bucket:
        upload, launch, start the verdicts' copy. The copy's result is
        (strict, cofactored)."""
        return HostCopy(*self._item_fn(self.bucket_arrays(packed, lo, hi, pad)))

    def _launch_msm(self, arrays) -> HostCopy:
        """A2 (or, on a mesh, A3 and A6 on every shard and the shard reduce)
        over six host arrays: upload, launch, start the copy of (V_a, V_r,
        valid)."""
        return HostCopy(*self._msm_fn(arrays))

    @staticmethod
    def _fold_native(lib, k_rows: np.ndarray, s_rows: np.ndarray, rnd: bytes):
        """ak_i = z_i*k_i mod L and sum(z_i*s_i) mod L in C, z_i the
        16-byte little-endian words of `rnd`; rows contiguous uint8[m, 32]."""
        m = k_rows.shape[0]
        ak_raw = np.empty((m, 32), np.uint8)
        sum_raw = np.empty(32, np.uint8)
        lib.scalar_fold(m, k_rows.ctypes.data, s_rows.ctypes.data, rnd,
                        ak_raw.ctypes.data, sum_raw.ctypes.data)
        return ak_raw, int.from_bytes(sum_raw.tobytes(), "little")

    @staticmethod
    def _fold_py(k_rows: np.ndarray, s_rows: np.ndarray, rnd: bytes):
        """Python twin of `_fold_native` (identical outputs)."""
        L = ref.L
        m = k_rows.shape[0]
        from_bytes = int.from_bytes
        kb, sb = k_rows.tobytes(), s_rows.tobytes()
        ak_parts: list[bytes] = []
        sum_s = 0
        for t in range(m):
            z = from_bytes(rnd[16 * t : 16 * (t + 1)], "little")
            k = from_bytes(kb[32 * t : 32 * (t + 1)], "little")
            s = from_bytes(sb[32 * t : 32 * (t + 1)], "little")
            ak_parts.append(((z * k) % L).to_bytes(32, "little"))
            sum_s += z * s
        ak_raw = np.frombuffer(b"".join(ak_parts), np.uint8).reshape(m, 32)
        return ak_raw, sum_s % L

    def _dispatch_msm(self, packed, lo, hi, pad):
        """Random-linear-combination check over one bucket. Fresh 128-bit
        z_i per item per call (os.urandom: the adversary must not predict
        them; verdicts don't depend on the draw, since a failed check falls
        back to A1); zero rows are inert padding. Returns (HostCopy of
        (V_a, V_r, valid), sum_s): the epilogue runs at collect time."""
        a_y, a_sign, r_y, r_sign, k_raw, s_raw = packed
        m = hi - lo
        rnd = os.urandom(16 * m)  # lint: allow(raw-entropy)
        k_rows = np.ascontiguousarray(k_raw[lo:hi])
        s_rows = np.ascontiguousarray(s_raw[lo:hi])
        lib = _scalar_lib()
        if lib is not None:
            ak_raw, sum_s = self._fold_native(lib, k_rows, s_rows, rnd)
        else:
            ak_raw, sum_s = self._fold_py(k_rows, s_rows, rnd)
        if pad:
            ak_raw = np.concatenate([ak_raw, np.zeros((pad, 32), np.uint8)])
        z_raw = np.zeros((m + pad, 32), np.uint8)
        z_raw[:m, :16] = np.frombuffer(rnd, np.uint8).reshape(m, 16)
        ak_digits = ed25519.bytes_to_digits(ak_raw).astype(np.int8)
        # z < 2^128: the MSB-first digit vector's low half carries it.
        z_digits = ed25519.bytes_to_digits(z_raw)[:, 32:].astype(np.int8)

        def zpad(arr):
            if pad == 0:
                return arr[lo:hi]
            return np.concatenate([arr[lo:hi], np.zeros((pad,) + arr.shape[1:], arr.dtype)])

        arrays = [zpad(a_y), zpad(a_sign), zpad(r_y), zpad(r_sign), ak_digits, z_digits]
        return (self._launch_msm(arrays), sum_s)

    def submit(self, items: Sequence[BatchItem]):
        """Pack + precheck on host and enqueue the launches. Returns an
        opaque handle for `collect`; the launches are asynchronous, so
        several submitted batches stay in flight."""
        n = len(items)
        if n == 0:
            return (np.zeros(0, bool), np.zeros(0, np.int64), [], None, items)
        ok = np.zeros(n, bool)
        idx, packed = self.pack(items)
        outs = []  # (kind, lo, hi, pad, out)
        for lo in range(0, idx.size, self.max_bucket):
            hi = min(lo + self.max_bucket, idx.size)
            bucket = self.bucket(hi - lo)
            pad = bucket - (hi - lo)
            if self.mode == "msm" and bucket >= self.msm_min_bucket:
                outs.append(("msm", lo, hi, pad, self._dispatch_msm(packed, lo, hi, pad)))
            else:
                outs.append(("item", lo, hi, pad, self._dispatch_items(packed, lo, hi, pad)))
        return (ok, idx, outs, packed, items)

    def collect(self, handle) -> list[bool]:
        """Materialize a `submit` handle's verdicts (blocks on the copies).
        A failed msm bucket re-launches A1 to locate the offending
        signatures. In msm mode every verdict is the cofactored one, so no
        signature's fate depends on flush size or bucket composition;
        mode="item" keeps the strict (host-library) rule."""
        ok, idx, outs, packed, _items = handle
        if idx.size:
            results = np.zeros(idx.size, bool)
            pick = 1 if self.mode == "msm" else 0
            for kind, lo, hi, pad, out in outs:
                if kind == "item":
                    results[lo:hi] = out.result()[pick][: hi - lo]
                    continue
                copy, sum_s = out
                va, vr, valid = copy.result()
                if bool(valid.all()) and msm_epilogue_check(va, vr, sum_s):
                    results[lo:hi] = True
                else:
                    fallback = self._dispatch_items(packed, lo, hi, pad)
                    results[lo:hi] = fallback.result()[1][: hi - lo]
            ok[idx] = results
        return ok.tolist()

    @staticmethod
    def wait(handle) -> None:
        """Block until the device-to-host copies of a `submit` or
        `submit_groups` handle have landed. `collect` / `collect_groups`
        then spend host time only: verdict routing, the msm epilogue, and a
        failed bucket's re-launches."""
        for out in handle[2]:
            copy = out[-1][0] if isinstance(out[-1], tuple) else out[-1]
            if copy is not None:
                copy.wait()

    def __call__(self, items: Sequence[BatchItem]) -> list[bool]:
        return self.collect(self.submit(items))

    # -- the group lane: compact-certificate proofs -------------------------

    def submit_groups(self, groups):
        """Launch half-aggregated certificate proofs (types.Certificate
        compact form). Each group is (items [(pk, msg, R)], zs, s_agg): the
        claim sum(z_i s_i) = s_agg over the equations [s_i]B = R_i +
        [k_i]A_i. One A2 launch checks the OUTER random combination over
        all groups of a chunk — a fresh 128-bit w_g per group, so
        adversarially related groups cannot cancel each other:
          [sum_g w_g s_agg_g]B == sum_g w_g (sum_i z_i R_i + [z_i k_i]A_i)
        Each signer contributes two kernel rows (A_i with scalar w z k, and
        R_i — fed through the A slot — with scalar w z; the R slot's
        128-bit scalar lane is too narrow for the 256-bit products). The
        zero R-slot rows are inert. Returns a handle for `collect_groups`."""
        n_groups = len(groups)
        ok = np.zeros(n_groups, bool)
        candidates = []  # (group index, items, zs, s_agg, w)
        for g, (items, zs, s_agg) in enumerate(groups):
            if items and 2 * len(items) <= self.max_bucket:
                # Adversarial RLC weight: same argument as _dispatch_msm.
                w = int.from_bytes(os.urandom(16), "little")  # lint: allow(raw-entropy)
                candidates.append((g, items, zs, s_agg, w))
            # oversized/empty groups are host-verified at collect
        outs = []
        lo = 0
        while lo < len(candidates):
            # Greedy-pack whole groups into one bucket (a group must not
            # straddle launches: the epilogue identity is per launch).
            hi, rows = lo, 0
            while hi < len(candidates) and rows + 2 * len(candidates[hi][1]) <= self.max_bucket:
                rows += 2 * len(candidates[hi][1])
                hi += 1
            chunk = candidates[lo:hi]
            lo = hi
            outs.append((chunk, self._dispatch_group_chunk(chunk, rows)))
        return (ok, candidates, outs, groups)

    def _dispatch_group_chunk(self, chunk, rows):
        """One A2 launch over the doubled rows of `chunk`'s groups. Returns
        (HostCopy, sum_s) like _dispatch_msm, or None when an item fails
        the canonicality prechecks (the chunk then fails at collect)."""
        L = ref.L
        sum_s = 0
        flat_items = []
        for _, items, _zs, _s_agg, _w in chunk:
            flat_items.extend(items)
        m = len(flat_items)
        # k_i = H(R||A||m) + canonicality through the item precheck: the
        # fake 64-byte signature is R || 0, so the s-range check passes.
        fake = [(pk, msg, r + b"\0" * 32) for pk, msg, r in flat_items]
        precheck, a_all, r_all, _s, k_all = self._precheck(fake)
        if not bool(precheck.all()):
            return None

        # Effective scalars y_i = w_g * z_i and ak_i = y_i * k_i (mod L).
        w_rows = np.empty((m, 32), np.uint8)
        z_rows = np.empty((m, 32), np.uint8)
        t = 0
        for _, _items, zs, s_agg, w in chunk:
            sum_s = (sum_s + w * s_agg) % L
            wb = np.frombuffer(w.to_bytes(32, "little"), np.uint8)
            for z in zs:
                w_rows[t] = wb
                z_rows[t] = np.frombuffer(z.to_bytes(32, "little"), np.uint8)
                t += 1
        k_rows = np.ascontiguousarray(k_all[:m])
        lib = _scalar_lib()
        if lib is not None:
            y_rows = self._mulmod_native(lib, w_rows, z_rows)
            ak_items = self._mulmod_native(lib, y_rows, k_rows)
        else:
            y_rows = self._mulmod_py(w_rows, z_rows)
            ak_items = self._mulmod_py(y_rows, k_rows)

        # Doubled rows: even = A_i with scalar ak_i, odd = R_i (through the
        # A slot) with scalar y_i.
        a_rows = np.zeros((rows, 32), np.uint8)
        ak_rows = np.zeros((rows, 32), np.uint8)
        a_rows[0::2] = a_all[:m]
        a_rows[1::2] = r_all[:m]
        ak_rows[0::2] = ak_items
        ak_rows[1::2] = y_rows
        bucket = self.bucket(rows)
        pad = bucket - rows
        if pad:
            a_rows = np.concatenate([a_rows, np.zeros((pad, 32), np.uint8)])
            ak_rows = np.concatenate([ak_rows, np.zeros((pad, 32), np.uint8)])
        a_y = ed25519.bytes_to_limbs(a_rows).astype(np.int16)
        a_sign = (a_rows[:, 31] >> 7).astype(np.int8)
        arrays = [
            a_y, a_sign, np.zeros_like(a_y), np.zeros_like(a_sign),
            ed25519.bytes_to_digits(ak_rows).astype(np.int8),
            np.zeros((bucket, 32), np.int8),
        ]
        return (self._launch_msm(arrays), sum_s)

    @staticmethod
    def _mulmod_native(lib, a_rows: np.ndarray, b_rows: np.ndarray) -> np.ndarray:
        """Row-wise a_i * b_i mod L in C over contiguous uint8[m, 32]
        little-endian rows."""
        out = np.empty(a_rows.shape, np.uint8)
        lib.scalar_mulmod(a_rows.shape[0], a_rows.ctypes.data, b_rows.ctypes.data,
                          out.ctypes.data)
        return out

    @staticmethod
    def _mulmod_py(a_rows: np.ndarray, b_rows: np.ndarray) -> np.ndarray:
        """Python twin of `_mulmod_native` (identical outputs)."""
        L = ref.L
        out = np.empty(a_rows.shape, np.uint8)
        for i in range(a_rows.shape[0]):
            a = int.from_bytes(a_rows[i].tobytes(), "little")
            b = int.from_bytes(b_rows[i].tobytes(), "little")
            out[i] = np.frombuffer(((a * b) % L).to_bytes(32, "little"), np.uint8)
        return out

    def _chunk_passes(self, dispatched) -> bool:
        """Force one `_dispatch_group_chunk` result: device validity lanes
        plus the host epilogue identity."""
        if dispatched is None:
            return False
        copy, sum_s = dispatched
        va, vr, valid = copy.result()
        return bool(valid.all()) and msm_epilogue_check(va, vr, sum_s)

    def collect_groups(self, handle) -> list[bool]:
        """Resolve a `submit_groups` handle. A failed combined check
        RE-LAUNCHES each group of the chunk as its own A2 chunk (all solos
        in flight before the first readback); only groups whose solo check
        still fails reach the pure-Python host verifier. One adversarial
        compact certificate therefore costs its own group a host walk and
        cannot drag every honest group of the chunk onto the host.
        Oversized groups (2 rows per signer > max_bucket) host-verify."""
        from ..types import host_verify_aggregate

        ok, candidates, outs, groups = handle
        for chunk, dispatched in outs:
            if self._chunk_passes(dispatched):
                for g, *_ in chunk:
                    ok[g] = True
                continue
            if len(chunk) > 1:
                logger.warning(
                    "aggregate chunk of %d certificate groups failed the combined "
                    "check; re-launching each group solo", len(chunk),
                )
                solos = [
                    (entry, self._dispatch_group_chunk([entry], 2 * len(entry[1])))
                    for entry in chunk
                ]
            else:
                solos = [(chunk[0], dispatched)]
            for (g, items, zs, s_agg, _), disp in solos:
                if len(chunk) > 1 and self._chunk_passes(disp):
                    ok[g] = True
                else:
                    # The group's own device check failed: almost surely
                    # invalid, but the host verdict is authoritative.
                    ok[g] = host_verify_aggregate(items, zs, s_agg)
        dispatched_gs = {g for g, *_ in candidates}
        for g, (items, zs, s_agg) in enumerate(groups):
            if g not in dispatched_gs:
                ok[g] = host_verify_aggregate(items, zs, s_agg) if items else False
        return ok.tolist()


class VerifyService:
    """Process-wide pipelined verification front for the card.

    ONE instance per process (and mode) merges every caller's items into
    large buckets and keeps several batches in flight, so all protocol hops
    of all co-hosted nodes share launches.

    Thread model (asyncio-loop agnostic: callers on different loops can
    share it):
      callers       append (item, loop, future) under a lock;
      submit thread seals a merged batch (size- or deadline-triggered) and
                    runs GpuVerifier.submit / submit_groups (host packing,
                    upload, launch);
      collect thread blocks on the copies' events and resolves futures via
                    loop.call_soon_threadsafe.
    A bounded in-flight queue applies backpressure when the card falls
    behind. A failed submit or collect resolves its futures with the
    exception: there is no host fallback here (one would quietly replace a
    kernel that failed with the CPU)."""

    _shared: dict[str, "VerifyService"] = {}

    def __init__(
        self,
        verifier: GpuVerifier,
        max_batch: int = 4096,
        max_delay: float = 0.003,
        inflight: int = 3,
    ):
        self.verifier = verifier
        self.max_batch = max_batch
        self.max_delay = max_delay
        self._pending: collections.deque = collections.deque()
        # Aggregate-certificate groups (compact certificates) ride a second
        # lane through submit_groups, on the same threads and pipeline.
        self._pending_groups: collections.deque = collections.deque()
        self.max_group_rows = max_batch  # 2 rows per signer, same bucket
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._inflight: queue.Queue = queue.Queue(maxsize=inflight)
        self._closed = False
        self._submit_thread = threading.Thread(
            target=self._submit_loop, daemon=True, name="verify-submit"
        )
        self._collect_thread = threading.Thread(
            target=self._collect_loop, daemon=True, name="verify-collect"
        )
        self._submit_thread.start()
        self._collect_thread.start()
        # A daemon thread inside a CUDA call during interpreter teardown
        # aborts the process: stop the loops and join before Python exits.
        atexit.register(self.shutdown)

    @classmethod
    def shared(cls, mode: str, shards: int = 1, device=None, devices=None) -> "VerifyService":
        """The process-wide instance for an accept-set mode ('item'/'msm'),
        shard count and (unsharded) device: every in-process node of a
        committee shares it. Raises if the device verifier cannot be built. The
        verifier runs fixed-bucket (every flush pads to 2048 rows), with the
        msm lane from 16 rows up. `shards > 1` (--verify-shards) shards
        every flush over `data_mesh(shards, devices)` (`device` is then
        unused); a mesh that cannot split the bucket raises ConfigError
        here, not at the first verify."""
        key = f"{mode}:{shards}" if shards > 1 else f"{mode}:1:{_named(device)}"
        svc = cls._shared.get(key)
        if svc is None:
            mesh = data_mesh(shards, devices) if shards > 1 else None
            svc = cls(
                GpuVerifier(
                    max_bucket=2048, msm_min_bucket=16, mode=mode, fixed_bucket=True,
                    device=None if mesh else device, mesh=mesh,
                ),
                max_batch=2048,
            )
            cls._shared[key] = svc
        return svc

    async def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        with self._wake:
            if self._closed:
                raise RuntimeError("verify service shut down")
            self._pending.append(((public_key, message, signature), loop, fut, time.monotonic()))
            self._wake.notify()
        return await fut

    async def verify_aggregate(self, items, zs, s_agg: int) -> bool:
        """Half-aggregated certificate proof (compact certificates): queued
        on the group lane; many groups fuse into one A2 launch under an
        outer random combination."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        with self._wake:
            if self._closed:
                raise RuntimeError("verify service shut down")
            self._pending_groups.append(((items, zs, s_agg), loop, fut, time.monotonic()))
            self._wake.notify()
        return await fut

    def _seal(self) -> list | None:
        """Under the lock: a singles batch worth dispatching, or None."""
        if not self._pending:
            return None
        n = len(self._pending)
        if n >= self.max_batch or time.monotonic() - self._pending[0][3] >= self.max_delay:
            take = min(n, self.max_batch)
            return [self._pending.popleft() for _ in range(take)]
        return None

    def _seal_groups(self) -> list | None:
        """Under the lock: a groups batch (by total doubled-row budget)."""
        if not self._pending_groups:
            return None
        rows = sum(2 * len(g[0][0]) for g in self._pending_groups)
        if rows >= self.max_group_rows or (
            time.monotonic() - self._pending_groups[0][3] >= self.max_delay
        ):
            out, budget = [], self.max_group_rows
            while self._pending_groups:
                need = 2 * len(self._pending_groups[0][0][0])
                if out and need > budget:
                    break
                out.append(self._pending_groups.popleft())
                budget -= need
            return out
        return None

    def _oldest_age(self) -> float | None:
        ages = []
        if self._pending:
            ages.append(time.monotonic() - self._pending[0][3])
        if self._pending_groups:
            ages.append(time.monotonic() - self._pending_groups[0][3])
        return max(ages) if ages else None

    def _submit_loop(self) -> None:
        while True:
            with self._wake:
                batch = self._seal()
                gbatch = self._seal_groups()
                while batch is None and gbatch is None and not self._closed:
                    # Wake early enough to honor the oldest item's deadline.
                    age = self._oldest_age()
                    timeout = None if age is None else max(0.0, self.max_delay - age) + 1e-4
                    self._wake.wait(timeout=timeout)
                    batch = self._seal()
                    gbatch = self._seal_groups()
                if batch is None and gbatch is None and self._closed:
                    # Drain: anything still queued will never dispatch.
                    leftovers = list(self._pending) + list(self._pending_groups)
                    self._pending.clear()
                    self._pending_groups.clear()
                    if leftovers:
                        self._resolve_error(leftovers, RuntimeError("verify service shut down"))
                    self._inflight.put(None)  # collector shutdown
                    return
            if batch is not None:
                try:
                    handle = self.verifier.submit([e[0] for e in batch])
                except Exception as e:
                    logger.exception("verify submit failed for %d items", len(batch))
                    self._resolve_error(batch, e)
                else:
                    self._inflight.put(("s", handle, batch))
            if gbatch is not None:
                try:
                    ghandle = self.verifier.submit_groups([e[0] for e in gbatch])
                except Exception as e:
                    logger.exception("aggregate submit failed for %d groups", len(gbatch))
                    self._resolve_error(gbatch, e)
                else:
                    self._inflight.put(("g", ghandle, gbatch))

    def _collect_loop(self) -> None:
        while True:
            got = self._inflight.get()
            if got is None:
                return
            kind, handle, entries = got
            try:
                if kind == "g":
                    results = self.verifier.collect_groups(handle)
                else:
                    results = self.verifier.collect(handle)
            except Exception as e:
                logger.exception("verify collect failed for %d entries", len(entries))
                self._resolve_error(entries, e)
                continue
            for (_item, loop, fut, _), res in zip(entries, results):
                self._post(loop, fut, res, None)

    def _resolve_error(self, entries, exc) -> None:
        for _, loop, fut, _ in entries:
            self._post(loop, fut, None, exc)

    @staticmethod
    def _post(loop, fut, result, exc) -> None:
        def setter() -> None:
            if fut.done():
                return
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)

        try:
            loop.call_soon_threadsafe(setter)
        except RuntimeError:
            # The caller's loop closed before the card answered; nobody is
            # waiting anymore.
            pass

    async def close(self) -> None:
        """Per-node shutdown is a no-op for the process-wide instance: other
        nodes (and the next in-process cluster) keep using it; threads are
        daemons and idle when no traffic flows."""
        return None

    def shutdown(self) -> None:
        """Really stop the threads (tests; process teardown)."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()
        self._submit_thread.join(timeout=10.0)
        self._collect_thread.join(timeout=10.0)
        for key, svc in list(self._shared.items()):
            if svc is self:
                del self._shared[key]


def make_batch_verifier(fallback_on_error: bool = False, mode: str | None = None, device=None):
    """Build a crypto.BatchVerifier backed by the card's kernels.

    `mode` pins the accept set ("item" = strict/cofactorless like the host
    library, "msm" = cofactored batch rule); None defers to the
    NARWHAL_TPU_VERIFY_MODE default (`verify_mode`). `device` as for
    GpuVerifier: None is the card.

    Unlike the reference, there is no host fallback: a verifier that
    cannot be built raises (the reference returns None unless `require`,
    a parameter the port does not take: the card is always required), a
    failed launch's error propagates, and `fallback_on_error=True` raises
    ConfigError."""
    if fallback_on_error:
        raise ConfigError(
            "make_batch_verifier(fallback_on_error=True): the port has no host "
            "fallback for a failed launch; the error propagates"
        )
    return GpuVerifier(mode=mode, device=device)  # callable: items -> verdicts


class AsyncVerifierPool:
    """Size-or-deadline coalescing of concurrent verification requests.

    await pool.verify(pk, msg, sig) from any task; items are flushed to the
    backend in one batch when `max_batch` are waiting or `max_delay` elapsed
    since the first queued item (BatchMaker's seal rule, applied to crypto).
    The backend call runs in a thread so the event loop never blocks on it.
    The default backends are the host library's (`crypto.batch_verify`,
    `types.host_batch_verify_aggregates`).
    """

    def __init__(
        self,
        backend=None,
        max_batch: int = 512,
        max_delay: float = 0.002,
        group_backend=None,
        max_groups: int = 64,
    ):
        from .. import crypto
        from ..types import host_batch_verify_aggregates

        self.backend = backend or crypto.batch_verify
        self.max_batch = max_batch
        self.max_delay = max_delay
        self._pending: list[tuple[BatchItem, asyncio.Future]] = []
        self._flusher: asyncio.Task | None = None
        self._batches: set[asyncio.Task] = set()  # strong refs: loop holds weak
        # Aggregate-certificate group lane (compact certs): concurrent
        # verify_aggregate calls coalesce under the same seal rule and
        # dispatch as ONE host_batch_verify_aggregates call — one
        # bucket-method MSM amortized across every certificate in the
        # flush, the host analog of VerifyService's device group lane.
        self.group_backend = group_backend or host_batch_verify_aggregates
        self.max_groups = max_groups
        self._pending_groups: list[tuple[tuple, asyncio.Future]] = []
        self._group_flusher: asyncio.Task | None = None

    async def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append(((public_key, message, signature), fut))
        if len(self._pending) >= self.max_batch:
            self._flush_now()
        elif self._flusher is None or self._flusher.done():
            self._flusher = asyncio.ensure_future(self._deadline_flush())
        return await fut

    def _flush_now(self) -> None:
        pending, self._pending = self._pending, []
        if pending:
            task = asyncio.ensure_future(self._run_batch(pending))
            self._batches.add(task)
            task.add_done_callback(self._batches.discard)

    async def _deadline_flush(self) -> None:
        await asyncio.sleep(self.max_delay)
        self._flush_now()

    async def _run_batch(self, pending) -> None:
        items = [item for item, _ in pending]
        loop = asyncio.get_running_loop()
        try:
            results = await loop.run_in_executor(None, self.backend, items)
        except Exception as e:
            for _, fut in pending:
                if not fut.done():
                    fut.set_exception(e)
            return
        for (_, fut), res in zip(pending, results):
            if not fut.done():
                fut.set_result(res)

    async def verify_aggregate(self, items, zs, s_agg: int) -> bool:
        """Half-aggregated certificate proof check (compact certs), batched:
        groups queued by concurrent callers — the verifier stage's
        per-message tasks, the block synchronizer's catch-up fetches —
        seal into one `host_batch_verify_aggregates` dispatch (size- or
        deadline-triggered, like the item lane), so many certificates
        share one randomized-linear-combination MSM instead of paying a
        per-certificate scalar-mul walk."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending_groups.append(((items, zs, s_agg), fut))
        if len(self._pending_groups) >= self.max_groups:
            self._flush_groups_now()
        elif self._group_flusher is None or self._group_flusher.done():
            self._group_flusher = asyncio.ensure_future(self._deadline_flush_groups())
        return await fut

    def _flush_groups_now(self) -> None:
        pending, self._pending_groups = self._pending_groups, []
        if pending:
            task = asyncio.ensure_future(self._run_group_batch(pending))
            self._batches.add(task)
            task.add_done_callback(self._batches.discard)

    async def _deadline_flush_groups(self) -> None:
        await asyncio.sleep(self.max_delay)
        self._flush_groups_now()

    async def _run_group_batch(self, pending) -> None:
        groups = [group for group, _ in pending]
        loop = asyncio.get_running_loop()
        try:
            results = await loop.run_in_executor(None, self.group_backend, groups)
        except Exception as e:
            for _, fut in pending:
                if not fut.done():
                    fut.set_exception(e)
            return
        for (_, fut), res in zip(pending, results):
            if not fut.done():
                fut.set_result(res)

    async def close(self) -> None:
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None
        if self._group_flusher is not None:
            self._group_flusher.cancel()
            self._group_flusher = None
        self._flush_now()
        self._flush_groups_now()
        # In-flight batch dispatches resolve their callers' futures; give
        # them a bounded window to finish, then cancel stragglers so no
        # batch task survives its owner (a wedged executor thread must not
        # hang node shutdown or leak tasks into the next test).
        if self._batches:
            _, stuck = await asyncio.wait(set(self._batches), timeout=5.0)
            for t in stuck:
                t.cancel()
