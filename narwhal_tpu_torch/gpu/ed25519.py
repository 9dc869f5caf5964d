"""Batched ed25519 verification: plain PyTorch field/point layer + CUDA kernel.

Port of `narwhal_tpu/tpu/ed25519.py` (the JAX package's counterpart): the
field and point layer, `verify_batch` (the counterpart of
`verify_batch_kernel`, TPU kernel A1), `msm_accumulate` (the counterpart of
`msm_accumulate_kernel`, TPU kernel A2), the stages of the mesh-sharded
verifier (`verify_decompress`, `verify_straus`, `verify_verdict` and
`msm_window`: TPU kernels A3-A6, and `msm_shard_reduce`, the cross-shard
sum of A6's lanes) and the host packing helpers `bytes_to_limbs` /
`bytes_to_digits`.

Two implementations of each function:

- the plain PyTorch version (`verify_batch_plain` and the `fe_*` / `pt_*`
  functions below) keeps the JAX module's arithmetic exactly: radix 2^13,
  20 int32 limbs, limb-major [NLIMB, B] with the batch in the last axis,
  the same carry rounds and the same loose bound (limbs in [0, 9500]; the
  int32 bound argument is the JAX module docstring's). The CPU tests hold
  it against the JAX functions evaluated eagerly and against the bigint
  oracle `ed25519_ref`;
- the CUDA kernels `csrc/ed25519_verify.cu` (A1: the same verdicts with one
  signature per thread), `csrc/ed25519_staged.cu` (A3-A5: A1 split at the
  JAX stage boundaries, one row per thread) and `csrc/ed25519_msm.cu` (A2
  and A6: the same window-lane sums, canonical, from one thread per point
  and per (lane, chain); the shard reduce) work in radix 2^25.5 (10 limbs,
  64-bit column sums); their shared field layer and its bound argument are
  `csrc/ed25519_field.cuh`. Stage outputs keep the JAX layout, int32
  [4, NLIMB, B] radix 2^13 (canonical from a kernel, loose from a plain
  version), so either can feed the next stage.

Every wrapper dispatches on where its inputs lie: CPU tensors run the plain
version, CUDA tensors launch the kernel (or raise). There is no fallback
from a kernel to its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ed25519_ref as ref
from . import kernel_registry

NLIMB = 20
RADIX = 13
MASK = (1 << RADIX) - 1
WINDOWS = 64  # 4-bit windows over 256-bit scalars, MSB first
LOOSE = 9500


def int_to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (RADIX * i)) & MASK for i in range(NLIMB)], np.int32)


def limbs_to_int(limbs) -> int:
    arr = np.asarray(limbs.cpu() if isinstance(limbs, torch.Tensor) else limbs)
    if arr.ndim > 1:
        arr = arr[..., 0] if arr.shape[-1] == 1 else arr.squeeze()
    return sum(int(v) << (RADIX * i) for i, v in enumerate(arr))


def _col(x: int) -> np.ndarray:
    """Constant as a broadcastable [NLIMB, 1] column."""
    return int_to_limbs(x)[:, None]


_P_LIMBS = int_to_limbs(ref.P)
_D = _col(ref.D)
_2D = _col(2 * ref.D % ref.P)
_SQRT_M1 = _col(ref.SQRT_M1)
_ONE = _col(1)

# 64p = 2^261 - 1216 with every limb large: per-limb subtraction bias.
_SUB_BIAS = np.array([15168] + [16382] * (NLIMB - 1), np.int32)[:, None]
assert limbs_to_int(_SUB_BIAS) == 64 * ref.P

# Fixed-base window table: 16 small multiples of B in CACHED affine form
# (y+x, y-x, 2d*t mod p); the identity row is (1, 1, 0) and Z == 1
# implicitly, so each table add is the 7-mul pt_add_cached_z1.
_BT = np.zeros((16, 3, NLIMB), np.int32)
for _dd, (_x, _y, _t) in enumerate(ref.base_window_table()):
    _BT[_dd, 0] = int_to_limbs((_y + _x) % ref.P)
    _BT[_dd, 1] = int_to_limbs((_y - _x) % ref.P)
    _BT[_dd, 2] = int_to_limbs(2 * ref.D * _t % ref.P)

# The kernel's field constants, in the same radix-2^13 layout as the host
# tables (the kernel repacks them into its own radix on device).
_KERNEL_CONSTS = np.stack([_D[:, 0], _2D[:, 0], _SQRT_M1[:, 0]])  # [3, NLIMB]

_DEVICE_CONSTS: dict = {}


def _const(name: str, device: torch.device) -> torch.Tensor:
    """A host constant as an int32 tensor on `device` (cached per device)."""
    key = (name, str(device))
    t = _DEVICE_CONSTS.get(key)
    if t is None:
        arr = {
            "D": _D, "2D": _2D, "SQRT_M1": _SQRT_M1, "ONE": _ONE,
            "SUB_BIAS": _SUB_BIAS, "BT": _BT, "KERNEL_CONSTS": _KERNEL_CONSTS,
        }[name]
        t = torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.int32, device=device)
        _DEVICE_CONSTS[key] = t
    return t


def _bcast(name: str, like: torch.Tensor) -> torch.Tensor:
    """[NLIMB, 1] host constant, broadcast-ready against `like` (limb axis
    0, any number of trailing batch axes)."""
    c = _const(name, like.device)
    return c[:, 0].reshape((NLIMB,) + (1,) * (like.dim() - 1))


# ---------------------------------------------------------------------------
# Field ops: tensors are [NLIMB] or [NLIMB, B]; the limb axis is ALWAYS 0.
# ---------------------------------------------------------------------------


def _carry_round(r: torch.Tensor) -> torch.Tensor:
    """One parallel carry round; limb-19 overflow (2^260 == 608 mod p) wraps
    to limb 0."""
    hi = r >> RADIX
    lo = r & MASK
    lo[1:] += hi[:-1]
    lo[0] += 608 * hi[-1]
    return lo


def fe_add(a, b):
    return _carry_round(_carry_round(a + b))


def fe_sub(a, b):
    r = a + _bcast("SUB_BIAS", b) - b
    return _carry_round(_carry_round(_carry_round(r)))


def fe_neg(a):
    return _carry_round(_carry_round(_bcast("SUB_BIAS", a) - a))


def _fold_and_carry(cols: torch.Tensor) -> torch.Tensor:
    """39 school-book columns [2*NLIMB-1, ...] -> loose field element: fold
    the high half (2^260 == 608 mod p) by 13-bit split so nothing overflows
    int32, then 4 parallel carry rounds."""
    c_lo = cols[:NLIMB]
    c_hi = cols[NLIMB:]  # 19 rows; row 19 of the high half is zero
    d_lo = c_hi & MASK
    d_hi = c_hi >> RADIX
    r = c_lo.clone()
    r[: NLIMB - 1] += 608 * d_lo
    r[1:NLIMB] += 608 * d_hi
    for _ in range(4):
        r = _carry_round(r)
    return r


def _batch_shape(a, b) -> tuple:
    """Broadcast of the batch axes of two field elements (the limb axis 0
    excluded); cheaper than torch.broadcast_shapes on this hot path."""
    x, y = tuple(a.shape[1:]), tuple(b.shape[1:])
    if x == y:
        return x
    n = max(len(x), len(y))
    x, y = (1,) * (n - len(x)) + x, (1,) * (n - len(y)) + y
    return tuple(max(p, q) for p, q in zip(x, y))


def fe_mul(a, b):
    """School-book product: column k = sum_{i+j=k} a_i * b_j (the same
    integer columns as the JAX module's, so the same int32 bound:
    20 * 9500^2 < 2^31). The outer product [20, 20, ...] is skewed so row i
    shifts right by i: pad each row to 40, flatten, keep the first
    20 * 39 entries and view them as [20, 39, ...]; the column sums are then
    one reduction over the row axis."""
    batch = _batch_shape(a, b)
    prod = a.unsqueeze(1) * b.unsqueeze(0)  # [20, 20, *batch]
    prod = prod.expand((NLIMB, NLIMB) + batch)
    padded = torch.cat([prod, torch.zeros_like(prod)], dim=1)  # [20, 40, ...]
    skew = padded.reshape((2 * NLIMB * NLIMB,) + batch)[: NLIMB * (2 * NLIMB - 1)]
    cols = skew.reshape((NLIMB, 2 * NLIMB - 1) + batch).sum(0, dtype=torch.int32)
    return _fold_and_carry(cols)


def fe_sq(a):
    """Squaring: the columns of a*a are the JAX module's fe_sq columns
    (the doubled cross terms summed), so the result is bit-identical."""
    return fe_mul(a, a)


def _carry_chain_exact(r):
    """Sequential full carry (canonicalization only, off the hot path)."""
    outs = []
    carry = torch.zeros_like(r[0])
    for i in range(NLIMB):
        v = r[i] + carry
        outs.append(v & MASK)
        carry = v >> RADIX
    return torch.stack(outs, dim=0), carry


def fe_canonical(a):
    """Full reduction to [0, p) from loose form."""
    for _ in range(2):
        a, overflow = _carry_chain_exact(a)
        top = a[NLIMB - 1].clone()
        hi = (top >> 8) + (overflow << (RADIX - 8))
        a[NLIMB - 1] = top & 0xFF
        a[0] += 19 * hi
    a, _ = _carry_chain_exact(a)
    for _ in range(2):  # value < 2^255 + eps: conditionally subtract p
        borrow = torch.zeros_like(a[0])
        outs = []
        for i in range(NLIMB):
            v = a[i] - int(_P_LIMBS[i]) - borrow
            borrow = (v < 0).to(torch.int32)
            outs.append(v + (borrow << RADIX))
        sub = torch.stack(outs, dim=0)
        a = torch.where(borrow == 0, sub, a)
    return a


def fe_eq(a, b):
    return torch.all(fe_canonical(a) == fe_canonical(b), dim=0)


def _times_sq(x, n):
    for _ in range(n):
        x = fe_sq(x)
    return x


def _ladder(z):
    """Shared exponentiation ladder: returns (z^(2^250-1), z^11)."""
    t0 = fe_sq(z)
    t1 = fe_sq(fe_sq(t0))
    t1 = fe_mul(z, t1)  # z^9
    t0 = fe_mul(t0, t1)  # z^11
    t2 = fe_sq(t0)
    t1 = fe_mul(t1, t2)  # z^31
    z11 = t0
    t2 = _times_sq(t1, 5)
    t1 = fe_mul(t2, t1)  # 2^10-1
    t2 = _times_sq(t1, 10)
    t2 = fe_mul(t2, t1)  # 2^20-1
    t3 = _times_sq(t2, 20)
    t2 = fe_mul(t3, t2)  # 2^40-1
    t2 = _times_sq(t2, 10)
    t1 = fe_mul(t2, t1)  # 2^50-1
    t2 = _times_sq(t1, 50)
    t2 = fe_mul(t2, t1)  # 2^100-1
    t3 = _times_sq(t2, 100)
    t2 = fe_mul(t3, t2)  # 2^200-1
    t2 = _times_sq(t2, 50)
    t1 = fe_mul(t2, t1)  # 2^250-1
    return t1, z11


def fe_invert(z):
    t1, z11 = _ladder(z)
    t1 = _times_sq(t1, 5)
    return fe_mul(t1, z11)  # z^(p-2)


def fe_pow22523(z):
    t1, _ = _ladder(z)
    t1 = fe_sq(fe_sq(t1))
    return fe_mul(t1, z)  # z^(2^252-3)


# ---------------------------------------------------------------------------
# Point ops: extended twisted-Edwards (X, Y, Z, T) tuples of limb-major
# tensors. The addition law is complete on ed25519.
# ---------------------------------------------------------------------------


def pt_identity(batch_shape=(), device=None):
    zero = torch.zeros((NLIMB,) + tuple(batch_shape), dtype=torch.int32, device=device)
    one = zero.clone()
    one[0] = 1
    return (zero, one, one.clone(), zero.clone())


def pt_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = fe_mul(fe_sub(y1, x1), fe_sub(y2, x2))
    b = fe_mul(fe_add(y1, x1), fe_add(y2, x2))
    c = fe_mul(fe_mul(t1, _bcast("2D", t1)), t2)
    d = fe_mul(fe_add(z1, z1), z2)
    e, f, g, h = fe_sub(b, a), fe_sub(d, c), fe_add(d, c), fe_add(b, a)
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))


def pt_double(p):
    x1, y1, z1, _ = p
    a = fe_sq(x1)
    b = fe_sq(y1)
    c = fe_add(fe_sq(z1), fe_sq(z1))
    h = fe_add(a, b)
    e = fe_sub(h, fe_sq(fe_add(x1, y1)))
    g = fe_sub(a, b)
    f = fe_add(c, g)
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))


def pt_neg(p):
    x, y, z, t = p
    return (fe_neg(x), y, z, fe_neg(t))


def pt_cache(p):
    """Projective (X, Y, Z, T) -> cached (Y+X, Y-X, Z, 2D*T)."""
    x, y, z, t = p
    return (fe_add(y, x), fe_sub(y, x), z, fe_mul(t, _bcast("2D", t)))


def pt_add_cached(p, q):
    """p projective + q cached: 8 fe_muls (vs pt_add's 9)."""
    x1, y1, z1, t1 = p
    yp2, ym2, z2, t2d = q
    a = fe_mul(fe_sub(y1, x1), ym2)
    b = fe_mul(fe_add(y1, x1), yp2)
    c = fe_mul(t1, t2d)
    d = fe_mul(fe_add(z1, z1), z2)
    e, f, g, h = fe_sub(b, a), fe_sub(d, c), fe_add(d, c), fe_add(b, a)
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))


def pt_add_cached_z1(p, q):
    """p projective + q cached with Z2 == 1 (affine table constants):
    7 fe_muls."""
    x1, y1, z1, t1 = p
    yp2, ym2, t2d = q
    a = fe_mul(fe_sub(y1, x1), ym2)
    b = fe_mul(fe_add(y1, x1), yp2)
    c = fe_mul(t1, t2d)
    d = fe_add(z1, z1)
    e, f, g, h = fe_sub(b, a), fe_sub(d, c), fe_add(d, c), fe_add(b, a)
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))


# ---------------------------------------------------------------------------
# Decompression and batched verification (limb-major, batch last).
# ---------------------------------------------------------------------------


def decompress(y_limbs, sign):
    """Recover x from canonical y [NLIMB, B] and sign [B]. Returns (point,
    valid[B])."""
    one = _bcast("ONE", y_limbs)
    y2 = fe_sq(y_limbs)
    u = fe_sub(y2, one)
    v = fe_add(fe_mul(y2, _bcast("D", y2)), one)
    v3 = fe_mul(fe_sq(v), v)
    v7 = fe_mul(fe_sq(v3), v)
    x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)))
    vx2 = fe_mul(v, fe_sq(x))
    correct = fe_eq(vx2, u)
    flipped = fe_eq(vx2, fe_neg(u))
    valid = correct | flipped
    x = torch.where(flipped, fe_mul(x, _bcast("SQRT_M1", x)), x)
    x_can = fe_canonical(x.clone())
    x_zero = torch.all(x_can == 0, dim=0)
    valid = valid & ~(x_zero & (sign == 1))
    parity = x_can[0] & 1
    x = torch.where(parity != sign, fe_neg(x), x)
    z = torch.zeros_like(x)
    z[0] = 1
    return (x, y_limbs, z, fe_mul(x, y_limbs)), valid


def _select(table, digit):
    """table [16, NLIMB, B], digit [B] -> [NLIMB, B]: row digit[b] of lane b."""
    idx = digit.long().reshape(1, 1, -1).expand(1, table.shape[1], table.shape[2])
    return table.gather(0, idx)[0]


def _select_const(table, digit):
    """table [16, NLIMB] (host constant), digit [B] -> [NLIMB, B]."""
    return table[digit.long()].T


def _pt_cached_table(neg_p, batch):
    """16 multiples (identity, P, 2P, ... 15P) of each lane's point in
    CACHED form (Y+X, Y-X, Z, 2D*T): 4 coordinate tensors [16, NLIMB, B]."""
    base_c = pt_cache(neg_p)
    entries = [base_c]
    prev = neg_p
    for _ in range(14):
        prev = pt_add_cached(prev, base_c)
        entries.append(pt_cache(prev))
    zero = torch.zeros((NLIMB, batch), dtype=torch.int32, device=neg_p[0].device)
    one = zero.clone()
    one[0] = 1
    ident_c = (one, one, one, zero)  # cached identity: yp=ym=z=1, t2d=0
    return tuple(
        torch.stack([ident_c[i]] + [e[i] for e in entries], dim=0) for i in range(4)
    )


def _straus_walk(a_point, k_digits, s_digits):
    """acc = [S]B + [k](-A) per lane: the -A table, then one window per row
    of k_digits / s_digits (int32 [64, B], MSB first) of four doublings and
    two cached adds."""
    dev = a_point[0].device
    B = a_point[0].shape[1]
    table_a = _pt_cached_table(pt_neg(a_point), B)
    bt = _const("BT", dev)
    acc = pt_identity((B,), device=dev)
    for kd, sd in zip(k_digits, s_digits):
        for _ in range(4):
            acc = pt_double(acc)
        qa = tuple(_select(table_a[i], kd) for i in range(4))
        acc = pt_add_cached(acc, qa)
        qb = tuple(_select_const(bt[:, i], sd) for i in range(3))
        acc = pt_add_cached_z1(acc, qb)
    return acc


def _verdicts(acc, r_point, r_y, r_sign, a_valid, r_valid):
    """Strict and cofactored verdicts from the walk's accumulator and R
    (r_y limb-major [NLIMB, B], r_sign int32 [B])."""
    zinv = fe_invert(acc[2])
    x = fe_mul(acc[0], zinv)
    y = fe_mul(acc[1], zinv)
    x_can = fe_canonical(x)
    ok_strict = fe_eq(y, r_y) & ((x_can[0] & 1) == r_sign) & a_valid

    # Cofactored verdict: [8](Rcheck + (-R)) == identity.
    diff = pt_add(acc, pt_neg(r_point))
    for _ in range(3):
        diff = pt_double(diff)
    ok_cof = fe_eq(diff[0], torch.zeros_like(diff[0])) & fe_eq(diff[1], diff[2])
    return ok_strict, ok_cof & a_valid & r_valid


def verify_batch_plain(a_y, a_sign, r_y, r_sign, k_digits, s_digits):
    """The plain PyTorch version of the kernel: per-lane check of
    [S]B + [k](-A) against R under BOTH rules, exactly as the JAX
    `verify_batch_kernel` computes it:

    strict (cofactorless, the host library's): encode(Rcheck) == (r_y,
    r_sign); cofactored (RFC 8032 / dalek batch): [8](Rcheck - R) ==
    identity.

    Shapes (batch-leading, the JAX host layout): a_y/r_y int[B, NLIMB]
    canonical y limbs; a_sign/r_sign int[B]; k_digits/s_digits int[B, 64]
    4-bit digits MSB-first. Returns (strict bool[B], cofactored bool[B])."""
    a_y = a_y.T.to(torch.int32).contiguous()  # -> limb-major [NLIMB, B]
    r_y = r_y.T.to(torch.int32).contiguous()
    a_sign = a_sign.to(torch.int32)
    r_sign = r_sign.to(torch.int32)
    a_point, valid = decompress(a_y, a_sign)
    acc = _straus_walk(a_point, k_digits.T.to(torch.int32), s_digits.T.to(torch.int32))
    r_point, r_valid = decompress(r_y, r_sign)
    return _verdicts(acc, r_point, r_y, r_sign, valid, r_valid)


def _check_inputs(kernel: str, want: dict, device) -> None:
    """Refuse what a kernel does not take: `want` maps each argument's name
    to (tensor, dtype, shape); every tensor must lie on `device`, be
    contiguous and have that dtype and shape."""
    for name, (t, dtype, shape) in want.items():
        if t.device != device:
            raise ValueError(f"{kernel}: {name} on {t.device}, expected {device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{kernel}: {name} must be {dtype} {tuple(shape)}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _launch(stem: str, symbol: str, kernel: str, dev, ptrs, ints=()) -> None:
    """Launch `symbol` of the library built from `csrc/<stem>.cu` on `dev`'s
    current stream (tensor arguments as pointers, then ints), raise if the
    launch failed, and count it."""
    fn = kernel_registry.function(stem, symbol, len(ptrs), len(ints))
    with torch.cuda.device(dev):  # the launch's device, whatever the thread's
        rc = fn(
            *(t.data_ptr() for t in ptrs), *ints,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernel_registry.check(stem, kernel, rc)
    kernel_registry.count_launch(kernel)


def _check_kernel_inputs(a_y, a_sign, r_y, r_sign, k_digits, s_digits) -> int:
    B = a_y.shape[0] if a_y.dim() == 2 else -1
    _check_inputs("verify_batch", {
        "a_y": (a_y, torch.int16, (B, NLIMB)),
        "r_y": (r_y, torch.int16, (B, NLIMB)),
        "a_sign": (a_sign, torch.int8, (B,)),
        "r_sign": (r_sign, torch.int8, (B,)),
        "k_digits": (k_digits, torch.int8, (B, WINDOWS)),
        "s_digits": (s_digits, torch.int8, (B, WINDOWS)),
    }, a_y.device)
    return B


def verify_batch(a_y, a_sign, r_y, r_sign, k_digits, s_digits):
    """Strict and cofactored verdicts for a batch of signatures; the JAX
    `verify_batch_kernel`'s signature and results.

    On CPU tensors: the plain version. On CUDA tensors: the kernel of
    `csrc/ed25519_verify.cu` (int16 limbs, int8 signs and digits, the host
    layout), launched on the current stream; a failed build or launch
    raises."""
    dev = a_y.device
    if dev.type == "cpu":
        return verify_batch_plain(a_y, a_sign, r_y, r_sign, k_digits, s_digits)
    if dev.type != "cuda":
        raise ValueError(f"verify_batch: unsupported device {dev}")
    B = _check_kernel_inputs(a_y, a_sign, r_y, r_sign, k_digits, s_digits)
    strict = torch.empty((B,), dtype=torch.bool, device=dev)
    cof = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return strict, cof
    _launch("ed25519_verify", "ed25519_verify_batch", "verify_batch", dev, (
        a_y, a_sign, r_y, r_sign, k_digits, s_digits,
        _const("BT", dev), _const("KERNEL_CONSTS", dev), strict, cof,
    ), (B,))
    return strict, cof


def field_muls_per_signature() -> dict:
    """Field operations one signature costs in the kernel of `verify_batch`:
    the operation count behind its bound. (The plain version runs the same
    sequence except that its doubling squares Z twice, as the JAX module's
    does.) Counts: decompress (A and R)
    255 sq + 20 mul each; the -A table 127 mul; the Straus walk 64 windows
    x (4 doublings of 4 sq + 4 mul, one 8-mul cached add, one 7-mul affine
    add); the inversion 254 sq + 11 mul; x, y 2 mul; the cofactored
    epilogue one 9-mul pt_add and 3 doublings."""
    decompress = (255, 20)
    sq = 2 * decompress[0] + 64 * 16 + 254 + 3 * 4
    mul = 2 * decompress[1] + 127 + 64 * (4 * 4 + 8 + 7) + 11 + 2 + 9 + 3 * 4
    return {"sq": sq, "mul": mul}


# ---------------------------------------------------------------------------
# Staged per-item verification (TPU kernels A3-A5): A1 split at the JAX
# stage boundaries for the mesh-sharded verifier (verifier._sharded_kernels):
# decompress (run once for the A set, once for the R set) -> Straus walk ->
# verdict. Points cross the boundaries as int32 [4, NLIMB, B] (X, Y, Z, T),
# radix 2^13, limb-major. The per-lane arithmetic is A1's, so the verdicts
# are A1's bit for bit.
# ---------------------------------------------------------------------------


def verify_decompress_plain(y_rows, signs):
    """The JAX `verify_decompress_kernel`: y_rows int[B, NLIMB] canonical y
    limbs (host layout), signs int[B] -> (points int32 [4, NLIMB, B]
    extended coordinates, valid bool [B])."""
    y = y_rows.T.to(torch.int32).contiguous()
    point, valid = decompress(y, signs.to(torch.int32))
    return torch.stack(point, dim=0), valid


def verify_straus_plain(a_pt, k_digits, s_digits):
    """The JAX `verify_straus_kernel`: a_pt int32 [4, NLIMB, B] decompressed
    A points, k_digits / s_digits int[B, 64] 4-bit MSB-first -> acc int32
    [4, NLIMB, B] = [S]B + [k](-A), projective."""
    a_point = tuple(a_pt[i] for i in range(4))
    acc = _straus_walk(a_point, k_digits.T.to(torch.int32), s_digits.T.to(torch.int32))
    return torch.stack(acc, dim=0)


def verify_verdict_plain(acc_pt, r_pt, r_y, r_sign, a_valid, r_valid):
    """The JAX `verify_verdict_kernel`: both verdicts from the walk's
    accumulator and the decompressed R set -> (strict bool [B], cofactored
    bool [B])."""
    acc = tuple(acc_pt[i] for i in range(4))
    r_point = tuple(r_pt[i] for i in range(4))
    r_y_lm = r_y.T.to(torch.int32).contiguous()
    return _verdicts(acc, r_point, r_y_lm, r_sign.to(torch.int32), a_valid, r_valid)


def _points_spec(t, B: int) -> tuple:
    return (t, torch.int32, (4, NLIMB, B))


def verify_decompress(y_rows, signs):
    """A3: decompress one point set; `verify_decompress_plain`'s signature and
    results (points canonical from the kernel). On CPU tensors the plain
    version; on CUDA tensors the kernel of `csrc/ed25519_staged.cu` (int16
    limbs, int8 signs)."""
    dev = y_rows.device
    if dev.type == "cpu":
        return verify_decompress_plain(y_rows, signs)
    if dev.type != "cuda":
        raise ValueError(f"verify_decompress: unsupported device {dev}")
    B = y_rows.shape[0] if y_rows.dim() == 2 else -1
    _check_inputs("verify_decompress", {
        "y_rows": (y_rows, torch.int16, (B, NLIMB)),
        "signs": (signs, torch.int8, (B,)),
    }, dev)
    pts = torch.empty((4, NLIMB, B), dtype=torch.int32, device=dev)
    valid = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        _launch("ed25519_staged", "ed25519_verify_decompress", "verify_decompress", dev,
                (y_rows, signs, _const("KERNEL_CONSTS", dev), pts, valid), (B,))
    return pts, valid


def verify_straus(a_pt, k_digits, s_digits):
    """A4: the Straus walk over decompressed A points; `verify_straus_plain`'s
    signature and results (the kernel's accumulator canonical, the same
    projective point). On CUDA tensors the kernel of `csrc/ed25519_staged.cu`
    (int32 points, int8 digits)."""
    dev = a_pt.device
    if dev.type == "cpu":
        return verify_straus_plain(a_pt, k_digits, s_digits)
    if dev.type != "cuda":
        raise ValueError(f"verify_straus: unsupported device {dev}")
    B = a_pt.shape[2] if a_pt.dim() == 3 else -1
    _check_inputs("verify_straus", {
        "a_pt": _points_spec(a_pt, B),
        "k_digits": (k_digits, torch.int8, (B, WINDOWS)),
        "s_digits": (s_digits, torch.int8, (B, WINDOWS)),
    }, dev)
    acc = torch.empty((4, NLIMB, B), dtype=torch.int32, device=dev)
    if B:
        _launch("ed25519_staged", "ed25519_verify_straus", "verify_straus", dev, (
            a_pt, k_digits, s_digits, _const("BT", dev), _const("KERNEL_CONSTS", dev), acc,
        ), (B,))
    return acc


def verify_verdict(acc_pt, r_pt, r_y, r_sign, a_valid, r_valid):
    """A5: the strict and cofactored verdicts; `verify_verdict_plain`'s
    signature and results. On CUDA tensors the kernel of
    `csrc/ed25519_staged.cu` (int32 points, int16 r_y, int8 r_sign, bool
    validity)."""
    dev = acc_pt.device
    if dev.type == "cpu":
        return verify_verdict_plain(acc_pt, r_pt, r_y, r_sign, a_valid, r_valid)
    if dev.type != "cuda":
        raise ValueError(f"verify_verdict: unsupported device {dev}")
    B = acc_pt.shape[2] if acc_pt.dim() == 3 else -1
    _check_inputs("verify_verdict", {
        "acc_pt": _points_spec(acc_pt, B),
        "r_pt": _points_spec(r_pt, B),
        "r_y": (r_y, torch.int16, (B, NLIMB)),
        "r_sign": (r_sign, torch.int8, (B,)),
        "a_valid": (a_valid, torch.bool, (B,)),
        "r_valid": (r_valid, torch.bool, (B,)),
    }, dev)
    strict = torch.empty((B,), dtype=torch.bool, device=dev)
    cof = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        _launch("ed25519_staged", "ed25519_verify_verdict", "verify_verdict", dev, (
            acc_pt, r_pt, r_y, r_sign, a_valid, r_valid, _const("KERNEL_CONSTS", dev),
            strict, cof,
        ), (B,))
    return strict, cof


def staged_field_ops() -> dict:
    """Field squarings and multiplications per row of each staged kernel,
    counted as `field_muls_per_signature` counts A1's (whose walk, epilogue
    and decompression they are): A3 one decompression; A4 the -A table and
    the 64-window walk; A5 the inversion, x and y, the 9-mul pt_add and 3
    doublings. Two A3 rows (A and R), one A4 and one A5 make A1's count."""
    return {
        "verify_decompress": {"sq": 255, "mul": 20},
        "verify_straus": {"sq": 64 * 16, "mul": 127 + 64 * (4 * 4 + 8 + 7)},
        "verify_verdict": {"sq": 254 + 3 * 4, "mul": 11 + 2 + 9 + 3 * 4},
    }


# ---------------------------------------------------------------------------
# Random-linear-combination batch verification: the window-lane accumulate
# (TPU kernel A2). The batch equation
#   [sum z_i S_i]B - sum [z_i k_i]A_i - sum [z_i]R_i == 0
# needs each point added once per scalar window, with the doublings shared
# by the whole batch; the device sums, per window lane, digit * (-P) over
# the batch, and the host (verifier.msm_epilogue_check) Horner-collapses the
# lanes. See the JAX module's section of the same name.
# ---------------------------------------------------------------------------

MSM_CHUNK = 128  # the JAX kernel's chains per window lane (`chunk`)
MSM_WA, MSM_WR = 64, 32  # window lanes of the A (z*k) and R (z) scalars


def _select_lanes(table, digits):
    """table [16, NLIMB, C], digits [C, W] -> [NLIMB, W, C]: every window
    lane of every chain picks its own table row."""
    idx = digits.T.long()  # [W, C]
    idx = idx.unsqueeze(0).expand(table.shape[1], idx.shape[0], idx.shape[1])
    return table.permute(1, 0, 2).gather(1, idx)


def _accumulate_windows(table, digits, chunk):
    """Stream the M points through the window-lane accumulator.

    table: 4 CACHED coords [16, NLIMB, M]; digits [M, W]. Returns V: 4
    projective coords [NLIMB, W] = per window lane, sum_j digit_{j,w} P_j.
    Chain c holds points c, C + c, 2C + c, ... in that order; the chains
    then reduce in log2(C) fixed-width rounds, round r adding the chain
    C/2^(r+1) to the right of every chain (the JAX scan's order)."""
    M, W = digits.shape
    C = min(chunk, M)
    S = M // C
    xs_table = tuple(t.reshape(16, NLIMB, S, C).permute(2, 0, 1, 3) for t in table)
    xs_digits = digits.reshape(S, C, W)
    acc = pt_identity((W, C), device=digits.device)
    for s in range(S):
        q = tuple(_select_lanes(xs_table[i][s], xs_digits[s]) for i in range(4))
        acc = pt_add_cached(acc, q)
    for r in range((C - 1).bit_length()):
        idx = (torch.arange(C, device=digits.device) + (C >> (r + 1))) % C
        partner = tuple(a.index_select(-1, idx) for a in acc)
        acc = pt_add(acc, partner)
    return tuple(a[..., 0] for a in acc)  # [NLIMB, W]


def msm_accumulate_plain(a_y, a_sign, r_y, r_sign, ak_digits, z_digits, chunk=MSM_CHUNK):
    """The plain PyTorch version of the kernel: per-window point sums of
    sum [z_i k_i](-A_i) + sum [z_i](-R_i) over the batch, exactly as the JAX
    `msm_accumulate_kernel` computes them (raw limbs equal).

    Shapes (batch-leading, the JAX host layout): a_y/r_y int[B, NLIMB]
    canonical y limbs; signs int[B]; ak_digits int[B, 64] = 4-bit MSB-first
    digits of z_i k_i mod L; z_digits int[B, 32] = digits of the 128-bit z_i.
    Zero rows are inert padding. Returns (V_a int32[4, NLIMB, 64], V_r
    int32[4, NLIMB, 32] loose X/Y/Z/T limbs per window lane, valid bool[B])."""
    ak_digits = ak_digits.to(torch.int32)
    z_digits = z_digits.to(torch.int32)
    B = a_y.shape[0]
    ys = torch.cat([a_y.T, r_y.T], dim=1).to(torch.int32).contiguous()  # [NLIMB, 2B]
    signs = torch.cat([a_sign, r_sign]).to(torch.int32)
    points, valid = decompress(ys, signs)
    table = _pt_cached_table(pt_neg(points), 2 * B)
    table_a = tuple(t[..., :B] for t in table)
    table_r = tuple(t[..., B:] for t in table)
    v_a = _accumulate_windows(table_a, ak_digits, chunk)
    v_r = _accumulate_windows(table_r, z_digits, chunk)
    return torch.stack(v_a, dim=0), torch.stack(v_r, dim=0), valid[:B] & valid[B:]


def _check_chains(kernel: str, B: int) -> int:
    """The chains of a window accumulate over B rows, min(128, B) as the JAX
    kernel's `chunk`; B must be a multiple of them and they a power of two."""
    C = min(MSM_CHUNK, B)
    if B < 1 or C & (C - 1) or B % C:
        raise ValueError(
            f"{kernel}: B={B} must be a multiple of its {C} chains, a power of two"
        )
    return C


def _check_msm_inputs(a_y, a_sign, r_y, r_sign, ak_digits, z_digits) -> int:
    B = a_y.shape[0] if a_y.dim() == 2 else -1
    _check_inputs("msm_accumulate", {
        "a_y": (a_y, torch.int16, (B, NLIMB)),
        "r_y": (r_y, torch.int16, (B, NLIMB)),
        "a_sign": (a_sign, torch.int8, (B,)),
        "r_sign": (r_sign, torch.int8, (B,)),
        "ak_digits": (ak_digits, torch.int8, (B, MSM_WA)),
        "z_digits": (z_digits, torch.int8, (B, MSM_WR)),
    }, a_y.device)
    _check_chains("msm_accumulate", B)
    return B


def msm_accumulate(a_y, a_sign, r_y, r_sign, ak_digits, z_digits):
    """Window-lane sums of the batch's RLC terms and the rows' validity; the
    JAX `msm_accumulate_kernel`'s signature and results.

    On CPU tensors: the plain version (loose limbs). On CUDA tensors: the
    kernels of `csrc/ed25519_msm.cu` (int16 limbs, int8 signs and digits,
    the host layout), launched on the current stream, whose V lanes are
    canonical limbs of the same values mod p; a failed build or launch
    raises."""
    dev = a_y.device
    if dev.type == "cpu":
        return msm_accumulate_plain(a_y, a_sign, r_y, r_sign, ak_digits, z_digits)
    if dev.type != "cuda":
        raise ValueError(f"msm_accumulate: unsupported device {dev}")
    B = _check_msm_inputs(a_y, a_sign, r_y, r_sign, ak_digits, z_digits)
    C = _check_chains("msm_accumulate", B)
    v_a = torch.empty((4, NLIMB, MSM_WA), dtype=torch.int32, device=dev)
    v_r = torch.empty((4, NLIMB, MSM_WR), dtype=torch.int32, device=dev)
    valid = torch.empty((B,), dtype=torch.bool, device=dev)
    # Scratch: the cached tables (2B points x 16 entries x 4 coords x 10
    # limbs), each point's validity, and the chain sums (96 lanes x C
    # chains x 4 coords x 10 limbs).
    table = torch.empty((2 * B * 16 * 40,), dtype=torch.int32, device=dev)
    pvalid = torch.empty((2 * B,), dtype=torch.uint8, device=dev)
    partial = torch.empty(((MSM_WA + MSM_WR) * C * 40,), dtype=torch.int32, device=dev)
    _launch("ed25519_msm", "ed25519_msm_accumulate", "msm_accumulate", dev, (
        a_y, a_sign, r_y, r_sign, ak_digits, z_digits, _const("KERNEL_CONSTS", dev),
        table, pvalid, partial, v_a, v_r, valid,
    ), (B, C))
    return v_a, v_r, valid


def msm_window_plain(pts, digits, chunk=MSM_CHUNK):
    """The JAX `msm_window_kernel`: A2's cached-table build and window-lane
    accumulate over ONE point set. pts int32 [4, NLIMB, B] decompressed
    points, digits int[B, W] -> V int32 [4, NLIMB, W] loose limbs per window
    lane: sum_j digit_{j,w} (-P_j)."""
    point = tuple(pts[i] for i in range(4))
    table = _pt_cached_table(pt_neg(point), pts.shape[2])
    v = _accumulate_windows(table, digits.to(torch.int32), chunk)
    return torch.stack(v, dim=0)


def msm_window(pts, digits):
    """A6: `msm_window_plain`'s signature and results (the kernel's lanes
    canonical, the same points). On CUDA tensors the kernels of
    `csrc/ed25519_msm.cu` (int32 points, int8 digits of the A scalars' 64
    or the R scalars' 32 lanes), with A2's min(128, B) chains."""
    dev = pts.device
    if dev.type == "cpu":
        return msm_window_plain(pts, digits)
    if dev.type != "cuda":
        raise ValueError(f"msm_window: unsupported device {dev}")
    B = pts.shape[2] if pts.dim() == 3 else -1
    W = digits.shape[1] if digits.dim() == 2 else -1
    if W not in (MSM_WA, MSM_WR):
        raise ValueError(f"msm_window: digits must have {MSM_WA} or {MSM_WR} lanes, got {W}")
    _check_inputs("msm_window", {
        "pts": _points_spec(pts, B),
        "digits": (digits, torch.int8, (B, W)),
    }, dev)
    C = _check_chains("msm_window", B)
    v = torch.empty((4, NLIMB, W), dtype=torch.int32, device=dev)
    # Scratch: the cached tables (B points x 16 entries x 4 coords x 10
    # limbs) and the chain sums (W lanes x C chains x 4 coords x 10 limbs).
    table = torch.empty((B * 16 * 40,), dtype=torch.int32, device=dev)
    partial = torch.empty((W * C * 40,), dtype=torch.int32, device=dev)
    _launch("ed25519_msm", "ed25519_msm_window", "msm_window", dev, (
        pts, digits, _const("KERNEL_CONSTS", dev), table, partial, v,
    ), (B, W, C))
    return v


def msm_shard_reduce_plain(lanes):
    """The cross-shard sum of A6's lanes: lanes int32 [k, 4, NLIMB, W], one
    lane set per shard -> [4, NLIMB, W], lane by lane the pt_add fold of the
    sets in shard order (the reduce XLA inserts after the sharded JAX
    `msm_window_kernel`, in an order of its own)."""
    acc = tuple(lanes[0, c] for c in range(4))
    for s in range(1, lanes.shape[0]):
        acc = pt_add(acc, tuple(lanes[s, c] for c in range(4)))
    return torch.stack(acc, dim=0)


def msm_shard_reduce(lanes):
    """`msm_shard_reduce_plain`'s signature and results (canonical from the
    kernel). On CUDA tensors the kernel of `csrc/ed25519_msm.cu`."""
    dev = lanes.device
    if dev.type == "cpu":
        return msm_shard_reduce_plain(lanes)
    if dev.type != "cuda":
        raise ValueError(f"msm_shard_reduce: unsupported device {dev}")
    k = lanes.shape[0] if lanes.dim() == 4 else -1
    W = lanes.shape[3] if lanes.dim() == 4 else -1
    if k < 1 or not 1 <= W <= MSM_WA:
        raise ValueError(f"msm_shard_reduce: lanes must be [k >= 1, 4, {NLIMB}, W <= 64]")
    _check_inputs("msm_shard_reduce", {"lanes": (lanes, torch.int32, (k, 4, NLIMB, W))}, dev)
    v = torch.empty((4, NLIMB, W), dtype=torch.int32, device=dev)
    _launch("ed25519_msm", "ed25519_msm_shard_reduce", "msm_shard_reduce", dev,
            (lanes, _const("KERNEL_CONSTS", dev), v), (k, W))
    return v


def msm_window_ops(live: int, lanes: int, batch: int, chunk: int = MSM_CHUNK) -> int:
    """Field multiplications (it squares nothing) that the kernels of
    `msm_window` must do for one launch of `batch` points and `lanes` window
    lanes, counted as `msm_field_ops` counts A2's lanes: for each of the
    `live` points (a nonzero digit) its table, 127 mul, and one 8-mul cached
    add per lane; and, when any point is live, the chain tree's C - 1
    nine-mul adds per lane. The decompression is A3's. Zero-digit rows
    select the identity and are not counted."""
    c = min(chunk, batch)
    return 127 * live + 8 * lanes * live + 9 * (c - 1) * lanes * (live > 0)


def msm_field_ops(points: int, a_live: int, r_live: int, batch: int, chunk: int = MSM_CHUNK) -> dict:
    """Field squarings and multiplications that the kernel of
    `msm_accumulate` must do for one launch of `batch` rows, counted in its
    radix as `field_muls_per_signature` counts A1's: 255 sq + 20 mul to
    decompress each of `points` nonzero encodings; for each live point (a
    nonzero digit in its slot: `a_live` A points, `r_live` R points) its
    cached table, 127 mul (14 chain adds of 8 + 15 cache muls), and one
    8-mul cached add per window lane of its slot (64 for A, 32 for R); and
    for each lane of a slot with a live point, the chain tree's C - 1
    nine-mul adds. Zero rows (padding, the group lane's all-zero R slot)
    select the identity: the kernel runs them, the data does not need
    them, so they are not counted."""
    c = min(chunk, batch)
    sq = 255 * points
    mul = 20 * points + 127 * (a_live + r_live) + 8 * (MSM_WA * a_live + MSM_WR * r_live)
    mul += 9 * (c - 1) * (MSM_WA * (a_live > 0) + MSM_WR * (r_live > 0))
    return {"sq": sq, "mul": mul}


def msm_field_muls_per_signature(batch: int, chunk: int = MSM_CHUNK) -> dict:
    """`msm_field_ops` per row of a launch whose every row carries a live A
    and a live R point (the item lane's full bucket). `mul` is fractional
    through the row's share of the chain tree."""
    ops = msm_field_ops(2 * batch, batch, batch, batch, chunk)
    return {"sq": ops["sq"] / batch, "mul": ops["mul"] / batch}


# ---------------------------------------------------------------------------
# Host-side packing helpers (numpy, vectorized over the batch).
# ---------------------------------------------------------------------------


def bytes_to_limbs(raw: np.ndarray) -> np.ndarray:
    """[B, 32] uint8 little-endian -> [B, NLIMB] int32 (sign bit cleared):
    direct 3-byte gathers per limb (limb i = bits [13i, 13i+13))."""
    raw32 = np.zeros((raw.shape[0], 33), np.int32)  # +1 zero column for i=19
    raw32[:, :32] = raw
    raw32[:, 31] &= 0x7F
    out = np.empty((raw.shape[0], NLIMB), np.int32)
    for i in range(NLIMB):
        bit = RADIX * i
        b, shift = bit >> 3, bit & 7
        val = raw32[:, b] | (raw32[:, b + 1] << 8)
        if shift + RADIX > 16:
            val |= raw32[:, b + 2] << 16
        out[:, i] = (val >> shift) & MASK
    return out


def bytes_to_digits(raw: np.ndarray) -> np.ndarray:
    """[B, 32] uint8 little-endian scalars -> [B, WINDOWS] 4-bit digits MSB
    first."""
    hi = (raw >> 4).astype(np.int32)
    lo = (raw & 0xF).astype(np.int32)
    digits = np.stack([lo, hi], axis=2).reshape(-1, 64)  # LSB-first nibbles
    return digits[:, ::-1]
