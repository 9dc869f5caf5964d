"""The consensus commit walk and the causal reads as adjacency tensors, on
the card.

Port of `narwhal_tpu/tpu/dag_kernels.py` (the JAX package's counterpart):
the kernels `reach_mask` (B1), `roll_window` (B4), `place_batch` (B3) and
`chain_commit` (B2), with B4 then B3 as one `sync_window` (the
`window_sync` kernel, which serves `roll_window` and `place_batch` too),
the device-resident `DagWindow`, `GpuBullshark` and
`GpuTusk`, the counterparts of `TpuBullshark` and `TpuTusk`; and
`reach_many` (B6), the batched reach walk of the Dag service's coalesced
causal reads (`narwhal_tpu/consensus/dag.py` `_reach_k`); `leader_support`
(B5) and `consensus_commit`, which with B6 make the consensus step of
`__graft_entry__.py` (B7, `consensus_step`); and the committee-axis
sharded walk of `--dag-shards` (`sharded_walk`, a walk set in one launch
per card, composed into `chain_commit_sharded`, `reach_many_sharded` and
`consensus_step_sharded` over a `mesh.DeviceMesh` on the route of its
topology), behind `GpuBullshark(mesh=...)`.

The window is dense tensors, exactly the JAX layout:
  present[W, N]    uint8 - certificate exists at (round offset, authority)
  parent [W, N, N] uint8 - parent[w, a, p] = cert (w, a) links (w-1, p)
  stakes [N]       int32

Each kernel has a plain PyTorch version (`*_plain`) in this module and a
hand-written CUDA kernel in `csrc/dag_window.cu`; the public function runs
the plain version on CPU tensors and launches the kernel on CUDA tensors
(or raises); `roll_window`, `place_batch` and `sync_window` share one
kernel, `window_sync`. `reach_mask` runs on the card inside `chain_commit` and
`reach_many` (walks over packed bits, `csrc/dag_walk_bits.cuh`) and as the
device function `reach_step` inside `sharded_walk`, so the public
`reach_mask` here is the plain version.

The JAX engine's background prewarm threads are not ported: they existed to
compile each new window shape ahead of need, and the CUDA kernels here take
the window shape as an argument, so they build once per process.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import Committee
from ..consensus.state import ConsensusState
from ..stores import ConsensusStore
from ..types import Certificate, ConsensusOutput, Round, SequenceNumber
from . import HostCopy, kernel_registry, resolve_device
from . import mesh as mesh_mod

_SENTINEL = -(2**30)
_MAX_N = 1024  # the walks' kernels: at most one thread per authority column in one CTA


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the JAX kernels' semantics, on any device).
# ---------------------------------------------------------------------------


def reach_mask(parent, uncommitted, start_off: int, start_onehot):
    """Reachability mask [W, N] bool: certificates reachable from the start
    certificate by walking parent links down the window, propagating only
    through uncommitted certificates.

    parent uint8 [W, N, N]; uncommitted [W, N] (present & not yet
    committed); start_off int round offset; start_onehot [N]."""
    W, N, _ = parent.shape
    start_off = int(start_off)
    unc = uncommitted.bool()
    start = start_onehot.bool()
    rows = torch.zeros((W, N), dtype=torch.bool, device=parent.device)
    frontier = torch.zeros((N,), dtype=torch.bool, device=parent.device)
    for w in range(W - 1, -1, -1):
        if w == start_off:
            here = start
        elif w < start_off:
            links = parent[min(w + 1, W - 1)].bool()  # [a, p]
            here = (links & frontier[:, None]).any(dim=0)
        else:
            here = torch.zeros_like(frontier)
        here = here & unc[w]
        rows[w] = here
        frontier = here
    return rows


def reach_many_plain(parent, uncommitted, offs, onehots):
    """K reach walks [K, W, N] bool: `reach_mask(parent, uncommitted,
    offs[k], onehots[k])` stacked over k (the JAX `_reach_k`, a vmap of
    reach_mask over the starts). A zero one-hot reaches nothing."""
    W, N, _ = parent.shape
    masks = [reach_mask(parent, uncommitted, off, onehot)
             for off, onehot in zip(offs.tolist(), onehots)]
    if not masks:
        return torch.zeros((0, W, N), dtype=torch.bool, device=parent.device)
    return torch.stack(masks, dim=0)


def _wrap32(x):
    """`x` (an int or an int64 tensor) as int32 arithmetic wraps it, as
    jnp.sum over int32 does."""
    return (x + 2**31) % 2**32 - 2**31


def leader_support_plain(parent, present, stakes, support_offs, leader_idxs):
    """Stake of the support-round voters for each leader, [B] int32: for
    walk b, the sum of stakes[a] over the a with parent[support_offs[b], a,
    leader_idxs[b]] and present[support_offs[b], a] set (the JAX
    `leader_support`, vmapped over b), summed with int32 wrap-around.

    parent [W, N, M] uint8 (M = N, or a shard's link columns), present
    [W, N], stakes [N]; the indices are taken as given (the wrapper checks
    them: `support_range_error`)."""
    offs = support_offs.long()
    links = parent[offs, :, leader_idxs.long()].bool()  # [B, N]
    voters = links & present[offs].bool()
    sums = torch.where(voters, stakes.long()[None, :], 0).sum(dim=1)
    return _wrap32(sums).to(torch.int32)


def consensus_commit_plain(masks, support, stakes, last_committed):
    """The tail of the consensus step: the walks whose leader has a quorum
    of support commit their masks, and each authority's last committed
    round advances to the newest round it commits in.

    masks [B, W, M] bool, support [B] int32, stakes [S] int32 (the whole
    committee: quorum = sum(stakes) // 3 + 1), last_committed [M] int32.
    Returns (committed [B, W, M] bool, new_last [M] int32), where new_last
    = max(last_committed, max over (b, w) of committed[b, w] * w), as
    `__graft_entry__.py` computes it (so at least 0 when B > 0)."""
    B, W, M = masks.shape
    quorum = _wrap32(int(stakes.long().sum())) // 3 + 1
    committed = masks & (support.long() >= quorum)[:, None, None]
    if B == 0 or W == 0:
        return committed, last_committed.clone()
    rows = torch.arange(W, dtype=torch.int32, device=masks.device)[None, :, None]
    best = (committed.to(torch.int32) * rows).amax(dim=(0, 1))
    return committed, torch.maximum(last_committed.to(torch.int32), best)


def sharded_walk_plain(parent, present, lc, offs, onehots, gc_depth: int = 0,
                       lcr_rel: int = _SENTINEL, chain: bool = True):
    """A whole walk set over the committee axis cut into `a` column blocks
    of m columns (Npad = a * m, the axis padded with absent slots): parent
    [a, W, Npad, m] uint8 (block i = parent[..., i*m:(i+1)*m]), present
    [a, W, m] uint8, lc [a, m] int32, offs [K] int32, onehots [K, Npad]
    uint8. Chain mode: `chain_commit_plain` over the K leaders (gc_depth,
    lcr_rel and lc as there); many mode (`chain=False`, lc unused):
    `reach_many_plain` with `present` as the uncommitted mask. Returns the
    masks in the same blocks, [a, K, W, m] bool."""
    a, W, npad, m = parent.shape
    K = offs.shape[0]
    full_parent = parent.permute(1, 2, 0, 3).reshape(W, npad, a * m)
    full_present = present.permute(1, 0, 2).reshape(W, a * m)
    if K == 0:
        masks = torch.zeros((0, W, a * m), dtype=torch.bool, device=parent.device)
    elif chain:
        masks = chain_commit_plain(full_parent, full_present, gc_depth, lc.reshape(a * m),
                                   lcr_rel, offs, onehots)
    else:
        masks = reach_many_plain(full_parent, full_present, offs, onehots)
    return masks.reshape(K, W, a, m).permute(2, 0, 1, 3).contiguous()


def roll_window_plain(parent, present, shift: int):
    """Slide the window by `shift` rounds: drop the oldest `shift` rows and
    zero the vacated tail. Returns new tensors."""
    W = present.shape[0]
    out_parent = torch.zeros_like(parent)
    out_present = torch.zeros_like(present)
    if shift < W:
        out_parent[: W - shift] = parent[shift:]
        out_present[: W - shift] = present[shift:]
    return out_parent, out_present


def place_batch_plain(parent, present, offs, idxs, rows, valid):
    """Apply the valid slots in order, in place: present[offs[t], idxs[t]] =
    1 and parent[offs[t], idxs[t], :] = rows[t]. Padded slots (valid=0) and
    slots outside the window are no-ops."""
    W, N = present.shape
    for t, (off, idx, v) in enumerate(zip(offs.tolist(), idxs.tolist(), valid.tolist())):
        if v and 0 <= off < W and 0 <= idx < N:
            parent[off, idx] = rows[t]
            present[off, idx] = 1
    return parent, present


def sync_window_plain(parent, present, shift: int, offs, idxs, rows):
    """`roll_window_plain`, then `place_batch_plain` of every slot (host
    arrays or tensors): the window a view rolls and places. Returns new
    tensors."""
    parent, present = roll_window_plain(parent, present, shift)
    offs, idxs, rows = (torch.as_tensor(x) for x in (offs, idxs, rows))
    valid = torch.ones(offs.shape, dtype=torch.uint8)
    return place_batch_plain(parent, present, offs, idxs, rows.to(parent.device), valid)


def chain_commit_plain(parent, present, gc_depth: int, lc_rel, lcr_rel: int, offs, onehots):
    """One commit event's chain flatten: for each leader (oldest first), its
    reach mask through the certificates still uncommitted at that point,
    the gc_depth filter, and the last-committed advance.

    Returns masks [K, W, N] bool: the post-GC commit set of each leader."""
    W, N, _ = parent.shape
    dev = parent.device
    rows = torch.arange(W, dtype=torch.int32, device=dev)[:, None]
    lc = lc_rel.to(torch.int32).clone()
    lcr = int(lcr_rel)
    present_b = present.bool()
    masks = []
    for off, onehot in zip(offs.tolist(), onehots):
        uncommitted = present_b & (rows > lc[None, :])
        mask = reach_mask(parent, uncommitted, off, onehot)
        keep = mask & (rows + int(gc_depth) >= lcr)
        committed = torch.where(keep, rows, torch.full_like(rows, _SENTINEL)).amax(dim=0)
        lc = torch.maximum(lc, committed)
        lcr = max(lcr, int(committed.max()))
        masks.append(keep)
    return torch.stack(masks, dim=0)


# ---------------------------------------------------------------------------
# Kernel wrappers: plain version on CPU tensors, the CUDA kernel on CUDA ones.
# ---------------------------------------------------------------------------


def _check(name: str, t, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} must be {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(kernel: str, t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {t.device}")
    return True


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# Event counts (kernel_registry.count_event) that bound window_sync's
# launches: the views that synced a window on the card, and the launches
# past a sync's first (a sync past one parameter block).
WINDOW_VIEWS = "window views"
SYNC_LAUNCHES_PAST_FIRST = "window_sync launches past a sync's first"


def sync_layout(W: int, N: int) -> tuple[int, int]:
    """The window_sync parameter block's layout at window W, N, from the
    kernel's library (`csrc/dag_window_sync.cuh`): (slots a launch carries,
    bits a slot). A sync of more slots takes more launches."""
    fn = kernel_registry.library("dag_window").dag_window_sync_layout
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    bits = np.zeros(1, np.int32)
    cap = fn(W, N, bits.ctypes.data)
    return cap, int(bits[0])


def _host(kernel: str, name: str, x, dtype):
    """A slot array as a contiguous host numpy array; on the card it
    raises (it is not read back)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{kernel}: {name} must be host data (numpy or a CPU tensor), "
                             f"got a tensor on {x.device}")
        x = x.numpy()
    return np.ascontiguousarray(x, dtype=dtype)


def _host_slots(kernel: str, offs, idxs, rows, n: int):
    """The slots as host arrays: offs int32 [T], idxs int32 [T], rows
    uint8 [T, n]."""
    offs, idxs = _host(kernel, "offs", offs, np.int32), _host(kernel, "idxs", idxs, np.int32)
    rows = _host(kernel, "rows", rows, np.uint8)
    T = offs.shape[0]
    if offs.shape != (T,) or idxs.shape != (T,) or rows.shape != (T, n):
        raise ValueError(f"{kernel}: slots must be offs [T], idxs [T], rows [T, {n}], got "
                         f"{offs.shape}, {idxs.shape}, {rows.shape}")
    return offs, idxs, rows


def _window_sync(kernel: str, parent, present, shift: int, offs, idxs, rows, in_place: bool,
                 chunk: int = 0, threads: int = 0):
    """The window_sync launches of one sync of CUDA tensors, the slots
    packed into the launches' parameters by the C entry point (which drops
    slots outside the window): the outputs are the inputs (in place, shift
    0; no launch without a slot inside the window) or two new tensors."""
    W, N = present.shape
    dev = parent.device
    _check("parent", parent, torch.uint8, (W, N, N), dev)
    _check("present", present, torch.uint8, (W, N), dev)
    if in_place:
        out = (parent, present)
    else:
        out = (torch.empty_like(parent), torch.empty_like(present))
    bits = np.packbits(rows, axis=1, bitorder="little")
    launches = np.zeros(1, np.int32)
    fn = kernel_registry.function("dag_window", "dag_window_window_sync", 8, 6)
    rc = fn(
        parent.data_ptr(), present.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        offs.ctypes.data, idxs.ctypes.data, bits.ctypes.data, launches.ctypes.data,
        W, N, min(shift, W), offs.shape[0], chunk, threads, _stream(dev),
    )
    n = int(launches[0])
    kernel_registry.count_launch("window_sync", n)
    if n > 1:
        kernel_registry.count_event(SYNC_LAUNCHES_PAST_FIRST, n - 1)
    kernel_registry.check("dag_window", kernel, rc)
    return out


def roll_window(parent, present, shift: int):
    """`roll_window_plain` on CPU tensors; on CUDA tensors one
    `window_sync` launch with no slots into freshly allocated outputs."""
    shift = int(shift)
    if shift < 0:
        raise ValueError(f"roll_window: shift must be >= 0, got {shift}")
    if not _on_cuda("roll_window", parent):
        return roll_window_plain(parent, present, shift)
    no = np.zeros(0, np.int32)
    rows = np.zeros((0, present.shape[1]), np.uint8)
    return _window_sync("roll_window", parent, present, shift, no, no, rows, in_place=False)


def place_batch(parent, present, offs, idxs, rows, valid):
    """`place_batch_plain` on CPU tensors; on CUDA tensors the valid slots
    as `window_sync` launches with shift 0 (one, up to `sync_layout`'s
    slots), none when no slot inside the window is valid. Both update the
    window in place and return it. The slot arrays are host data (numpy
    arrays or CPU tensors, as the JAX function's jit uploads them); arrays
    on the card raise."""
    if not _on_cuda("place_batch", parent):
        return place_batch_plain(parent, present,
                                 *(torch.as_tensor(x) for x in (offs, idxs, rows, valid)))
    offs, idxs, rows = _host_slots("place_batch", offs, idxs, rows, present.shape[1])
    valid = _host("place_batch", "valid", valid, np.uint8) != 0
    if valid.shape != offs.shape:
        raise ValueError(f"place_batch: valid must be [{offs.shape[0]}], got {valid.shape}")
    return _window_sync("place_batch", parent, present, 0, offs[valid], idxs[valid],
                        rows[valid], in_place=True)


def sync_window(parent, present, shift: int, offs, idxs, rows, *, chunk: int = 0,
                threads: int = 0):
    """Bring a device window up to its host mirror: `roll_window(shift)`,
    then the placements (offs[t], idxs[t]) <- rows[t], offsets relative to
    the rolled window, slots outside it dropped, duplicates carrying
    identical rows. `sync_window_plain` on CPU tensors; on CUDA tensors one
    `window_sync` launch (more only past `sync_layout`'s slots), none when
    it neither rolls nor places: out of place when it rolls, in place when
    it only places. The slot arrays are host data. `chunk` (bytes of a
    parent row a CTA) and `threads` (a CTA) set the launch's grid for
    measuring it; 0 takes the kernel's defaults."""
    shift = int(shift)
    if shift < 0:
        raise ValueError(f"sync_window: shift must be >= 0, got {shift}")
    N = present.shape[1]
    offs, idxs, rows = _host_slots("sync_window", offs, idxs, rows, N)
    if not _on_cuda("sync_window", parent):
        return sync_window_plain(parent, present, shift, offs, idxs, rows)
    return _window_sync("sync_window", parent, present, shift, offs, idxs, rows,
                        in_place=shift == 0, chunk=chunk, threads=threads)


def chain_commit(parent, present, gc_depth: int, lc_rel, lcr_rel: int, offs, onehots):
    """`chain_commit_plain` on CPU tensors; on CUDA tensors one launch of a
    one-CTA `dag_window.cu` kernel: the packed-bit walk of one warp (N <= 64
    with the window's tables in shared memory), else a thread per column
    and one barrier a row (any W, N <= 1024)."""
    if not _on_cuda("chain_commit", parent):
        return chain_commit_plain(parent, present, gc_depth, lc_rel, lcr_rel, offs, onehots)
    W, N = present.shape
    K = offs.shape[0]
    dev = parent.device
    if N > _MAX_N:
        raise ValueError(f"chain_commit: committee axis {N} > {_MAX_N}")
    _check("parent", parent, torch.uint8, (W, N, N), dev)
    _check("present", present, torch.uint8, (W, N), dev)
    _check("lc_rel", lc_rel, torch.int32, (N,), dev)
    _check("offs", offs, torch.int32, (K,), dev)
    _check("onehots", onehots, torch.uint8, (K, N), dev)
    masks = torch.empty((K, W, N), dtype=torch.bool, device=dev)
    if K == 0:
        return masks
    fn = kernel_registry.function("dag_window", "dag_window_chain_commit", 6, 5)
    rc = fn(
        parent.data_ptr(), present.data_ptr(), lc_rel.data_ptr(), offs.data_ptr(),
        onehots.data_ptr(), masks.data_ptr(), W, N, K, int(gc_depth), int(lcr_rel),
        _stream(dev),
    )
    kernel_registry.check("dag_window", "chain_commit", rc)
    kernel_registry.count_launch("chain_commit")
    return masks


def reach_many(parent, uncommitted, offs, onehots):
    """`reach_many_plain` on CPU tensors; on CUDA tensors one launch of a
    `dag_window.cu` kernel (`reach_route` says which): N <= 64 with the
    window's tables in shared memory, a CTA per 16 reads packs the window
    once and each of its 16 warps walks a read with B2's packed row step;
    else a CTA per read runs B2's wide walk."""
    if not _on_cuda("reach_many", parent):
        return reach_many_plain(parent, uncommitted, offs, onehots)
    W, N = uncommitted.shape
    K = offs.shape[0]
    dev = parent.device
    if N > _MAX_N:
        raise ValueError(f"reach_many: committee axis {N} > {_MAX_N}")
    _check("parent", parent, torch.uint8, (W, N, N), dev)
    _check("uncommitted", uncommitted, torch.uint8, (W, N), dev)
    _check("offs", offs, torch.int32, (K,), dev)
    _check("onehots", onehots, torch.uint8, (K, N), dev)
    masks = torch.empty((K, W, N), dtype=torch.bool, device=dev)
    if K == 0:
        return masks
    with torch.cuda.device(dev):
        fn = kernel_registry.function("dag_window", "dag_window_reach_many", 5, 3)
        rc = fn(
            parent.data_ptr(), uncommitted.data_ptr(), offs.data_ptr(),
            onehots.data_ptr(), masks.data_ptr(), W, N, K, _stream(dev),
        )
    kernel_registry.check("dag_window", "reach_many", rc)
    kernel_registry.count_launch("reach_many")
    return masks


def reach_route(W: int, N: int, device) -> str:
    """The route `reach_many` takes on `device`'s card for a window of W
    rows and N columns: "packed" or "wide"."""
    fn = kernel_registry.library("dag_window").dag_window_reach_route
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    with torch.cuda.device(device):
        r = fn(W, N)
    if r < 0:
        kernel_registry.check("dag_window", "reach_many route", -r)
    return "packed" if r == 1 else "wide"


def support_range_error(W: int, M: int, walk: int, off: int, leader: int) -> ValueError:
    """The error of a leader_support walk outside the window (offset not in
    [0, W)) or the link columns (leader not in [0, M)), named by the lowest
    such walk, on the CPU and on the card alike (jnp.take would fill or
    wrap it)."""
    return ValueError(f"leader_support: offsets must lie in [0, {W}) and leader indices in "
                      f"[0, {M}); walk {walk} has offset {off} and leader index {leader}")


_SUPPORT_LAYOUT: tuple[int, int] | None = None


def _support_layout() -> tuple[int, int]:
    """B5's walks a CTA and its error word's walk when none is out of range
    (`csrc/dag_support.cuh`)."""
    global _SUPPORT_LAYOUT
    if _SUPPORT_LAYOUT is None:
        fn = kernel_registry.library("dag_window").dag_window_leader_support_layout
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        none = np.zeros(1, np.int32)
        walks = fn(none.ctypes.data)
        _SUPPORT_LAYOUT = (walks, int(none[0]))
    return _SUPPORT_LAYOUT


def support_error(words, none: int) -> tuple[int, int, int] | None:
    """The lowest out-of-range walk of a leader_support launch, (walk,
    offset, leader), from its CTAs' error words (int32, 3 a CTA, as a
    list; `none` a word's walk when its CTA has none), or None."""
    bad = [tuple(words[i:i + 3]) for i in range(0, len(words), 3) if words[i] != none]
    return min(bad) if bad else None


def _leader_support(parent, present, stakes, support_offs, leader_idxs):
    """leader_support without the read of its error words: (support,
    check), check() raising on an out-of-range walk. On CPU tensors the
    range is checked first and the plain version runs; on CUDA tensors
    check() reads the launch's error words (one small device-to-host read),
    so a caller may queue more launches before it."""
    W, N, M = parent.shape
    B = support_offs.shape[0]
    if not _on_cuda("leader_support", parent):
        bad = ((support_offs < 0) | (support_offs >= W) | (leader_idxs < 0)
               | (leader_idxs >= M)).nonzero()
        if bad.numel():
            b = int(bad[0, 0])
            raise support_range_error(W, M, b, int(support_offs[b]), int(leader_idxs[b]))
        return (leader_support_plain(parent, present, stakes, support_offs, leader_idxs),
                lambda: None)
    dev = parent.device
    _check("parent", parent, torch.uint8, (W, N, M), dev)
    _check("present", present, torch.uint8, (W, N), dev)
    _check("stakes", stakes, torch.int32, (N,), dev)
    _check("support_offs", support_offs, torch.int32, (B,), dev)
    _check("leader_idxs", leader_idxs, torch.int32, (B,), dev)
    if B == 0:
        return torch.empty((0,), dtype=torch.int32, device=dev), lambda: None
    walks, none = _support_layout()
    buf = torch.empty((B + 3 * -(-B // walks),), dtype=torch.int32, device=dev)
    out, err = buf[:B], buf[B:]
    with torch.cuda.device(dev):
        fn = kernel_registry.function("dag_window", "dag_window_leader_support", 7, 4)
        rc = fn(
            parent.data_ptr(), present.data_ptr(), stakes.data_ptr(),
            support_offs.data_ptr(), leader_idxs.data_ptr(), out.data_ptr(), err.data_ptr(),
            W, N, M, B, _stream(dev),
        )
    kernel_registry.check("dag_window", "leader_support", rc)
    kernel_registry.count_launch("leader_support")

    def check():
        bad = support_error(err.tolist(), none)
        if bad is not None:
            raise support_range_error(W, M, *bad)
    return out, check


def leader_support(parent, present, stakes, support_offs, leader_idxs):
    """`leader_support_plain` on CPU tensors; on CUDA tensors the
    `dag_window.cu` kernel (a warp per walk, `csrc/dag_support.cuh`). B = 1
    is the JAX scalar call. Raises `support_range_error` on an offset
    outside the window or a leader index outside the link columns
    (jnp.take would fill or wrap them): on the CPU before the plain
    version runs, on the card from the kernel's error words, read after
    the launch with the result."""
    out, check = _leader_support(parent, present, stakes, support_offs, leader_idxs)
    check()
    return out


def consensus_commit(masks, support, stakes, last_committed):
    """`consensus_commit_plain` on CPU tensors; on CUDA tensors the
    `dag_window.cu` kernel: one launch of a cluster of up to 8 CTAs that
    stream the masks in 16-byte words and fold their column tables through
    distributed shared memory (`csrc/dag_commit.cuh`)."""
    if not _on_cuda("consensus_commit", masks):
        return consensus_commit_plain(masks, support, stakes, last_committed)
    B, W, M = masks.shape
    S = stakes.shape[0]
    dev = masks.device
    _check("masks", masks, torch.bool, (B, W, M), dev)
    _check("support", support, torch.int32, (B,), dev)
    _check("stakes", stakes, torch.int32, (S,), dev)
    _check("last_committed", last_committed, torch.int32, (M,), dev)
    if B * W * M >= 2**31:
        raise ValueError(f"consensus_commit: {B * W * M} mask bytes, the kernel takes < 2^31")
    committed = torch.empty_like(masks)
    new_last = torch.empty_like(last_committed)
    with torch.cuda.device(dev):
        fn = kernel_registry.function("dag_window", "dag_window_consensus_commit", 6, 4)
        rc = fn(
            masks.data_ptr(), support.data_ptr(), stakes.data_ptr(),
            last_committed.data_ptr(), committed.data_ptr(), new_last.data_ptr(),
            B, W, M, S, _stream(dev),
        )
    kernel_registry.check("dag_window", "consensus_commit", rc)
    kernel_registry.count_launch("consensus_commit")
    return committed, new_last


_WALK_TIMEOUT_MS = 5000  # the exchange routes' bound on each wait for the other cards
_MAX_CLUSTERS: dict[tuple, int] = {}  # (card, a, m, Npad) -> co-resident clusters


def sharded_walk(parent, present, lc, offs, onehots, gc_depth: int = 0,
                 lcr_rel: int = _SENTINEL, chain: bool = True, exchange=None, launch=None,
                 timeout_ms: int = _WALK_TIMEOUT_MS):
    """`sharded_walk_plain` on CPU tensors; on CUDA tensors the
    `dag_window.cu` kernel, a whole walk set in one launch per card.

    Without `exchange` (the "cluster" route) the operands are those of
    `sharded_walk_plain`, every block on one card, and the result its
    masks [a, K, W, m]: one launch, a thread-block cluster of a CTAs (a <=
    16) per walk set (chain mode) or per walk (many mode).

    With `exchange` (a `mesh.WalkExchange` on the "peer" or "host" route;
    card tensors only, the exchange has no plain form) parent, present and
    lc are lists, one entry per group of the exchange on the group's
    device: the blocks of its slots, [a_g, W, Npad, m] and so on; offs and
    onehots are lists of the whole arrays on each group's device. Every
    group's launch is issued on its own stream before any is waited on;
    the launches exchange frontier blocks and lcr candidates through the
    exchange's buffers (peer-mapped card memory, or pinned host memory
    every card maps). Returns one masks tensor [a_g, K, W, m] per group.
    A wait that outlasts `timeout_ms` makes the kernel stop and the
    call raise RuntimeError. `launch` (default every group) names the
    groups to launch: a test launches fewer to see a missing peer raise."""
    if exchange is None:
        if not _on_cuda("sharded_walk", parent):
            return sharded_walk_plain(parent, present, lc, offs, onehots, gc_depth, lcr_rel,
                                      chain)
        dev = parent.device
        a, W, npad, m = parent.shape
        K = offs.shape[0]
        if a * m != npad:
            raise ValueError(f"sharded_walk: {a} blocks of {m} columns do not cover {npad}")
        _check_walk(parent, present, lc, offs, onehots, a, W, npad, m, K, chain, dev)
        masks = torch.empty((a, K, W, m), dtype=torch.bool, device=dev)
        if K:
            _launch_walk(parent, present, lc, offs, onehots, masks, None, None, None, None,
                         W, npad, m, K, 0, 1 if chain else K, 0, a, gc_depth, lcr_rel, chain,
                         1, 0, 0, 0, torch.cuda.current_stream(dev))
        return masks
    if exchange.route not in ("peer", "host"):
        raise ValueError(f"sharded_walk: an exchange of the {exchange.route} route")
    if not _on_cuda("sharded_walk", parent[0]):
        raise ValueError(f"sharded_walk: the {exchange.route} form runs on the card only")
    return _sharded_walk_exchange(exchange, parent, present, lc, offs, onehots, gc_depth,
                                  lcr_rel, chain, launch, timeout_ms)


def _check_walk(parent, present, lc, offs, onehots, a, W, npad, m, K, chain, dev) -> None:
    if a > mesh_mod.MAX_CLUSTER or m > _MAX_N:
        raise ValueError(f"sharded_walk: {a} shards of {m} columns on {dev} (at most "
                         f"{mesh_mod.MAX_CLUSTER} of {_MAX_N})")
    _check("parent", parent, torch.uint8, (a, W, npad, m), dev)
    _check("present", present, torch.uint8, (a, W, m), dev)
    if chain:
        _check("lc", lc, torch.int32, (a, m), dev)
    _check("offs", offs, torch.int32, (K,), dev)
    _check("onehots", onehots, torch.uint8, (K, npad), dev)


def _launch_walk(parent, present, lc, offs, onehots, masks, slots, table, owner, err, W,
                 npad, m, K, k0, nk, nslots, a, gc_depth, lcr_rel, chain, G, g, gen,
                 timeout_ms, stream) -> None:
    """One card's launch (under its device); counts it. `nslots` is the
    walk slots the exchange buffers are laid out for (G > 1)."""
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(parent.device):
        fn = kernel_registry.function("dag_window", "dag_window_sharded_walk", 10, 15)
        rc = fn(
            parent.data_ptr(), present.data_ptr(), ptr(lc), offs.data_ptr(),
            onehots.data_ptr(), masks.data_ptr(), ptr(slots), ptr(table), ptr(owner),
            ptr(err), W, npad, m, K, k0, nk, nslots, a, int(gc_depth), int(lcr_rel),
            int(chain), G, g, gen - 2**32 if gen >= 2**31 else gen, int(timeout_ms),
            stream.cuda_stream,
        )
    kernel_registry.check("dag_window", "sharded_walk", rc)
    kernel_registry.count_launch("sharded_walk")


def _max_clusters(dev, a: int, m: int, npad: int) -> int:
    """How many clusters of `a` sharded_walk CTAs the card holds at once."""
    key = (dev, a, m, npad)
    if key not in _MAX_CLUSTERS:
        fn = kernel_registry.library("dag_window").dag_window_sharded_walk_max_clusters
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        with torch.cuda.device(dev):
            n = fn(a, m, npad)
        if n < 0:
            kernel_registry.check("dag_window", "sharded_walk occupancy", -n)
        _MAX_CLUSTERS[key] = n
    return _MAX_CLUSTERS[key]


def _sharded_walk_exchange(ex, parent, present, lc, offs, onehots, gc_depth, lcr_rel, chain,
                           launch, timeout_ms):
    """The exchange form ("peer", "host") on the card: every group's launch
    on its own stream,
    in waves of walks that fit on the cards at once (many mode), each wave
    waited on and its error words read before the next."""
    G = len(ex.groups)
    K = offs[0].shape[0]
    _a, W, npad, m = parent[0].shape
    if sum(len(s) for s in ex.groups) * m != npad:
        raise ValueError(f"sharded_walk: {len(ex.row)} blocks of {m} columns do not cover {npad}")
    for g, (slots, dev) in enumerate(zip(ex.groups, ex.devices)):
        _check_walk(parent[g], present[g], None if lc is None else lc[g], offs[g], onehots[g],
                    len(slots), W, npad, m, K, chain, dev)
    masks = [torch.empty((len(s), K, W, m), dtype=torch.bool, device=d)
             for s, d in zip(ex.groups, ex.devices)]
    if K == 0:
        return masks
    launch = list(range(G)) if launch is None else list(launch)
    # Spinning clusters must be co-resident: the walks a wave may hold on
    # every card, shared among the launches that land on the same card.
    sharing = {d: sum(ex.devices[g] == d for g in launch) for d in ex.devices}
    fit = min(_max_clusters(ex.devices[g], len(ex.groups[g]), m, npad)
              // sharing[ex.devices[g]] for g in launch)
    if fit < 1:
        raise RuntimeError(f"sharded_walk: the {ex.route} launches do not fit on their cards "
                           f"at once ({sharing} launches a card)")
    wave = 1 if chain else min(K, fit)
    st = ex.shared(wave, npad)
    span = K * W + 1 if chain else W  # exchange events a launch may use
    for k0 in range(0, 1 if chain else K, wave):
        nk = 1 if chain else min(wave, K - k0)
        launched, failure = [], None
        for g in launch:
            dev, stream = ex.devices[g], st["streams"][g]
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                st["errs"][g].zero_()
            try:
                _launch_walk(parent[g], present[g], None if lc is None else lc[g], offs[g],
                             onehots[g], masks[g], st["slots"][g], st["tables"][g],
                             st["owner"][g], st["errs"][g], W, npad, m, K, k0, nk,
                             st["nslots"], len(ex.groups[g]), gc_depth, lcr_rel, chain, G, g,
                             ex.gen, timeout_ms, stream)
            except RuntimeError as e:
                failure = e
                break
            launched.append(g)
        ex.gen = (ex.gen + span) % 2**32
        for g in launched:
            st["streams"][g].synchronize()
        if failure is not None:
            raise failure
        for g in launched:
            code, event = st["errs"][g].tolist()
            if code:
                raise RuntimeError(
                    f"sharded_walk: group {g} on {ex.devices[g]} waited more than "
                    f"{timeout_ms} ms for its peers at exchange event {event}")
    for g in launched:
        torch.cuda.current_stream(ex.devices[g]).wait_stream(st["streams"][g])
    return masks


def consensus_step(parent, uncommitted, stakes, offs, onehots, leaders, last_committed):
    """The per-validator consensus step of `__graft_entry__.py:229` (B7) on
    one device: B reach walks (`reach_many`), each leader's support
    (`leader_support`) and the quorum mask with the last-committed advance
    (`consensus_commit`). parent [W, N, N] uint8, uncommitted [W, N] uint8,
    stakes [N] int32, offs [B] int32, onehots [B, N] uint8, leaders [B]
    int32, last_committed [N] int32. Returns (committed [B, W, N] bool,
    support [B] int32, new_last [N] int32). On the card the three launches
    go out with no host wait between them; leader_support's error words are
    read after the last, and an out-of-range walk raises then."""
    masks = reach_many(parent, uncommitted, offs, onehots)
    support, check = _leader_support(parent, uncommitted, stakes, offs, leaders)
    committed, new_last = consensus_commit(masks, support, stakes, last_committed)
    check()
    return committed, support, new_last


# ---------------------------------------------------------------------------
# The committee-axis sharded walk: JAX's chain_commit and reach_mask under
# in-specs P(None, None, "auth"), P(None, "auth"), P("auth"). Each shard of
# an auth row of the mesh holds a block of the link columns. On every route
# (`mesh.walk_route`) a whole walk set is one `sharded_walk` launch per card
# (per group of the row's `WalkExchange`), the frontier blocks exchanged on
# the device: through a cluster's shared memory ("cluster"), peer-mapped
# card memory ("peer") or pinned host memory every card maps ("host"), the
# all-gather XLA inserts between rows.
# ---------------------------------------------------------------------------


class _Shards:
    """The column blocks of a window on one auth row of devices. The
    committee axis is padded to a multiple of the row's length with absent
    slots (no parent links, not present, zero stake), which reach nothing
    and relay nothing; `blocks(t)` cuts a host array's last axis into the
    blocks, stacked first."""

    def __init__(self, devices, n: int):
        self.devices = tuple(devices)
        a = len(self.devices)
        self.n = n
        self.npad = -(-n // a) * a
        self.m = self.npad // a

    def pad(self, arr, axes) -> np.ndarray:
        arr = np.asarray(arr)
        if self.npad == self.n:
            return np.ascontiguousarray(arr)
        width = [(0, self.npad - self.n if i in axes else 0) for i in range(arr.ndim)]
        return np.pad(arr, width)

    def blocks(self, arr) -> np.ndarray:
        """The blocks of the (padded) last axis stacked first: [a, ..., m]."""
        arr = np.asarray(arr)
        split = arr.reshape(*arr.shape[:-1], len(self.devices), self.m)
        return np.ascontiguousarray(np.moveaxis(split, -2, 0))

    def replicate(self, arr) -> list[torch.Tensor]:
        """`arr` on every shard's device, uploaded once per distinct device."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        ups: dict = {}
        for dev in self.devices:
            if dev not in ups:
                ups[dev] = host.to(dev)
        return [ups[dev] for dev in self.devices]

    def gather(self, blocks, dev, dim: int = -1) -> torch.Tensor:
        """The blocks joined along `dim` on `dev` (an all-gather's share)."""
        return torch.cat([b.to(dev) for b in blocks], dim=dim)


def _group_blocks(ex, shards: _Shards, blocked: np.ndarray) -> list[torch.Tensor]:
    """`blocked` [a, ...] as one tensor per group of `ex`, [a_g, ...] on the
    group's device: one upload per distinct device, each group a slice."""
    ups = {}
    for dev in dict.fromkeys(ex.devices):
        slots = [s for s, d in enumerate(shards.devices) if d == dev]
        part = blocked if len(slots) == len(blocked) else blocked[slots]
        ups[dev] = (torch.from_numpy(np.ascontiguousarray(part)).to(dev), slots)
    out = []
    for slots, dev in zip(ex.groups, ex.devices):
        t, order = ups[dev]
        i = order.index(slots[0])
        out.append(t[i:i + len(slots)])
    return out


def _walk_row(ex, shards: _Shards, parent, present, lc, offs, onehots, gc_depth: int,
              lcr_rel: int, chain: bool):
    """The walk set of one auth row through `sharded_walk` on ex.route: one
    launch when the row is one group ("cluster", or "host" on the CPU,
    where the plain version walks), else the exchange form, a launch a
    group; each operand uploaded once per card as one [a_g, ...] block
    tensor. Returns, per slot of the row, (masks [K, W, m], parent
    [W, Npad, m], present [W, m]) on the slot's device."""
    pg = _group_blocks(ex, shards, shards.blocks(shards.pad(parent, (1, 2))))
    qg = _group_blocks(ex, shards, shards.blocks(shards.pad(present, (1,))))
    lg = (None if lc is None else
          _group_blocks(ex, shards, shards.blocks(shards.pad(np.asarray(lc, np.int32), (0,)))))
    offs_r = shards.replicate(np.asarray(offs, np.int32))
    onehots_r = shards.replicate(shards.pad(np.asarray(onehots, np.uint8), (1,)))
    og = [offs_r[g[0]] for g in ex.groups]
    hg = [onehots_r[g[0]] for g in ex.groups]
    K, W = og[0].shape[0], qg[0].shape[1]
    if K == 0:
        masks = [torch.zeros((len(s), 0, W, shards.m), dtype=torch.bool, device=d)
                 for s, d in zip(ex.groups, ex.devices)]
    elif len(ex.groups) == 1:
        masks = [sharded_walk(pg[0], qg[0], None if lg is None else lg[0], og[0], hg[0],
                              gc_depth, lcr_rel, chain)]
    else:
        masks = sharded_walk(pg, qg, lg, og, hg, gc_depth, lcr_rel, chain, exchange=ex)
    return list(zip(_slot_views(ex, masks), _slot_views(ex, pg), _slot_views(ex, qg)))


def _slot_views(ex, per_group) -> list[torch.Tensor]:
    """Per-group tensors [a_g, ...] as one view per slot of the row."""
    out = [None] * len(ex.row)
    for g, slots in enumerate(ex.groups):
        for j, s in enumerate(slots):
            out[s] = per_group[g][j]
    return out


def chain_commit_sharded(mesh, parent, present, gc_depth: int, lc_rel, lcr_rel: int, offs,
                         onehots, route: str | None = None):
    """`chain_commit` (B2) with the committee axis sharded over the mesh's
    `auth` axis: each shard holds parent [W, N, N/a] (the link columns),
    present [W, N/a] and lc [N/a]; every leader's walk runs with the lc
    and lcr updates between leaders, all in one `sharded_walk` launch per
    card for the whole chain (per slot on a card repeated under a forced
    "peer" or "host" route). A `data` axis is replicated in JAX; here the
    first data row computes (the others would compute the same). `route`
    forces a route (the mesh's own by default).

    Operands are host arrays (numpy or CPU tensors), the full window, as
    the JAX dispatch takes numpy operands and places them by its in-specs;
    N need not divide the axis (absent slots pad it). Returns masks
    [K, W, N] bool on the mesh's first device, equal to `chain_commit`'s."""
    W, N = np.asarray(present).shape
    ex = mesh.walk(0, route)
    shards = _Shards(ex.row, N)
    walked = _walk_row(ex, shards, parent, present, lc_rel, offs, onehots, gc_depth,
                       int(lcr_rel), chain=True)
    return shards.gather([w[0] for w in walked], shards.devices[0])[..., :N]


def reach_many_sharded(mesh, parent, uncommitted, offs, onehots, route: str | None = None):
    """`reach_many` (B6) with the committee axis sharded over the mesh's
    `auth` axis (the first data row), with no lc, gc filter or update
    between walks: one cluster per walk of one `sharded_walk` launch per
    card, in waves that fit on the cards at once. Operands are host arrays;
    returns masks [K, W, N] bool on the mesh's first device, equal to
    `reach_many`'s."""
    ex = mesh.walk(0, route)
    shards = _Shards(ex.row, np.asarray(uncommitted).shape[1])
    masks_s = _reach_blocks(ex, shards, parent, uncommitted, offs, onehots)[0]
    return shards.gather(masks_s, shards.devices[0])[..., :shards.n]


def _reach_blocks(ex, shards: _Shards, parent, uncommitted, offs, onehots):
    """The sharded reach walks on one auth row: (the masks blocks
    [K, W, m], the parent blocks, the uncommitted blocks) of each shard."""
    walked = _walk_row(ex, shards, parent, uncommitted, None, offs, onehots, 0, _SENTINEL,
                       chain=False)
    return tuple([w[i] for w in walked] for i in range(3))


def consensus_step_sharded(mesh, parent, uncommitted, stakes, offs, onehots, leaders,
                           last_committed, route: str | None = None):
    """`consensus_step` (B7) over a `data x auth` mesh, the layout of
    `__graft_entry__.py:248`: the B walks split over the data rows, and on
    each row the committee axis over its auth shards. A row runs its walks
    as `reach_many_sharded` does (on the row's route, or `route`), each
    walk's support on the shard that holds its leader's column
    (`leader_support` on the shard's parent columns and the all-gathered
    uncommitted rows), and `consensus_commit` on every shard's block; the
    supports' error words are read after the commits, so an out-of-range
    offset raises then. new_last is the max over the data rows. Operands
    are host arrays; B must divide by the data axis. Returns (committed
    [B, W, N] bool, support [B] int32, new_last [N] int32) on the mesh's
    first device, equal to `consensus_step`'s."""
    rows = mesh.rows("auth")
    W, N = np.asarray(uncommitted).shape
    offs = np.asarray(offs, np.int32)
    onehots = np.asarray(onehots, np.uint8)
    leaders = np.asarray(leaders, np.int32)
    B = offs.shape[0]
    if B % len(rows):
        raise ValueError(f"consensus_step_sharded: {B} walks over {len(rows)} data rows")
    if B and (leaders.min() < 0 or leaders.max() >= N):
        raise ValueError(f"consensus_step_sharded: leader indices outside [0, {N})")
    bd = B // len(rows)
    first = rows[0][0]
    committed, support, new_last, checks = [], [], [], []
    for r in range(len(rows)):
        ex = mesh.walk(r, route)
        shards = _Shards(ex.row, N)
        b = slice(r * bd, (r + 1) * bd)
        masks_s, parent_s, unc_s = _reach_blocks(ex, shards, parent, uncommitted, offs[b],
                                                 onehots[b])
        stakes_s = shards.replicate(shards.pad(np.asarray(stakes, np.int32), (0,)))
        sup = torch.zeros((bd,), dtype=torch.int32, device=first)
        owner = leaders[b] // shards.m
        for i, dev in enumerate(shards.devices):
            mine = np.nonzero(owner == i)[0]
            if not mine.size:
                continue
            part, check = _leader_support(
                parent_s[i], shards.gather(unc_s, dev), stakes_s[i],
                torch.from_numpy(offs[b][mine]).to(dev),
                torch.from_numpy(leaders[b][mine] - i * shards.m).to(dev))
            checks.append(check)
            sup[torch.from_numpy(mine).to(first)] = part.to(first)
        last_s = _slot_views(ex, _group_blocks(ex, shards, shards.blocks(
            shards.pad(np.asarray(last_committed, np.int32), (0,)))))
        blocks, lasts = [], []
        for i, dev in enumerate(shards.devices):
            c, nl = consensus_commit(masks_s[i], sup.to(dev), stakes_s[i], last_s[i])
            blocks.append(c)
            lasts.append(nl)
        committed.append(shards.gather(blocks, first)[..., :N])
        support.append(sup)
        new_last.append(shards.gather(lasts, first)[:N])
    for check in checks:
        check()
    return (torch.cat(committed), torch.cat(support),
            torch.stack(new_last).amax(dim=0))


# ---------------------------------------------------------------------------
# The window and the engine.
# ---------------------------------------------------------------------------


class DagWindow:
    """Host-managed ring of the last W rounds as dense arrays, with the
    digest <-> (round, authority) maps the tensors can't hold, and a
    device-resident copy of the tensors (`narwhal_tpu.tpu.dag_kernels.
    DagWindow` with `device_resident=True`).

    Inserts buffer as pending coordinates; the next `device_view()` applies
    them and a slid base as ONE `sync_window` (one `window_sync` launch on
    the card, the slots in its parameters); a full upload happens only on
    first use and after `_grow`.

    `pad_authorities_to` widens the committee axis with always-absent slots
    (not present, zero stake) so that it divides a mesh's `auth` axis; they
    never hold certificates, relay reachability or carry stake. A window
    with `device_resident=False` (a meshed engine's: the sharded walk
    uploads its operands from the host mirror itself) keeps no device copy
    and buffers no placements."""

    def __init__(self, committee: Committee, window: int = 64, device=None,
                 pad_authorities_to: int | None = None, device_resident: bool = True):
        self.committee = committee
        self.device = resolve_device(device)
        n = committee.size()
        self.N = max(n, pad_authorities_to or 0)
        self.W = window
        self.round_base: Round = 0
        self.present = np.zeros((self.W, self.N), np.uint8)
        self.parent = np.zeros((self.W, self.N, self.N), np.uint8)
        self.stakes = np.zeros((self.N,), np.int32)
        self.stakes[:n] = np.asarray(committee.stakes_array(), np.int32)
        self._dev_resident = device_resident
        self.certs: dict[tuple[Round, int], Certificate] = {}
        self.digest_pos: dict = {}
        self._dev: tuple | None = None
        self._dev_base: Round = 0
        self._dev_stale = True
        self._dev_pending: list[int] = []  # round, idx, round, idx, ...
        # Genesis certificates occupy round 0.
        for cert in Certificate.genesis(committee):
            self._place(cert)

    def _off(self, round: Round) -> int:
        return round - self.round_base

    def _place(self, cert: Certificate) -> None:
        idx = self.committee.index_of(cert.origin)
        off = self._off(cert.round)
        self.present[off, idx] = 1
        self.certs[(cert.round, idx)] = cert
        self.digest_pos[cert.digest] = (cert.round, idx)
        for pd in cert.header.parents:
            pos = self.digest_pos.get(pd)
            if pos is not None and pos[0] == cert.round - 1:
                self.parent[off, idx, pos[1]] = 1
        if self._dev_resident:
            self._dev_pending += (cert.round, idx)

    def insert(self, cert: Certificate, keep_floor: Round) -> bool:
        """Add a certificate; slides the window forward (dropping only rounds
        below keep_floor, the GC bound) or grows it when commits lag behind
        round production. Returns False only for certificates below the
        already-GC'd base."""
        if cert.round < self.round_base:
            return False
        while cert.round - self.round_base >= self.W:
            target = cert.round - self.W + 1
            if target <= keep_floor:
                self.slide_to(target)
            elif keep_floor > self.round_base:
                self.slide_to(keep_floor)
                self._grow()
            else:
                self._grow()
        self._place(cert)
        return True

    def _grow(self) -> None:
        """Double W (the next device_view re-uploads at the new shape)."""
        new_w = self.W * 2
        present = np.zeros((new_w, self.N), np.uint8)
        parent = np.zeros((new_w, self.N, self.N), np.uint8)
        present[: self.W] = self.present
        parent[: self.W] = self.parent
        self.present, self.parent, self.W = present, parent, new_w
        self._dev_stale = True

    def slide_to(self, new_base: Round) -> None:
        shift = new_base - self.round_base
        if shift <= 0:
            return
        if shift >= self.W:
            self.present[:] = 0
            self.parent[:] = 0
        else:
            self.present[:-shift] = self.present[shift:]
            self.present[-shift:] = 0
            self.parent[:-shift] = self.parent[shift:]
            self.parent[-shift:] = 0
        dropped = [(r, i) for (r, i) in self.certs if r < new_base]
        for key in dropped:
            cert = self.certs.pop(key)
            self.digest_pos.pop(cert.digest, None)
        self.round_base = new_base

    def cert_at(self, round: Round, idx: int) -> Certificate | None:
        return self.certs.get((round, idx))

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the device (never a view of the host
        mirror, which slides in place)."""
        return torch.tensor(np.ascontiguousarray(arr), device=self.device)

    def device_view(self):
        """The (parent, present) tensors on the device, synced to the host
        mirror: a slid base and the pending placements as one `sync_window`
        (one `window_sync` launch on the card, more only past `sync_layout`'s
        slots; none when the view neither rolls nor places)."""
        if self._dev is None or self._dev_stale:
            self._dev = (self._upload(self.parent), self._upload(self.present))
            self._dev_base = self.round_base
            self._dev_stale = False
            self._dev_pending.clear()
            return self._dev
        shift = self.round_base - self._dev_base
        pend = np.array(self._dev_pending, np.int32).reshape(-1, 2)  # (round, idx) a row
        offs = pend[:, 0] - np.int32(self.round_base)
        live = offs >= 0  # entries GC'd below the base since they were buffered
        if not live.all():
            pend, offs = pend[live], offs[live]
        if shift or offs.size:
            # Rows come from the host mirror at sync time, so a placement's
            # final parent links are what lands on the device.
            idxs = pend[:, 1]
            self._dev = sync_window(*self._dev, shift, offs, idxs, self.parent[offs, idxs])
            self._dev_base = self.round_base
            if self.device.type == "cuda":
                kernel_registry.count_event(WINDOW_VIEWS)
        self._dev_pending.clear()
        return self._dev


def window_from_numpy(
    arrays: dict, committee: Committee, device=None, certificates=()
) -> tuple[DagWindow, ConsensusState]:
    """The port's window and consensus state rebuilt from plain numpy
    arrays, so that a port engine (`GpuBullshark.from_window`) continues
    exactly where a JAX `TpuBullshark` stopped.

    arrays: `parent` [W, N, N] u8, `present` [W, N] u8 and `stakes` [N] i32
    (the JAX window's tensors), `round_base` (int) and `last_committed`
    [N] int, each authority's last committed round in committee order.
    certificates: the certificates of the window's present slots, as the
    port's own objects (rebuild them from the wire bytes), one per slot:
    the index -> certificate map the tensors cannot hold."""
    parent = np.array(arrays["parent"], dtype=np.uint8)
    present = np.array(arrays["present"], dtype=np.uint8)
    stakes = np.asarray(arrays["stakes"], dtype=np.int32)
    lc = np.asarray(arrays["last_committed"], dtype=np.int64)
    W, N = present.shape
    if parent.shape != (W, N, N) or stakes.shape != (N,) or lc.shape != (N,):
        raise ValueError(
            f"window arrays disagree: parent {parent.shape}, present "
            f"{present.shape}, stakes {stakes.shape}, last_committed {lc.shape}"
        )
    if N != committee.size() or not np.array_equal(
        stakes, np.asarray(committee.stakes_array(), np.int32)
    ):
        raise ValueError("window stakes disagree with the committee")
    base = int(arrays["round_base"])
    win = DagWindow(committee, W, device=device)
    win.round_base = base
    win.parent, win.present = parent, present
    win.certs, win.digest_pos = {}, {}
    for cert in certificates:
        idx = committee.index_of(cert.origin)
        off = cert.round - base
        if not (0 <= off < W and present[off, idx]):
            raise ValueError(f"certificate ({cert.round}, {idx}) has no present slot")
        win.certs[(cert.round, idx)] = cert
        win.digest_pos[cert.digest] = (cert.round, idx)
    if len(win.certs) != int(present.sum()):
        raise ValueError("every present slot needs its certificate")
    win._dev, win._dev_stale, win._dev_pending = None, True, []

    keys = committee.authority_keys()
    state = ConsensusState(Certificate.genesis(committee))
    state.last_committed = {keys[i]: int(lc[i]) for i in range(N)}
    state.last_committed_round = int(lc.max())
    state.dag = {}
    for (r, idx), cert in sorted(win.certs.items()):
        if r >= state.last_committed[keys[idx]]:
            state.add(cert)
    return win, state


class GpuBullshark:
    """Bullshark with the DAG walks on the card: the counterpart of
    `narwhal_tpu.tpu.dag_kernels.TpuBullshark`, same process_certificate(_async)
    / process_batch(_async) / recover semantics. The host keeps the
    bookkeeping (commit rule, chain linkage, the final index -> certificate
    gather); each commit event is ONE `chain_commit` launch over the
    device-resident window.

    With `mesh` (a `mesh.DeviceMesh` with an `auth` axis, `--dag-shards`)
    each commit event is `chain_commit_sharded` instead: the committee axis
    of the window split over the auth devices, padded to a multiple of the
    axis with absent slots. The meshed window stays on the host (the walk
    uploads each shard's columns itself), so `window_sync` does not run;
    `device` is then the mesh's first device."""

    def __init__(
        self,
        committee: Committee,
        store: ConsensusStore | None,
        gc_depth: Round,
        leader_fn=None,
        window: int | None = None,
        device=None,
        mesh=None,
    ):
        self.committee = committee
        self.store = store
        self.gc_depth = gc_depth
        self._leader_fn = leader_fn
        if mesh is not None:
            device = mesh.rows("auth")[0][0]  # ConfigError without an auth axis
        self.mesh = mesh
        self.device = resolve_device(device)
        self.win = self._window(committee, window or (gc_depth + 14))

    def _window(self, committee: Committee, w: int) -> DagWindow:
        pad = None
        if self.mesh is not None:
            auth = self.mesh.shape["auth"]
            pad = -(-committee.size() // auth) * auth
        return DagWindow(committee, w, device=self.device, pad_authorities_to=pad,
                         device_resident=self.mesh is None)

    @classmethod
    def from_window(
        cls, win: DagWindow, store: ConsensusStore | None, gc_depth: Round,
        leader_fn=None,
    ) -> "GpuBullshark":
        """An engine over an existing window (see `window_from_numpy`)."""
        eng = cls.__new__(cls)
        eng.committee = win.committee
        eng.store = store
        eng.gc_depth = gc_depth
        eng._leader_fn = leader_fn
        eng.mesh = None
        eng.device = win.device
        eng.win = win
        return eng

    def recover(self, state: ConsensusState) -> None:
        """Rebuild the window from a recovered host state (the consensus
        runner's ConsensusState.new_from_store) so a restarted node resumes
        committing from the on-disk DAG. Insertion is round-ascending
        because parent links resolve against already-placed digests."""
        keep_floor = max(0, state.last_committed_round - self.gc_depth)
        for round in sorted(state.dag):
            for _, cert in state.dag[round].values():
                self.win.insert(cert, keep_floor)

    def update_committee(self, new_committee: Committee) -> None:
        """A new committee (epoch change): a fresh, empty window of the same
        W for it (padded anew for a meshed engine)."""
        self.committee = new_committee
        self.win = self._window(new_committee, self.win.W)

    # -- leader election --------------------------------------------------
    def _leader_index(self, round: Round, dag) -> int | None:
        if self._leader_fn is not None:
            entry = self._leader_fn(self.committee, round, dag)
            if entry is None:
                return None
            return self.committee.index_of(entry[1].origin)
        name = self.committee.leader(round)
        idx = self.committee.index_of(name)
        off = self.win._off(round)
        if 0 <= off < self.win.W and self.win.present[off, idx]:
            return idx
        return None

    # -- host bookkeeping -------------------------------------------------
    def _linked_np(self, round: Round, idx: int, prev_round: Round, prev_idx: int) -> bool:
        """Chain linkage between consecutive even-round leaders: a 2-round
        frontier propagation over the numpy parent mirror."""
        frontier = np.zeros((self.win.N,), bool)
        frontier[idx] = True
        for rr in range(round, prev_round, -1):
            off = self.win._off(rr)
            if not (0 <= off < self.win.W):
                return False
            links = self.win.parent[off]
            frontier = (links[frontier].any(axis=0)) & self.win.present[
                self.win._off(rr - 1)
            ].astype(bool)
            if not frontier.any():
                return False
        return bool(frontier[prev_idx])

    def _lc_rel(self, state: ConsensusState) -> np.ndarray:
        lc = np.zeros((self.win.N,), np.int32)
        for pk, r in state.last_committed.items():
            lc[self.committee.index_of(pk)] = r
        return lc - np.int32(self.win.round_base)

    # -- protocol ---------------------------------------------------------
    def process_certificate(
        self, state: ConsensusState, consensus_index: SequenceNumber,
        certificate: Certificate,
    ) -> list[ConsensusOutput]:
        self._ingest(state, certificate)
        dispatch = self._eval_commit(state, certificate.round)
        if dispatch is None:
            return []
        readback, K = dispatch
        return self._materialize(state, consensus_index, readback.result()[0], K)

    async def process_certificate_async(
        self, state: ConsensusState, consensus_index: SequenceNumber,
        certificate: Certificate,
    ) -> list[ConsensusOutput]:
        """process_certificate with the readback awaited off-thread, so the
        node's event loop keeps running during the device->host wait. The
        consensus runner takes it for a lone certificate; events stay
        serialized because the runner awaits each certificate in order."""
        import asyncio

        self._ingest(state, certificate)
        dispatch = self._eval_commit(state, certificate.round)
        if dispatch is None:
            return []
        readback, K = dispatch
        (masks,) = await asyncio.get_running_loop().run_in_executor(None, readback.result)
        return self._materialize(state, consensus_index, masks, K)

    def _commit_coords(self, round: Round) -> tuple[Round, Round] | None:
        """Bullshark rule: on a round-r+1 certificate the candidate leader
        sits at even round r, supported by round r+1."""
        r = round - 1
        if r % 2 != 0 or r < 2:
            return None
        return r, round

    def _ingest(self, state: ConsensusState, certificate: Certificate) -> None:
        state.add(certificate)
        keep_floor = max(0, state.last_committed_round - self.gc_depth)
        if not self.win.insert(certificate, keep_floor):
            raise RuntimeError(
                f"round {certificate.round} outside DAG window "
                f"(base {self.win.round_base}, W {self.win.W})"
            )

    def _eval_commit(self, state: ConsensusState, round: Round):
        coords = self._commit_coords(round)
        if coords is None:
            return None
        leader_round, support_round = coords
        if leader_round <= state.last_committed_round:
            return None
        leader_idx = self._leader_index(leader_round, state.dag)
        if leader_idx is None:
            return None
        return self._dispatch_commit(state, leader_round, support_round, leader_idx)

    def process_batch(
        self, state: ConsensusState, consensus_index: SequenceNumber,
        certificates: list[Certificate],
    ) -> list[ConsensusOutput]:
        """All inserts land as ONE device scatter, the commit rule is
        evaluated per trigger in arrival order, and each commit event's
        readback is deferred one event so it overlaps the next event's host
        bookkeeping. Output-identical to per-certificate calls on the same
        causally ordered stream."""
        for cert in certificates:
            self._ingest(state, cert)
        outputs: list[ConsensusOutput] = []
        pending = None
        for cert in certificates:
            if self._commit_coords(cert.round) is None:
                continue
            if pending is not None:
                readback, K = pending
                outs = self._materialize(state, consensus_index, readback.result()[0], K)
                consensus_index += len(outs)
                outputs.extend(outs)
            pending = self._eval_commit(state, cert.round)
        if pending is not None:
            readback, K = pending
            outputs.extend(self._materialize(state, consensus_index, readback.result()[0], K))
        return outputs

    async def process_batch_async(
        self, state: ConsensusState, consensus_index: SequenceNumber,
        certificates: list[Certificate],
    ) -> list[ConsensusOutput]:
        """process_batch with each deferred readback awaited off-thread, so
        the event loop keeps running during every device->host wait."""
        import asyncio

        loop = asyncio.get_running_loop()
        for cert in certificates:
            self._ingest(state, cert)
        outputs: list[ConsensusOutput] = []
        pending = None
        for cert in certificates:
            if self._commit_coords(cert.round) is None:
                continue
            if pending is not None:
                readback, K = pending
                (masks,) = await loop.run_in_executor(None, readback.result)
                outs = self._materialize(state, consensus_index, masks, K)
                consensus_index += len(outs)
                outputs.extend(outs)
            pending = self._eval_commit(state, cert.round)
        if pending is not None:
            readback, K = pending
            (masks,) = await loop.run_in_executor(None, readback.result)
            outputs.extend(self._materialize(state, consensus_index, masks, K))
        return outputs

    def _dispatch_commit(self, state, r, support_round, leader_idx):
        """Quorum pre-check + chain detection on the host mirror, then ONE
        `chain_commit` launch for every flatten walk of the commit event.
        Returns (readback, chain length) or None."""
        off_r = self.win._off(support_round)
        voters = self.win.parent[off_r, :, leader_idx].astype(bool) & self.win.present[
            off_r
        ].astype(bool)
        support = int(self.win.stakes[voters].sum())
        if support < self.committee.validity_threshold():
            return None

        chain: list[tuple[Round, int]] = [(r, leader_idx)]
        cur_round, cur_idx = r, leader_idx
        for lr in range(r - 2, state.last_committed_round + 1, -2):
            prev_idx = self._leader_index(lr, state.dag)
            if prev_idx is None:
                continue
            if self._linked_np(cur_round, cur_idx, lr, prev_idx):
                chain.append((lr, prev_idx))
                cur_round, cur_idx = lr, prev_idx

        # Power-of-two chain buckets, as the JAX engine pads them: zero
        # one-hot slots are no-ops.
        chain = list(reversed(chain))  # oldest first, scan order
        K = len(chain)
        Kpad = 1
        while Kpad < K:
            Kpad *= 2
        offs = np.zeros((Kpad,), np.int32)
        onehots = np.zeros((Kpad, self.win.N), np.uint8)
        for i, (lr, lidx) in enumerate(chain):
            offs[i] = self.win._off(lr)
            onehots[i, lidx] = 1

        lcr_rel = state.last_committed_round - self.win.round_base
        if self.mesh is not None:
            # The window's shape is read at each call, so a grown window is
            # walked at its new W over the same mesh.
            masks = chain_commit_sharded(
                self.mesh, self.win.parent, self.win.present, self.gc_depth,
                self._lc_rel(state), lcr_rel, offs, onehots,
            )
            return HostCopy(masks), K
        parent_op, present_op = self.win.device_view()
        masks = chain_commit(
            parent_op,
            present_op,
            self.gc_depth,
            self.win._upload(self._lc_rel(state)),
            lcr_rel,
            self.win._upload(offs),
            self.win._upload(onehots),
        )
        return HostCopy(masks), K

    def _materialize(
        self, state: ConsensusState, consensus_index: SequenceNumber, masks, K: int
    ) -> list[ConsensusOutput]:
        """Gather certificates from the per-leader commit masks, update the
        host recovery state and persist, in canonical (round, origin) order."""
        sequence: list[ConsensusOutput] = []
        for k in range(K):
            order = np.argwhere(masks[k])  # ascending (offset, authority)
            for off, aidx in order:
                cert = self.win.cert_at(self.win.round_base + int(off), int(aidx))
                if cert is None:
                    continue
                state.update(cert, self.gc_depth)
                sequence.append(
                    ConsensusOutput(certificate=cert, consensus_index=consensus_index)
                )
                consensus_index += 1
                if self.store is not None:
                    self.store.write_consensus_state(
                        state.last_committed, consensus_index - 1, cert.digest
                    )
        return sequence


class GpuTusk(GpuBullshark):
    """Tusk with the DAG walks on the card: identical machinery to
    GpuBullshark, the asynchronous commit rule (tusk.rs:47-82): a round-r
    certificate (r-1 even, r-1 >= 4) makes the leader at round r-3 a commit
    candidate, supported by its children at round r-2 carrying >= f+1
    stake. Drop-in for consensus.Tusk; the counterpart of `TpuTusk`."""

    def _commit_coords(self, round: Round) -> tuple[Round, Round] | None:
        r = round - 1
        if r % 2 != 0 or r < 4:
            return None
        return r - 2, r - 1
