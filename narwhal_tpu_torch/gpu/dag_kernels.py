"""The consensus commit walk and the causal reads as adjacency tensors, on
the card.

Port of `narwhal_tpu/tpu/dag_kernels.py` (the JAX package's counterpart):
the kernels `reach_mask` (B1), `roll_window` (B4), `place_batch` (B3) and
`chain_commit` (B2), the device-resident `DagWindow`, `GpuBullshark` and
`GpuTusk`, the counterparts of `TpuBullshark` and `TpuTusk`; and
`reach_many` (B6), the batched reach walk of the Dag service's coalesced
causal reads (`narwhal_tpu/consensus/dag.py` `_reach_k`).
`leader_support` (B5) and the mesh-sharded dispatch are later slices
(ROADMAP).

The window is dense tensors, exactly the JAX layout:
  present[W, N]    uint8 - certificate exists at (round offset, authority)
  parent [W, N, N] uint8 - parent[w, a, p] = cert (w, a) links (w-1, p)
  stakes [N]       int32

Each kernel has a plain PyTorch version (`*_plain`) in this module and a
hand-written CUDA kernel in `csrc/dag_window.cu`; the public function runs
the plain version on CPU tensors and launches the kernel on CUDA tensors
(or raises). `reach_mask` runs on the card as the device function
`reach_step` inside `chain_commit` and `reach_many`, so the public
`reach_mask` here is the plain version.

The JAX engine's background prewarm threads are not ported: they existed to
compile each new window shape ahead of need, and the CUDA kernels here take
the window shape as an argument, so they build once per process.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Committee
from ..consensus.state import ConsensusState
from ..stores import ConsensusStore
from ..types import Certificate, ConsensusOutput, Round, SequenceNumber
from . import HostCopy, kernel_registry, resolve_device

_SENTINEL = -(2**30)
_MAX_N = 1024  # chain_commit: one thread per authority column in one CTA


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


def roll_window(parent, present, shift: int):
    """`roll_window_plain` on CPU tensors; on CUDA tensors the
    `dag_window.cu` kernel into freshly allocated outputs."""
    shift = int(shift)
    if shift < 0:
        raise ValueError(f"roll_window: shift must be >= 0, got {shift}")
    if not _on_cuda("roll_window", parent):
        return roll_window_plain(parent, present, shift)
    W, N = present.shape
    dev = parent.device
    _check("parent", parent, torch.uint8, (W, N, N), dev)
    _check("present", present, torch.uint8, (W, N), dev)
    out_parent = torch.empty_like(parent)
    out_present = torch.empty_like(present)
    fn = kernel_registry.function("dag_window", "dag_window_roll_window", 4, 3)
    rc = fn(
        parent.data_ptr(), present.data_ptr(), out_parent.data_ptr(),
        out_present.data_ptr(), W, N, shift, _stream(dev),
    )
    kernel_registry.check("dag_window", "roll_window", rc)
    kernel_registry.count_launch("roll_window")
    return out_parent, out_present


def place_batch(parent, present, offs, idxs, rows, valid):
    """`place_batch_plain` on CPU tensors; on CUDA tensors the
    `dag_window.cu` scatter kernel. Both update the window in place and
    return it."""
    if not _on_cuda("place_batch", parent):
        return place_batch_plain(parent, present, offs, idxs, rows, valid)
    W, N = present.shape
    T = offs.shape[0]
    dev = parent.device
    _check("parent", parent, torch.uint8, (W, N, N), dev)
    _check("present", present, torch.uint8, (W, N), dev)
    _check("offs", offs, torch.int32, (T,), dev)
    _check("idxs", idxs, torch.int32, (T,), dev)
    _check("rows", rows, torch.uint8, (T, N), dev)
    _check("valid", valid, torch.uint8, (T,), dev)
    if T == 0:
        return parent, present
    fn = kernel_registry.function("dag_window", "dag_window_place_batch", 6, 3)
    rc = fn(
        parent.data_ptr(), present.data_ptr(), offs.data_ptr(), idxs.data_ptr(),
        rows.data_ptr(), valid.data_ptr(), W, N, T, _stream(dev),
    )
    kernel_registry.check("dag_window", "place_batch", rc)
    kernel_registry.count_launch("place_batch")
    return parent, present


def chain_commit(parent, present, gc_depth: int, lc_rel, lcr_rel: int, offs, onehots):
    """`chain_commit_plain` on CPU tensors; on CUDA tensors the one-CTA
    `dag_window.cu` kernel (reach_mask inside it as a device function)."""
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
    """`reach_many_plain` on CPU tensors; on CUDA tensors the
    `dag_window.cu` kernel, one CTA per walk (reach_mask's row step is the
    same device function as in `chain_commit`)."""
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


# ---------------------------------------------------------------------------
# The window and the engine.
# ---------------------------------------------------------------------------


class DagWindow:
    """Host-managed ring of the last W rounds as dense arrays, with the
    digest <-> (round, authority) maps the tensors can't hold, and a
    device-resident copy of the tensors (`narwhal_tpu.tpu.dag_kernels.
    DagWindow` with `device_resident=True`).

    Inserts buffer as pending coordinates and apply as ONE `place_batch`
    scatter at the next `device_view()`; a slid base applies as one
    `roll_window`; a full upload happens only on first use and after
    `_grow`."""

    def __init__(self, committee: Committee, window: int = 64, device=None):
        self.committee = committee
        self.device = resolve_device(device)
        self.N = committee.size()
        self.W = window
        self.round_base: Round = 0
        self.present = np.zeros((self.W, self.N), np.uint8)
        self.parent = np.zeros((self.W, self.N, self.N), np.uint8)
        self.stakes = np.asarray(committee.stakes_array(), np.int32)
        self.certs: dict[tuple[Round, int], Certificate] = {}
        self.digest_pos: dict = {}
        self._dev: tuple | None = None
        self._dev_base: Round = 0
        self._dev_stale = True
        self._dev_pending: list[tuple[Round, int]] = []
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
        self._dev_pending.append((cert.round, idx))

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
        mirror: pending placements as one power-of-two padded
        `place_batch`, a slid base as one `roll_window`."""
        if self._dev is None or self._dev_stale:
            self._dev = (self._upload(self.parent), self._upload(self.present))
            self._dev_base = self.round_base
            self._dev_stale = False
            self._dev_pending.clear()
            return self._dev
        parent, present = self._dev
        if self.round_base != self._dev_base:
            parent, present = roll_window(parent, present, self.round_base - self._dev_base)
            self._dev_base = self.round_base
        if self._dev_pending:
            # Rows come from the host mirror at sync time, so a placement's
            # final parent links are what lands on the device; entries GC'd
            # below the base since they were buffered are dropped.
            pend = [
                (r - self.round_base, i)
                for (r, i) in self._dev_pending
                if r >= self.round_base
            ]
            self._dev_pending.clear()
            if pend:
                k = len(pend)
                kpad = 1 if k <= 1 else 1 << (k - 1).bit_length()
                offs = np.zeros((kpad,), np.int32)
                idxs = np.zeros((kpad,), np.int32)
                rows = np.zeros((kpad, self.N), np.uint8)
                valid = np.zeros((kpad,), np.uint8)
                for t, (off, idx) in enumerate(pend):
                    offs[t] = off
                    idxs[t] = idx
                    rows[t] = self.parent[off, idx]
                    valid[t] = 1
                parent, present = place_batch(
                    parent, present, self._upload(offs), self._upload(idxs),
                    self._upload(rows), self._upload(valid),
                )
        self._dev = (parent, present)
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
    `narwhal_tpu.tpu.dag_kernels.TpuBullshark` (unmeshed), same
    process_certificate / process_batch / process_batch_async semantics.
    The host keeps the bookkeeping (commit rule, chain linkage, the final
    index -> certificate gather); each commit event is ONE `chain_commit`
    launch over the device-resident window."""

    def __init__(
        self,
        committee: Committee,
        store: ConsensusStore | None,
        gc_depth: Round,
        leader_fn=None,
        window: int | None = None,
        device=None,
    ):
        self.committee = committee
        self.store = store
        self.gc_depth = gc_depth
        self._leader_fn = leader_fn
        self.device = resolve_device(device)
        self.win = DagWindow(committee, window or (gc_depth + 14), device=self.device)

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
        W for it."""
        self.committee = new_committee
        self.win = DagWindow(new_committee, self.win.W, device=self.device)

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

        parent_op, present_op = self.win.device_view()
        masks = chain_commit(
            parent_op,
            present_op,
            self.gc_depth,
            self.win._upload(self._lc_rel(state)),
            state.last_committed_round - self.win.round_base,
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
