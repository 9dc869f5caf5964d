"""Generic compressed DAG: the `dag` crate rebuilt for a GC'd runtime.

Port copy of `narwhal_tpu/dag.py` (the JAX package's counterpart). The PyTorch
port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference: narwhal/dag/src/{lib,node_dag,bft}.rs — `NodeDag<T>` keeps
every vertex ever seen in one table (weak refs = interior/tombstones, strong
refs = heads), compresses paths through `compressible` vertices on access,
and drops bypassed vertices (their Arc count hits zero), leaving tombstones.

Python redesign: reference counting is replaced by explicit reachability —
a vertex is live iff a head reaches it through *compressed* parent edges.
`parents()` performs the same path compression (memoized by rewriting the
edge list); `sweep()` is the mark phase run from the heads, equivalent to the
drop cascade the Rust version gets for free from Arc. Heavy traversals over
the live window belong on device via the dense adjacency tensors
(narwhal_tpu_torch/gpu/dag_kernels.DagWindow); this structure is the bookkeeping
layer keeping arbitrary-shape history exactly like the reference.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Generic, Hashable, Iterator, Protocol, TypeVar

Digest = Hashable


class Affiliated(Protocol):
    """Minimum interface for DAG values (dag/src/node_dag.rs:19-28)."""

    @property
    def digest(self) -> Digest: ...

    def parents(self) -> list[Digest]: ...

    def compressible(self) -> bool: ...


T = TypeVar("T")


class UnknownDigests(Exception):
    def __init__(self, digests: list[Digest]):
        super().__init__(f"no vertex known by digests {digests!r}")
        self.digests = digests


class DroppedDigest(Exception):
    def __init__(self, digest: Digest):
        super().__init__(f"vertex {digest!r} was dropped (compressed away)")
        self.digest = digest


@dataclass
class _Node(Generic[T]):
    value: T
    parents: list[Digest]
    compressible: bool
    live: bool = True  # False = tombstone (weak ref that can't upgrade)


class NodeDag(Generic[T]):
    """Digest-keyed DAG with head tracking and path compression."""

    def __init__(self):
        self._nodes: dict[Digest, _Node[T]] = {}
        self._heads: set[Digest] = set()

    # -- queries ----------------------------------------------------------

    def contains(self, digest: Digest) -> bool:
        """Was this digest ever inserted (live or tombstone)?"""
        return digest in self._nodes

    def contains_live(self, digest: Digest) -> bool:
        node = self._nodes.get(digest)
        return node is not None and node.live

    def has_head(self, digest: Digest) -> bool:
        if digest not in self._nodes:
            raise UnknownDigests([digest])
        return digest in self._heads

    def head_digests(self) -> list[Digest]:
        return list(self._heads)

    def get(self, digest: Digest) -> T:
        node = self._nodes.get(digest)
        if node is None:
            raise UnknownDigests([digest])
        if not node.live:
            raise DroppedDigest(digest)
        return node.value

    def size(self) -> int:
        """Number of table entries, tombstones included (node_dag.rs:241)."""
        return len(self._nodes)

    def live_size(self) -> int:
        return sum(1 for n in self._nodes.values() if n.live)

    # -- mutation ---------------------------------------------------------

    def try_insert(self, value: Affiliated) -> None:
        """Insert a vertex whose parents are already known; idempotent.

        Parents that were dropped are skipped (the reference logs and
        continues); unknown parents raise UnknownDigests with the full list
        (node_dag.rs:156-227).
        """
        digest = value.digest
        if digest in self._nodes:
            return  # idempotence
        parent_digests = value.parents()
        missing = [d for d in parent_digests if d not in self._nodes]
        if missing:
            raise UnknownDigests(missing)
        kept = [d for d in parent_digests if self._nodes[d].live]
        self._nodes[digest] = _Node(
            value=value,
            parents=kept,
            compressible=bool(value.compressible()),
        )
        self._heads.add(digest)
        for d in kept:
            self._heads.discard(d)

    def make_compressible(self, digest: Digest) -> bool:
        """Mark for GC; returns False if already marked
        (node_dag.rs:139-142)."""
        node = self._nodes.get(digest)
        if node is None:
            raise UnknownDigests([digest])
        if not node.live:
            raise DroppedDigest(digest)
        was = node.compressible
        node.compressible = True
        return not was

    # -- compression ------------------------------------------------------

    def parents(self, digest: Digest) -> list[Digest]:
        """Compressed parents: closest incompressible (live) ancestors.

        Iterative path compression with memoization — every visited vertex's
        edge list is rewritten to the compressed form (dag/src/lib.rs:231-276;
        the rayon parallelism there is unnecessary here because results are
        memoized across the sweep's whole pass).
        """
        # Two-phase DFS: a vertex's edge list is rewritten only after every
        # compressible parent has been rewritten (true post-order; reversed
        # pre-order is NOT topological when ancestors are shared).
        opened: set[Digest] = set()
        stack: list[tuple[Digest, bool]] = [(digest, False)]
        while stack:
            d, ready = stack.pop()
            node = self._nodes[d]
            if ready:
                out: list[Digest] = []
                for p in node.parents:
                    pn = self._nodes.get(p)
                    if pn is None or not pn.live:
                        continue
                    if pn.compressible:
                        out.extend(pn.parents)  # rewritten already (post-order)
                    else:
                        out.append(p)
                node.parents = list(dict.fromkeys(out))  # dedup, stable
                continue
            if d in opened:
                continue
            opened.add(d)
            stack.append((d, True))
            for p in node.parents:
                pn = self._nodes.get(p)
                if pn is not None and pn.live and pn.compressible and p not in opened:
                    stack.append((p, False))
        return list(self._nodes[digest].parents)

    def sweep(self) -> int:
        """Drop vertices bypassed by compression: mark from the heads over
        compressed edges, tombstone the rest. Returns number dropped. (The
        Arc-drop cascade of the Rust version, made explicit.)"""
        reachable: set[Digest] = set()
        queue = deque(self._heads)
        while queue:
            d = queue.popleft()
            if d in reachable:
                continue
            reachable.add(d)
            for p in self.parents(d):
                queue.append(p)
        dropped = 0
        for d, node in self._nodes.items():
            if node.live and d not in reachable:
                node.live = False
                node.value = None  # type: ignore[assignment] # reclaim memory
                node.parents = []
                dropped += 1
        return dropped

    # -- traversal --------------------------------------------------------

    def bft(self, digest: Digest) -> Iterator[T]:
        """Breadth-first traversal over live vertices from `digest`
        (dag/src/bft.rs:57-127), following compressed edges."""
        self.get(digest)  # raises Unknown/Dropped like the reference
        seen: set[Digest] = set()
        queue = deque([digest])
        while queue:
            d = queue.popleft()
            if d in seen:
                continue
            seen.add(d)
            yield self._nodes[d].value
            for p in self.parents(d):
                if p not in seen:
                    queue.append(p)
