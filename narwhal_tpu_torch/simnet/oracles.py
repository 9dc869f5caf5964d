"""Safety and liveness oracles over a completed scenario.

Port copy of `narwhal_tpu/simnet/oracles.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Safety (the Narwhal/Bullshark guarantee under <= f byzantine stake): honest
nodes commit ONE total order. Nodes run at different speeds — and a
reconfiguration resets the sequence per epoch — so the checkable form is:
grouped by epoch, any two honest nodes' committed certificate sequences are
prefix-compatible (one is a prefix of the other). A single divergent entry
anywhere is a consensus split.

Liveness: committed rounds advance. The scenario runner snapshots per-node
committed rounds at every fault-plan event (`round_marks`), so "rounds
advance after heal" is `min over honest live nodes of (end - mark_at_heal)
>= min_rounds`.

Both raise AssertionError with enough context to debug the divergence — and
both snapshot every live/archived flight recorder first (tracing.on_anomaly),
so the pytest failure hook can attach the rings that led up to the violation.
"""

from __future__ import annotations


class OracleViolation(AssertionError):
    pass


def _violation(message: str) -> OracleViolation:
    """Build the violation AFTER parking flight-recorder dumps in the
    tracing archive: by the time an oracle runs, the scenario's nodes are
    torn down, so the archived rings are the only record of the run."""
    from .. import tracing

    tracing.on_anomaly(f"oracle: {message[:120]}")
    return OracleViolation(message)


def _by_epoch(seq):
    grouped: dict[int, list] = {}
    for epoch, round_, digest in seq:
        grouped.setdefault(epoch, []).append((round_, digest))
    return grouped


def assert_safety(commits, honest=None) -> None:
    """commits: per-node list of (epoch, round, digest) in commit order
    (SimCluster.commits). honest: node indices to check (default: all)."""
    nodes = sorted(honest) if honest is not None else range(len(commits))
    nodes = [i for i in nodes if i < len(commits)]
    for ai in nodes:
        for bi in nodes:
            if bi <= ai:
                continue
            a, b = _by_epoch(commits[ai]), _by_epoch(commits[bi])
            for epoch in set(a) & set(b):
                sa, sb = a[epoch], b[epoch]
                n = min(len(sa), len(sb))
                for k in range(n):
                    if sa[k] != sb[k]:
                        raise _violation(
                            f"SAFETY: nodes {ai} and {bi} disagree at epoch "
                            f"{epoch} commit #{k}: {sa[k]} vs {sb[k]} "
                            f"(sequences of {len(sa)} vs {len(sb)})"
                        )


def assert_liveness(
    end_rounds,
    baseline_rounds=None,
    min_rounds: float = 1.0,
    nodes=None,
) -> None:
    """Every selected node's committed round advanced by >= min_rounds over
    its baseline (a `round_marks` snapshot; default baseline 0)."""
    selected = sorted(nodes) if nodes is not None else range(len(end_rounds))
    for i in selected:
        base = baseline_rounds[i] if baseline_rounds is not None else 0.0
        progress = end_rounds[i] - base
        if progress < min_rounds:
            raise _violation(
                f"LIVENESS: node {i} advanced {progress} rounds "
                f"(from {base} to {end_rounds[i]}), needed >= {min_rounds}"
            )
