"""FaultPlan fuzzer: seeded random fault schedules under the oracles.

Port copy of `narwhal_tpu/simnet/fuzz.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

The simnet perf work (co-hosted crypto plane, batched fabric delivery,
inline frame drains) exists to buy adversarial COVERAGE: a 4-node seeded
scenario now costs a few wall seconds, so instead of a handful of
hand-written plans the repo can sweep hundreds of randomly drawn
crash/partition/jitter/equivocation/reconfiguration schedules per run and
hold every one to the safety + liveness oracles.

Three pieces:

* `generate_plan(seed)` — a deterministic draw from the FaultPlan DSL
  (simnet/plan.py). Plans are quorum-survivable by construction: at most
  f = (n-1)//3 nodes are byzantine or permanently crashed, partitions
  always heal, and every disruption resolves with enough virtual runway
  left that the end-of-run liveness check is a real assertion rather than
  a coin flip. The generator seeds `random.Random` with a string (seed
  derivation is PYTHONHASHSEED-independent), so seed k names the same
  plan on every host.

* `check_plan(plan)` — run the scenario, then `assert_safety` over honest
  commits and `assert_liveness` over honest non-crashed nodes. Any
  exception out of the scenario itself (a SimDeadlockError, a protocol
  crash) is a finding too, not a fuzzer error.

* `shrink(plan, still_fails)` — minimize a failing plan to a reproducer:
  a greedy event-deletion pass (drop any event whose removal keeps the
  plan failing) followed by a parameter-halving pass (pull times and link
  conditions toward their defaults while the plan still fails). Bounded
  by `max_checks` re-runs so shrinking a flaky failure terminates.

`run_campaign` drives N seeds, shrinks every failure, and returns one
JSON-able payload; the CLI (`python -m narwhal_tpu_torch.simnet.fuzz`)
prints a line a seed and writes the payload only to its `--out` file.
The campaign's scenarios run on the port `Cluster`'s backends: the card
unless `--crypto-backend` / `--dag-backend` say otherwise (a programmatic
caller may also pass `device=` to `run_campaign`).
"""

from __future__ import annotations

import random
import time
from dataclasses import asdict, replace

from .oracles import OracleViolation, assert_liveness, assert_safety
from .plan import (
    Crash,
    Equivocate,
    FaultPlan,
    LinkFault,
    LinkSpec,
    Partition,
    Reconfigure,
)
from .scenario import run_scenario

# Virtual seconds a disruption must leave between its resolution and the
# scenario end so healed/restarted nodes can demonstrably make progress.
_RUNWAY = 1.2


def generate_plan(seed: int, nodes: int = 4, duration: float = 2.5) -> FaultPlan:
    """Draw one quorum-survivable FaultPlan, deterministically from seed."""
    rng = random.Random(f"narwhal-fuzz-{seed}")
    f = max(0, (nodes - 1) // 3)
    fault_budget = f  # nodes allowed byzantine or permanently down
    safe_end = max(0.6, duration - _RUNWAY)

    default_link = _draw_default_link(rng)
    events: list = []
    used_nodes: set[int] = set()
    have_partition = False
    have_reconfigure = False
    have_restart = False
    for _ in range(rng.randint(1, 3)):
        kind = rng.choice(
            ("crash", "partition", "jitter", "equivocate", "reconfigure")
        )
        if kind == "crash" and fault_budget > 0:
            node = rng.randrange(nodes)
            if node in used_nodes:
                continue
            used_nodes.add(node)
            at = round(rng.uniform(0.3, max(0.31, safe_end - 0.4)), 3)
            # Crash-with-restart and Reconfigure never share a plan: a
            # node whose crash window overlaps (or whose restart follows)
            # an epoch change loses the reconfigure broadcast and is
            # stranded in the old epoch — rejoining needs the snapshot
            # state-sync of ROADMAP item 1, which the system does not
            # claim yet. The fuzzer's first campaign found exactly this
            # (seeds 25/46/62/90/91/99, each shrinking to the 2-event
            # {Crash+restart, Reconfigure} reproducer); until state-sync
            # lands, the generator keeps plans inside the claimed
            # envelope. Permanent crashes still compose with Reconfigure
            # (the liveness oracle excludes nodes that stay down).
            if rng.random() < 0.6 and not have_reconfigure:
                restart_at = round(
                    min(at + rng.uniform(0.3, 0.8), safe_end), 3
                )
                have_restart = True
                events.append(Crash(at=at, node=node, restart_at=restart_at))
            else:
                fault_budget -= 1  # stays down: excluded from liveness
                events.append(Crash(at=at, node=node))
        elif kind == "partition" and not have_partition:
            have_partition = True
            at = round(rng.uniform(0.3, max(0.31, safe_end - 0.4)), 3)
            heal = round(min(at + rng.uniform(0.3, 1.0), safe_end), 3)
            minority = rng.sample(range(nodes), rng.randint(1, nodes // 2))
            rest = sorted(set(range(nodes)) - set(minority))
            events.append(
                Partition(
                    at=at, heal=heal,
                    groups=(tuple(sorted(minority)), tuple(rest)),
                )
            )
        elif kind == "jitter":
            a, b = rng.sample(range(nodes), 2)
            at = round(rng.uniform(0.1, max(0.11, safe_end - 0.3)), 3)
            end = round(min(at + rng.uniform(0.3, 1.2), safe_end), 3)
            link = LinkSpec(
                latency=round(rng.uniform(0.002, 0.02), 4),
                jitter=round(rng.uniform(0.0, 0.005), 4),
                drop=rng.choice((0.0, 0.005, 0.02)),
            )
            events.append(
                LinkFault(at=at, a=min(a, b), b=max(a, b), link=link, end=end)
            )
        elif kind == "equivocate" and fault_budget > 0:
            node = rng.randrange(nodes)
            if node in used_nodes:
                continue
            used_nodes.add(node)
            fault_budget -= 1
            start = round(rng.uniform(0.0, duration / 2), 3)
            events.append(Equivocate(node=node, start=start))
        elif kind == "reconfigure" and not have_reconfigure and not have_restart:
            have_reconfigure = True
            at = round(rng.uniform(0.5, max(0.6, duration - 1.5)), 3)
            events.append(Reconfigure(at=at))
    events.sort(key=lambda e: (getattr(e, "at", getattr(e, "start", 0.0))))
    return FaultPlan(seed=seed, default_link=default_link, events=tuple(events))


def _draw_default_link(rng: random.Random) -> LinkSpec:
    return LinkSpec(
        latency=rng.choice((0.001, 0.002, 0.005)),
        jitter=rng.choice((0.0, 0.0005, 0.001)),
        drop=rng.choice((0.0, 0.0, 0.0, 0.01)),
    )


def check_plan(
    plan: FaultPlan,
    nodes: int = 4,
    duration: float = 2.5,
    load_rate: int = 0,
    workers: int = 1,
    **backends,
) -> tuple[bool, str | None, object]:
    """Run one plan under the oracles: (ok, violation, ScenarioResult).

    Safety runs over honest nodes' commits; liveness over honest nodes
    that are up at scenario end. A scenario-level exception (deadlock,
    protocol crash) is reported as a violation with the result None.
    `backends` (`crypto_backend`, `dag_backend`, `device`) go to
    `run_scenario`."""
    try:
        result = run_scenario(
            nodes=nodes,
            workers=workers,
            duration=duration,
            load_rate=load_rate,
            plan=plan,
            **backends,
        )
    except Exception as exc:  # noqa: BLE001 — any blowup is a finding
        return False, f"{type(exc).__name__}: {exc}", None
    try:
        assert_safety(result.commits, honest=result.honest())
        live = [i for i in result.honest() if i not in result.crashed]
        assert_liveness(result.rounds, min_rounds=1.0, nodes=live)
    except OracleViolation as violation:
        return False, str(violation), result
    return True, None, result


def describe_plan(plan: FaultPlan) -> dict:
    """JSON-able plan description (the reproducer format in a campaign)."""
    return {
        "seed": plan.seed,
        "default_link": asdict(plan.default_link),
        "events": [
            {"kind": type(event).__name__, **asdict(event)}
            for event in plan.events
        ],
    }


def _with_event(plan: FaultPlan, index: int, event) -> FaultPlan:
    events = list(plan.events)
    events[index] = event
    return replace(plan, events=tuple(events))


def _halve(value: float, floor: float = 0.0, eps: float = 5e-3) -> float:
    halved = round(value / 2, 4)
    return floor if halved - floor < eps else halved


def _halved_variants(plan: FaultPlan):
    """Yield candidate plans with ONE numeric parameter pulled halfway
    toward its default — the shrinker's second pass."""
    link = plan.default_link
    for name in ("latency", "jitter", "drop"):
        value = getattr(link, name)
        if value > 0:
            yield replace(
                plan, default_link=replace(link, **{name: _halve(value)})
            )
    for i, event in enumerate(plan.events):
        if isinstance(event, Crash):
            if event.at > 0.05:
                yield _with_event(plan, i, replace(event, at=_halve(event.at)))
            if event.restart_at is not None:
                yield _with_event(plan, i, replace(event, restart_at=None))
        elif isinstance(event, Partition):
            window = event.heal - event.at
            if event.at > 0.05:
                at = _halve(event.at)
                yield _with_event(
                    plan, i, replace(event, at=at, heal=round(at + window, 4))
                )
            if window > 0.1:
                yield _with_event(
                    plan, i,
                    replace(event, heal=round(event.at + _halve(window), 4)),
                )
        elif isinstance(event, LinkFault):
            if event.at > 0.05:
                yield _with_event(plan, i, replace(event, at=_halve(event.at)))
            if event.end is not None and event.end - event.at > 0.1:
                yield _with_event(
                    plan, i,
                    replace(
                        event,
                        end=round(event.at + _halve(event.end - event.at), 4),
                    ),
                )
            for name in ("latency", "jitter", "drop"):
                value = getattr(event.link, name)
                if value > 0:
                    yield _with_event(
                        plan, i,
                        replace(
                            event, link=replace(event.link, **{name: _halve(value)})
                        ),
                    )
        elif isinstance(event, Equivocate):
            if event.start > 0.05:
                yield _with_event(
                    plan, i, replace(event, start=_halve(event.start))
                )
        elif isinstance(event, Reconfigure):
            if event.at > 0.05:
                yield _with_event(plan, i, replace(event, at=_halve(event.at)))


def shrink(plan: FaultPlan, still_fails, max_checks: int = 64) -> FaultPlan:
    """Minimize a failing plan to a reproducer.

    `still_fails(candidate) -> bool` re-runs whatever check failed (for a
    real campaign: `not check_plan(candidate)[0]`). Pass 1 greedily
    deletes events whose removal keeps the plan failing; pass 2 halves
    numeric parameters toward their defaults. Bounded by `max_checks`
    candidate evaluations so a flaky predicate cannot loop forever."""
    checks = 0

    def fails(candidate: FaultPlan) -> bool:
        nonlocal checks
        if checks >= max_checks:
            return False
        checks += 1
        return bool(still_fails(candidate))

    # Pass 1: event deletion (restart the scan after every success so the
    # smallest surviving subset is found greedily).
    changed = True
    while changed:
        changed = False
        events = list(plan.events)
        for i in range(len(events)):
            candidate = replace(
                plan, events=tuple(events[:i] + events[i + 1:])
            )
            if fails(candidate):
                plan = candidate
                changed = True
                break
    # Pass 2: parameter halving.
    changed = True
    while changed:
        changed = False
        for candidate in _halved_variants(plan):
            if fails(candidate):
                plan = candidate
                changed = True
                break
    return plan


def run_campaign(
    count: int = 100,
    base_seed: int = 0,
    nodes: int = 4,
    duration: float = 2.5,
    load_rate: int = 0,
    workers: int = 1,
    shrink_failing: bool = True,
    progress=None,
    **backends,
) -> dict:
    """Explore `count` seeded plans; shrink every failure. Returns the
    campaign payload (JSON-able). `backends` go to every `check_plan`."""
    t0 = time.monotonic()
    scenarios: list[dict] = []
    failures: list[dict] = []
    for i in range(count):
        seed = base_seed + i
        plan = generate_plan(seed, nodes=nodes, duration=duration)
        ok, violation, result = check_plan(
            plan, nodes=nodes, duration=duration,
            load_rate=load_rate, workers=workers, **backends,
        )
        row = {
            "seed": seed,
            "events": [type(event).__name__ for event in plan.events],
            "ok": ok,
            "rounds": max(result.rounds) if result and result.rounds else 0,
        }
        if not ok:
            row["violation"] = violation
            finding: dict = {
                "seed": seed,
                "violation": violation,
                "plan": describe_plan(plan),
            }
            if shrink_failing:
                minimal = shrink(
                    plan,
                    lambda p: not check_plan(
                        p, nodes=nodes, duration=duration,
                        load_rate=load_rate, workers=workers, **backends,
                    )[0],
                )
                finding["minimal_plan"] = describe_plan(minimal)
            failures.append(finding)
        scenarios.append(row)
        if progress is not None:
            progress(row)
    return {
        "count": count,
        "base_seed": base_seed,
        "nodes": nodes,
        "workers": workers,
        "duration_virtual_s": duration,
        "load_rate": load_rate,
        "ok": not failures,
        "failures": failures,
        "scenarios": scenarios,
        "wall_s": round(time.monotonic() - t0, 3),
    }


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="Seeded FaultPlan fuzzer under the simnet oracles"
    )
    parser.add_argument("--count", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0, help="base seed")
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--duration", type=float, default=2.5)
    parser.add_argument("--load-rate", type=int, default=0)
    parser.add_argument(
        "--no-shrink", action="store_true",
        help="report failures without minimizing them",
    )
    parser.add_argument("--out", default=None, help="write the campaign JSON here")
    parser.add_argument(
        "--crypto-backend", choices=("cpu", "pool", "cuda"), default=None,
        help="the nodes' crypto backend (default: the port Cluster's, cuda)",
    )
    parser.add_argument(
        "--dag-backend", choices=("cpu", "cuda"), default=None,
        help="the nodes' DAG backend (default: the port Cluster's, cuda)",
    )
    args = parser.parse_args(argv)
    backends = {
        k: v for k, v in (
            ("crypto_backend", args.crypto_backend),
            ("dag_backend", args.dag_backend),
        ) if v is not None
    }

    def progress(row: dict) -> None:
        mark = "ok" if row["ok"] else "FAIL"
        print(
            f"seed {row['seed']:>6} {mark:>4} rounds={row['rounds']:>3} "
            f"events={','.join(row['events']) or '-'}"
        )
        if not row["ok"]:
            print(f"  violation: {row['violation']}")

    campaign = run_campaign(
        count=args.count,
        base_seed=args.seed,
        nodes=args.nodes,
        duration=args.duration,
        load_rate=args.load_rate,
        workers=args.workers,
        shrink_failing=not args.no_shrink,
        progress=progress,
        **backends,
    )
    print(
        f"fuzz: {campaign['count']} scenarios, "
        f"{len(campaign['failures'])} failure(s), "
        f"{campaign['wall_s']}s wall"
    )
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(campaign, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.out}")
    return 0 if campaign["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
