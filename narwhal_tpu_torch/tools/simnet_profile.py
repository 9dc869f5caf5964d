"""Simnet fabric profiler for the PyTorch port: per-component self-time on
the virtual-clock hot path.

Port copy of the repo's `tools/perf/simnet_profile.py`. It runs a seeded
`narwhal_tpu_torch.simnet` scenario under cProfile and folds every
function's SELF time into a small set of named components:

  fabric_deliver  simnet/fabric.py transmit/deliver machinery
  event_log       the hash-chained EventLog (append + digest)
  sim_clock       simnet/clock.py — the virtual-time selector + timers
  auth_aead       network/auth.py + the blake2b/hmac primitives it drives
  signing         narwhal_tpu_torch/crypto.py (ed25519 sign/verify)
  device_pack     the card plane's host Python: narwhal_tpu_torch/gpu/
                  (the verifier's packing, the DAG window's mirror, the
                  kernel wrappers, with the C entry points they call
                  through ctypes, whose time cProfile bills to the
                  caller) and torch's Python layer
  device_wait     the torch and ctypes C calls the plane makes: tensor
                  builds, host-device copies, CUDA event and stream waits
  wire_rpc        framing, transport seam, channels
  codec           message encode/decode
  protocol        primary/worker/consensus/dag/executor logic
  asyncio_loop    stdlib asyncio + selectors dispatch
  other           everything unmatched (the attribution residual)

The table is the JAX package's with the package renamed, plus
`device_pack` and `device_wait` (the card's path is code the reference's
table never saw; the split keeps host work apart from the calls that copy
to the card and wait on it, as far as cProfile can tell them apart) and one
alternative in `asyncio_loop`: the selector's `epoll.poll`, which the
reference's `select` pattern never matches on Linux. The simnet loop
polls it (non-blocking) on every turn; where syscalls are dear, as on the
card's host, it is a sizeable share of the loop.

Self time (cProfile `tottime`) sums to the profiled wall time, so the
component shares are a true decomposition, and `attributed_share`
(everything but `other`) is the acceptance figure: below 0.8 the bucket
table has drifted from the code and needs new patterns.

The scenario runs on the port `Cluster`'s backends: the card's `cuda`
crypto and DAG backends unless the caller asks for the host (raising
without a card). Run:

    python -m narwhal_tpu_torch.tools.simnet_profile \
        [--nodes 6 --duration 3 --load-rate 120 --seed 7] \
        [--crypto-backend cpu --dag-backend cpu] [--out <report.json>]

It writes only its `--out` file.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import re

# Ordered: first match wins. Patterns run against "filename:funcname"
# with the filename reduced to its repo-relative (or basename) form.
_COMPONENTS: tuple[tuple[str, re.Pattern], ...] = (
    ("event_log", re.compile(r"simnet/fabric\.py:(append|digest|_chain)")),
    ("fabric_deliver", re.compile(r"simnet/fabric\.py:")),
    ("sim_clock", re.compile(r"simnet/(clock|scenario)\.py:")),
    (
        "auth_aead",
        re.compile(
            r"network/auth\.py:|~:<built-in method _blake2|"
            r"~:.*(blake2b|hmac|compare_digest)|hmac\.py:"
        ),
    ),
    (
        "signing",
        # ed25519_ref is the pure-python group law behind sign/verify; the
        # pow builtin is its field inversion/exponentiation — in a simnet
        # scenario nothing else drives pow at depth, so it bills here.
        re.compile(
            r"narwhal_tpu_torch/crypto\.py:|narwhal_tpu_torch/gpu/ed25519_ref\.py:|"
            r"~:.*(sha512|ed25519|scalarmult)|~:<built-in method builtins\.pow"
        ),
    ),
    (
        "device_pack",
        # The card plane's host Python: the verifier's packing, the DAG
        # window's mirror and the kernel wrappers (whose ctypes calls bill
        # to the calling wrapper), and torch's Python layer.
        re.compile(r"narwhal_tpu_torch/gpu/|^torch/"),
    ),
    (
        "device_wait",
        # torch's C methods (tensor builds, host-device copies) and the
        # CUDA event and stream waits (`torch.cuda.Event.synchronize`
        # profiles as a C call).
        re.compile(
            r"~:<built-in method (torch|_ctypes)\.|"
            r"~:<method '[^']*' of '(torch\._C|_ctypes)\.|~:<function (Event|Stream)\."
        ),
    ),
    (
        "wire_rpc",
        re.compile(
            r"network/(rpc|transport)\.py:|narwhal_tpu_torch/channels\.py:|"
            r"narwhal_tpu_torch/grpc_api\.py:"
        ),
    ),
    ("codec", re.compile(r"narwhal_tpu_torch/(codec|messages)\.py:|~:.*sha256")),
    (
        "protocol",
        re.compile(
            r"narwhal_tpu_torch/(primary|worker|consensus|executor)/|"
            r"narwhal_tpu_torch/(dag|node|native|pacing|storage|stores|types|tracing|"
            r"metrics|config|clock|bounded_cache|cluster|fixtures)\.py:"
        ),
    ),
    (
        "asyncio_loop",
        re.compile(
            r"asyncio/|selectors\.py:|~:<built-in method select|"
            # the selector's own poll on Linux (EpollSelector.select)
            r"~:<method 'poll' of 'select\.epoll' objects>|queue\.py:|"
            r"_weakrefset\.py:|~:<method 'run' of '_contextvars|"
            r"~:.*_asyncio"
        ),
    ),
)


def _label(filename: str, funcname: str) -> str:
    # Normalise absolute paths down to a stable repo-relative-ish suffix
    # so the patterns match regardless of checkout location.
    name = filename.replace("\\", "/")
    for anchor in ("narwhal_tpu_torch/", "asyncio/", "torch/", "tools/"):
        idx = name.rfind(anchor)
        if idx >= 0:
            name = name[idx:]
            break
    else:
        name = name.rsplit("/", 1)[-1]
    return f"{name}:{funcname}"


def classify(filename: str, funcname: str) -> str:
    label = _label(filename, funcname)
    for component, pattern in _COMPONENTS:
        if pattern.search(label):
            return component
    return "other"


def attribute_stats(stats: pstats.Stats) -> dict:
    """Fold a pstats tree into the component decomposition."""
    buckets: dict[str, dict] = {}
    total = 0.0
    for (filename, _lineno, funcname), row in stats.stats.items():  # type: ignore[attr-defined]
        _cc, ncalls, tottime, _cumtime = row[0], row[1], row[2], row[3]
        total += tottime
        component = classify(filename, funcname)
        bucket = buckets.setdefault(
            component, {"self_s": 0.0, "calls": 0, "top": []}
        )
        bucket["self_s"] += tottime
        bucket["calls"] += ncalls
        bucket["top"].append((tottime, _label(filename, funcname)))
    ranked = []
    for component, bucket in buckets.items():
        bucket["top"].sort(reverse=True)
        ranked.append(
            {
                "component": component,
                "self_s": round(bucket["self_s"], 4),
                "share": round(bucket["self_s"] / total, 4) if total else 0.0,
                "calls": bucket["calls"],
                "top_functions": [
                    {"self_s": round(t, 4), "function": name}
                    for t, name in bucket["top"][:5]
                ],
            }
        )
    ranked.sort(key=lambda r: -r["self_s"])
    attributed = sum(r["self_s"] for r in ranked if r["component"] != "other")
    return {
        "total_self_s": round(total, 4),
        "attributed_share": round(attributed / total, 4) if total else 0.0,
        "components": ranked,
    }


def profile_scenario(
    nodes: int = 6,
    duration: float = 3.0,
    load_rate: int = 120,
    seed: int = 7,
    workers: int = 1,
    crypto_backend: str | None = None,
    dag_backend: str | None = None,
    device=None,
) -> dict:
    """Run one seeded scenario under cProfile and return the component
    attribution plus the scenario's own summary figures. The backends and
    device go to `run_scenario`: None keeps the port `Cluster`'s defaults,
    the card."""
    from narwhal_tpu_torch.simnet import FaultPlan, LinkSpec, run_scenario
    from narwhal_tpu_torch.simnet.fabric import SimFabric

    profiler = cProfile.Profile()
    profiler.enable()
    try:
        result = run_scenario(
            nodes=nodes,
            workers=workers,
            duration=duration,
            load_rate=load_rate,
            plan=FaultPlan(seed=seed, default_link=LinkSpec(latency=0.002)),
            crypto_backend=crypto_backend,
            dag_backend=dag_backend,
            device=device,
        )
    finally:
        profiler.disable()
    stats = pstats.Stats(profiler)
    report = attribute_stats(stats)
    report["scenario"] = {
        "nodes": nodes,
        "workers": workers,
        "duration_virtual_s": duration,
        "load_rate": load_rate,
        "seed": seed,
        "wall_s": round(result.wall_s, 3),
        "event_log_len": result.event_log_len,
        "committed_rounds": max(result.rounds) if result.rounds else 0,
        "fabric_counters": dict(SimFabric.last_counters),
        "backend_drops": result.backend_drops(),
    }
    return report


def render_table(report: dict) -> str:
    """The ranked table: where the virtual-clock wall time actually goes."""
    lines = [
        f"simnet fabric profile — {report['total_self_s']:.2f}s self time, "
        f"{report['attributed_share']:.0%} attributed to named components",
        f"{'component':<16} {'self_s':>8} {'share':>7} {'calls':>10}  hottest function",
    ]
    for row in report["components"]:
        hottest = row["top_functions"][0]["function"] if row["top_functions"] else "-"
        lines.append(
            f"{row['component']:<16} {row['self_s']:>8.3f} "
            f"{row['share']:>6.1%} {row['calls']:>10}  {hottest}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", type=int, default=6)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--duration", type=float, default=3.0)
    parser.add_argument("--load-rate", type=int, default=120)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument(
        "--crypto-backend", choices=("cpu", "pool", "cuda"), default=None,
        help="the nodes' crypto backend (default: the port Cluster's, cuda)",
    )
    parser.add_argument(
        "--dag-backend", choices=("cpu", "cuda"), default=None,
        help="the nodes' DAG backend (default: the port Cluster's, cuda)",
    )
    parser.add_argument("--out", default=None, help="write the report JSON here")
    args = parser.parse_args(argv)

    report = profile_scenario(
        nodes=args.nodes,
        workers=args.workers,
        duration=args.duration,
        load_rate=args.load_rate,
        seed=args.seed,
        crypto_backend=args.crypto_backend,
        dag_backend=args.dag_backend,
    )
    print(render_table(report))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
