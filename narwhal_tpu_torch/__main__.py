"""Role binaries: the CLI entry point.

Port copy of `narwhal_tpu/__main__.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.
Its backend choices are `--crypto-backend cpu|pool|cuda` and
`--dag-backend cpu|cuda`, both `cuda` by default (the JAX CLI's default
is `cpu`); `cuda` always means the card (there is no device flag), so a
primary run without `cpu` backends on a machine without one exits
non-zero with the error that names the missing card.

Reference: narwhal/node/src/main.rs:39-153 — subcommands
`generate_keys`, `run primary [--consensus-disabled]`, `run worker --id N`,
plus `benchmark_client`; telemetry goes to stdout in the RFC-3339-ish format
the benchmark harness parses (:155-200); a prometheus endpoint serves each
role's registry (:279-285).

Usage:
  python -m narwhal_tpu_torch generate_keys --filename key.json
  python -m narwhal_tpu_torch run --keys key.json --committee committee.json \
      --workers workers.json --parameters parameters.json --store db primary \
      --crypto-backend cuda --dag-backend cuda
  python -m narwhal_tpu_torch run ... worker --id 0
  python -m narwhal_tpu_torch benchmark_client --target host:port --rate 1000 --size 512
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys

from .benchmark_client import BenchmarkClient
from .config import Committee, Parameters, WorkerCache
from .crypto import KeyPair
from .metrics import serve_metrics
from .node import PrimaryNode, WorkerNode
from .stores import NodeStorage


def _setup_logging(verbosity: int) -> None:
    level = [logging.WARNING, logging.INFO, logging.DEBUG][min(verbosity, 2)]
    # The benchmark harness parses "<RFC3339 UTC> <LEVEL> <msg>" lines.
    logging.basicConfig(
        stream=sys.stdout,
        level=level,
        format="%(asctime)s.%(msecs)03dZ %(levelname)s %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
    )


def _load_keys(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cmd_generate_keys(args) -> None:
    """Emit the authority's protocol keypair plus its transport identities:
    the primary network key and one network key per worker lane (the
    reference's generate_keys + generate_network_keys,
    node/src/main.rs:40-76)."""
    import secrets

    # Boot-time key material for a PRODUCTION node: generate-keys runs once
    # on an operator's machine, never inside a seeded replay — real entropy
    # is the requirement here, not a divergence.
    seed = secrets.token_bytes(32)  # lint: allow(raw-entropy)
    network_seed = secrets.token_bytes(32)  # lint: allow(raw-entropy)
    worker_seeds = {str(w): secrets.token_bytes(32) for w in range(args.workers)}  # lint: allow(raw-entropy)
    kp = KeyPair.from_seed(seed)
    doc = {
        "name": kp.public.hex(),
        "seed": seed.hex(),
        "network_seed": network_seed.hex(),
        "network_key": KeyPair.from_seed(network_seed).public.hex(),
        "worker_network_seeds": {w: s.hex() for w, s in worker_seeds.items()},
        "worker_network_keys": {
            w: KeyPair.from_seed(s).public.hex() for w, s in worker_seeds.items()
        },
    }
    with open(args.filename, "w") as f:
        json.dump(doc, f, indent=2)
    print(kp.public.hex())


async def _run_node(args) -> None:
    keys = _load_keys(args.keys)
    keypair = KeyPair.from_seed(bytes.fromhex(keys["seed"]))
    committee = Committee.import_(args.committee)
    worker_cache = WorkerCache.import_(args.workers)
    parameters = (
        Parameters.import_(args.parameters) if args.parameters else Parameters()
    )

    if args.role == "primary":
        if "network_seed" not in keys and not args.insecure:
            raise SystemExit(
                "key file has no 'network_seed': transport authentication would "
                "be silently disabled. Regenerate with `generate_keys` or pass "
                "--insecure to run an open mesh deliberately."
            )
        network_keypair = (
            KeyPair.from_seed(bytes.fromhex(keys["network_seed"]))
            if "network_seed" in keys
            else None
        )
        storage = NodeStorage(f"{args.store}-primary" if args.store else None)
        node = PrimaryNode(
            keypair,
            committee,
            worker_cache,
            parameters,
            storage,
            internal_consensus=not args.consensus_disabled,
            consensus_protocol=getattr(args, "consensus_protocol", "bullshark"),
            crypto_backend=getattr(args, "crypto_backend", "cpu"),
            dag_backend=getattr(args, "dag_backend", "cpu"),
            dag_shards=getattr(args, "dag_shards", 1),
            verify_shards=getattr(args, "verify_shards", 1),
            network_keypair=network_keypair,
        )
        await node.spawn()
        registry = node.registry

        # A standalone primary has no embedding draining the execution
        # output channel: without a consumer it fills after ~10k applied
        # transactions, wedging the executor's output flush and pinning the
        # backpressure level at 1.0 forever. Drain and drop — the default
        # no-op execution state has no application consumer by definition.
        async def _drain_execution_output() -> None:
            ch = node.tx_execution_output
            while True:
                await ch.recv()

        _exec_drain = asyncio.ensure_future(_drain_execution_output())

        # Machine-readable boot line: the primary's gRPC telemetry
        # endpoint, for harnesses that scrape-then-kill (benchmark/
        # local.py). Parsing the human "gRPC public API listening on ..."
        # log line tied those harnesses to the log format; this line is
        # the contract. Empty when the gRPC plane is not mounted.
        print(f"TELEMETRY_ADDR={node.grpc_api_address}", flush=True)
    else:
        worker_seed = keys.get("worker_network_seeds", {}).get(str(args.id))
        if worker_seed is None and not args.insecure:
            raise SystemExit(
                f"key file has no worker_network_seeds entry for worker {args.id}: "
                "transport authentication would be silently disabled. Regenerate "
                "with `generate_keys --workers N` or pass --insecure."
            )
        network_keypair = (
            KeyPair.from_seed(bytes.fromhex(worker_seed)) if worker_seed else None
        )
        storage = NodeStorage(
            f"{args.store}-worker-{args.id}" if args.store else None
        )
        node = WorkerNode(
            keypair.public,
            args.id,
            committee,
            worker_cache,
            parameters,
            storage,
            benchmark=True,
            network_keypair=network_keypair,
        )
        await node.spawn()
        registry = node.registry

    host, port = parameters.prometheus_address.rsplit(":", 1)
    await serve_metrics(registry, host, int(port))
    await asyncio.Event().wait()  # run forever


async def _run_benchmark_client(args) -> None:
    client = BenchmarkClient(
        args.target, size=args.size, rate=args.rate, nodes=tuple(args.nodes)
    )
    await client.wait_for_nodes()
    client.spawn()
    await asyncio.Event().wait()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="narwhal_tpu_torch")
    parser.add_argument("-v", "--verbose", action="count", default=1)
    sub = parser.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate_keys")
    g.add_argument("--filename", required=True)
    g.add_argument(
        "--workers", type=int, default=4,
        help="worker lanes to generate transport identities for",
    )

    r = sub.add_parser("run")
    r.add_argument("--keys", required=True)
    r.add_argument(
        "--insecure", action="store_true",
        help="run without transport authentication when the key file lacks "
        "network seeds (testing only)",
    )
    r.add_argument("--committee", required=True)
    r.add_argument("--workers", required=True)
    r.add_argument("--parameters", default=None)
    r.add_argument("--store", default=None)
    r.add_argument(
        "--mem-profiling", action="store_true",
        help="tracemalloc heap profiling (dhat analog): dumps "
        "memprofile-<role>-<pid>.txt to the store dir on exit",
    )
    rsub = r.add_subparsers(dest="role", required=True)
    p = rsub.add_parser("primary")
    p.add_argument(
        "--consensus-disabled", action="store_true",
        help="external consensus: expose the Dag API instead of Bullshark",
    )
    p.add_argument(
        "--crypto-backend", choices=("cpu", "pool", "cuda"), default="cuda",
        help="signature verification: inline host (cpu), coalescing host "
        "pool, or the card's batch kernels (cuda)",
    )
    p.add_argument(
        "--dag-backend", choices=("cpu", "cuda"), default="cuda",
        help="consensus commit walk: host order_dag (cpu) or the on-device "
        "adjacency-tensor kernels (cuda)",
    )
    p.add_argument(
        "--dag-shards", type=int, default=1,
        help="with --dag-backend cuda: shard the committee axis of the DAG "
        "window over this many devices (an 'auth' mesh; 1 = single device)",
    )
    p.add_argument(
        "--verify-shards", type=int, default=1,
        help="with --crypto-backend cuda: shard every verify flush over this "
        "many devices (a 'data' mesh; must divide the service's dispatch "
        "bucket — validated at startup)",
    )
    p.add_argument(
        "--consensus-protocol", choices=("bullshark", "tusk"), default="bullshark",
        help="ordering engine (the reference's default is bullshark; tusk is "
        "the asynchronous-network variant)",
    )
    w = rsub.add_parser("worker")
    w.add_argument("--id", type=int, required=True)

    b = sub.add_parser("benchmark_client")
    b.add_argument(
        "--target", required=True, action="append",
        help="worker transactions address; repeat for a validator's W "
        "worker lanes (bursts round-robin across them)",
    )
    b.add_argument("--size", type=int, default=512)
    b.add_argument("--rate", type=int, default=1_000)
    b.add_argument("--nodes", nargs="*", default=[])

    args = parser.parse_args(argv)
    _setup_logging(args.verbose)
    # NARWHAL_PROFILE=<dir>: dump cProfile stats per process on exit — the
    # profiling plane (the reference's dhat/pprof analog, node/src/lib.rs:224).
    import os

    profile_dir = os.environ.get("NARWHAL_PROFILE")
    profiler = None
    if profile_dir:
        import atexit
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()
        role = getattr(args, "role", args.command)
        out = os.path.join(profile_dir, f"{role}-{os.getpid()}.pstats")

        def _dump():
            profiler.disable()
            profiler.dump_stats(out)

        atexit.register(_dump)
        # atexit only runs on clean exit; the bench harness stops nodes with
        # SIGTERM, so convert it into a normal interpreter exit.
        import signal as _signal

        _signal.signal(_signal.SIGTERM, lambda *_: sys.exit(0))
    # NARWHAL_MEM_PROFILE=<dir> (or --mem-profiling on `run`): tracemalloc
    # sampling — the reference's dhat heap profiling analog
    # (node/src/lib.rs:224-238, `mem_profiling` bench param). Periodic
    # top-allocation log lines plus a final per-process dump file.
    mem_dir = os.environ.get("NARWHAL_MEM_PROFILE") or (
        getattr(args, "mem_profiling", None) and (args.store or ".")
    )
    if mem_dir:
        import atexit
        import signal as _signal
        import tracemalloc

        tracemalloc.start(10)
        role = getattr(args, "role", args.command)
        mem_out = os.path.join(mem_dir, f"memprofile-{role}-{os.getpid()}.txt")

        def _dump_mem():
            snap = tracemalloc.take_snapshot()
            os.makedirs(os.path.dirname(mem_out) or ".", exist_ok=True)
            with open(mem_out, "w") as fh:
                current, peak = tracemalloc.get_traced_memory()
                fh.write(f"current={current} peak={peak}\n")
                for stat in snap.statistics("lineno")[:40]:
                    fh.write(f"{stat}\n")

        atexit.register(_dump_mem)
        _signal.signal(_signal.SIGTERM, lambda *_: sys.exit(0))
    if args.command == "generate_keys":
        cmd_generate_keys(args)
    elif args.command == "run":
        asyncio.run(_run_node(args))
    elif args.command == "benchmark_client":
        asyncio.run(_run_benchmark_client(args))


if __name__ == "__main__":
    main()
