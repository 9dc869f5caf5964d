#!/usr/bin/env python3
"""Per-launch device times of the window-lane kernels, A1, A3-A5, B2, B6,
B7, A6' and the DAG window's sync (B3, B4) on one NVIDIA card.

    python3 msm_breakdown.py [--package DIR] [--bucket B ...] [--phases]
                             [--sections S ...]

For each bucket (default the verifier's 2048 rows and a shard's 1024): A2
`msm_accumulate` on the group-lane and item buckets of `chip_smoke.py`, A6
`msm_window` on their A (64 lanes) and R (32 lanes) sets and A3
`verify_decompress` on their A set and on `chip_smoke.decompress_rows`
(the edge encodings); A1 `verify_batch` on `chip_smoke.signature_bucket`
(forged, torsion, zero and random-limb rows), A4 `verify_straus` on its
A set decompressed by A3 and A5 `verify_verdict` on A4's accumulators and
its R set. Then B2 `chain_commit`
at the main path's shape (W = 64, N = 50, K = 1, the healed-partition chain
of `chip_smoke.check_chain_commit`, leader row 58), from row 2 of the same
window (the slope of the two is the time a row costs), with the leader
repeated four times, and at the shapes the wide walk serves (`WIDE_SHAPES`:
N = 65, 200, 1024 and a 512-row window at N = 50; `HEALED_WIDE`: its
slowest case, columns left unreached by a partition). Each is first held
against its plain version (lanes and accumulators as affine points,
coordinates mod p, validity, verdicts and masks bit for bit), then timed:
the CUDA-event median through the wrapper, and torch.profiler's device
time of one call split by the kernels it launches. It prints nvcc's ptxas
figures (registers, spills, shared memory) of the four sources first.

Section `reach`: B6 `reach_many` at the kernels phase's shape of
`chip_smoke.py` (W = 64, N = 50, K = 64 reads of which 56 live, the sparse
window), at the Dag service's dense window (W = 64 and 128, K = 1, 8, 64),
at the consensus step's window (its uncommitted mask) and at the wide
route's shapes (N = 65 and 200 at W = 64, W = 512 at N = 50).
Section `reduce`: A6' `msm_shard_reduce` as the sharded msm bucket calls
it, over k = 2 and 4 shards of the item bucket's A and R sets (B = 2048):
one call for both sets where the package takes both, else the stack and
the launch of each set. Each held against its plain version first (masks
bit for bit, lanes as affine points). Section `commit`: B7
`consensus_commit` at `chip_smoke.COMMIT_SHAPES` (the consensus step's W =
64, N = 50, B = 64 on B6's masks; the dry run's shard block W = 8, M = 4
of S = 8; a shard block of the 2 x 2 mesh, M = 25 of S = 50; N = 200 and
1024, one walk, an unaligned slab, a misaligned view, a wrapping stake
sum), each held against its plain version first. Section `steps`: the host wall of two steps
`chip_smoke.py` times once each, repeated: the unmeshed
consensus step (B = 64 walks on its W = 64, N = 50 window, copies in and
out) and the dry run (`entry()`'s walk, then `dryrun_multichip(4)` over
this card four times); the median and quartiles over `STEP_REPS` runs.
Section `window`: the window sync of `DagWindow.device_view` at N = 50,
W = 64 and 128: B4 `roll_window` at shifts 0 and 1, B3 `place_batch` of
T = 1, 64 and 128 slots (`chip_smoke.sync_slots`, four duplicates) as the
package's `device_view` hands them over (a package without `sync_window`
uploads the four slot arrays first), and the sync of a view that rolls by
0 or 1 and places T slots (`sync_window`, or the roll and then the place
where the package has none), each held against the plain roll then place
first; then the host wall of `device_view` over the engine phase's stream
(`chip_smoke.engine_stream`, 200 rounds), recorded once as `GpuBullshark`
calls the window (every insert, one view a commit event) and replayed
`VIEW_REPLAYS` times on a fresh window: the median and quartiles of the
views that roll or place, the host clock around the call alone and up to
the card's end, and the launches of the replays; then one more replay
under cProfile, its costliest functions by own time a view. Between the
two, where the package's `sync_window` takes a grid, the sync at W = 64
and 128, shift 1, T = 0 and 64 for each of `GRID_CHUNKS` (bytes of a
parent row a CTA) x `GRID_THREADS` (threads a CTA).
Section `support`: B5 `leader_support` at the consensus step's shape (W
= 64, N = 50, B = 64 walks, `chip_smoke.check_leader_support`'s inputs),
at B = 1 and 200, and on a shard's block of the 2 x 2 mesh (M = 25 link
columns of the padded N = 50, its walks' leaders in the block), each held
against its plain version first; the events time is the wrapper's whole
call (with the read of its range check: before the launch in a package
that checks on the host, after it where the kernel writes error words),
the device time split by what it launched.
Section `routes`: the committee-sharded compositions at N = 50, W = 64 on
this card, forced onto each route the package's `mesh.ROUTES` names
("host" for cards without peer access, or "rowstep", the host row loop,
in a package from before it): `chain_commit_sharded` over 2
shards on the healed-partition chain of `chip_smoke.check_sharded_walk`
(K = 1, leader row 58), `reach_many_sharded` over 2 shards at K = 64 (56
live) and `consensus_step_sharded` over a 2 x 2 mesh (B = 64), each held
against the unsharded kernel first; events ms a call (each call waits for
its result on the host, so this is its wall) and the launches of one call
by kernel.
`--sections` picks among `lanes` (A2, A6, A3, A1, A4, A5; the default
runs every section), `walk` (B2), `reach`, `reduce`, `commit`, `steps`,
`window`, `support` and `routes`.

`--phases` also builds `csrc/ed25519_msm.cu` with -DMSM_PHASE_TIMES (its
chain kernel then records %globaltimer at four points of each CTA) and
prints, for A2 and A6 at each bucket, the median over CTAs of the time to
stage the points (A2: decompress them), to build the tables and to run
the chains, and the last CTA's end, from the kernel's start.

`--package DIR` imports `narwhal_tpu_torch` from DIR (for example an unpacked
`git archive` of another commit) instead of from this checkout, so two
versions of the kernels can be compared in one call on one card; the
buckets, checks and timing are this script's and `chip_smoke.py`'s either
way. It needs a card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default=None, help="directory holding narwhal_tpu_torch/")
    ap.add_argument("--bucket", type=int, nargs="+", default=[2048, 1024])
    ap.add_argument("--phases", action="store_true", help="time the chain kernel's phases")
    ap.add_argument("--sections", nargs="+", choices=SECTIONS, default=list(SECTIONS))
    args = ap.parse_args(argv)
    import importlib.util

    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    sys.path.insert(1, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("msm_breakdown: needs an NVIDIA card", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py, whichever package is imported
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from narwhal_tpu_torch.fixtures import CommitteeFixture
    from narwhal_tpu_torch.gpu import ed25519, kernel_registry

    dev = torch.device("cuda")
    print(f"package {os.path.dirname(ed25519.__file__)}", flush=True)
    print(chip_smoke.card_line(), flush=True)
    stems = sorted({stem for sec in args.sections for stem in SECTIONS[sec]})
    walls = kernel_registry.build(stems)
    print("build walls " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()), flush=True)
    for stem in stems:
        for kernel, figures in chip_smoke.ptxas_report(stem).items():
            print(f"ptxas {kernel}: {figures}", flush=True)

    def timed(name, fn):
        ms = chip_smoke.time_ms(fn, dev, reps=5)
        dev_ms, per = chip_smoke.device_breakdown(fn, dev)
        split = ", ".join(f"{k} {v:.4f}" for k, v in per.items())
        device = "not captured" if dev_ms is None else f"{dev_ms:.4f} ms ({split})"
        print(f"{name}: events {ms:.4f} ms, device {device}", flush=True)

    f = CommitteeFixture(size=50)
    for bucket in args.bucket if "lanes" in args.sections else ():
        buckets = {"group": chip_smoke.msm_group_bucket(f, bucket)[0],
                   "item": chip_smoke.msm_item_bucket(23, 300, bucket)[0]}
        for shape, host in buckets.items():
            t = [torch.from_numpy(a).to(dev) for a in host]
            va, vr, valid = ed25519.msm_accumulate(*t)
            pva, pvr, pvalid = ed25519.msm_accumulate_plain(*t)
            chip_smoke._same_bits("A2 valid", valid, pvalid)
            chip_smoke._same_points("A2 V_a", va, pva)
            chip_smoke._same_points("A2 V_r", vr, pvr)
            timed(f"A2 msm_accumulate {shape} B={bucket}", lambda: ed25519.msm_accumulate(*t))
            pa, _ = ed25519.verify_decompress(t[0], t[1])
            pr, _ = ed25519.verify_decompress(t[2], t[3])
            for lanes, pts, dig, mono in ((64, pa, t[4], va), (32, pr, t[5], vr)):
                v = ed25519.msm_window(pts, dig)
                chip_smoke._same_points("A6", v, ed25519.msm_window_plain(pts, dig))
                chip_smoke._same_points("A6 against A2", v, mono)
                timed(f"A6 msm_window {shape} B={bucket} {lanes} lanes",
                      lambda: ed25519.msm_window(pts, dig))
            timed(f"A3 verify_decompress {shape} B={bucket}",
                  lambda: ed25519.verify_decompress(t[0], t[1]))
            if args.phases:
                phases(ed25519, kernel_registry, dev, t, pa, pr, f"{shape} B={bucket}")
        decompress(chip_smoke, ed25519, dev, bucket, timed)
        straus(chip_smoke, ed25519, dev, bucket, timed)
        verdict(chip_smoke, ed25519, dev, bucket, timed)
    if "walk" in args.sections:
        walk(chip_smoke, dev, timed)
    if "reach" in args.sections:
        reach(chip_smoke, dev, timed)
    if "reduce" in args.sections:
        reduce(chip_smoke, ed25519, dev, timed)
    if "commit" in args.sections:
        commit(chip_smoke, dev, timed)
    if "steps" in args.sections:
        steps(chip_smoke, dev)
    if "window" in args.sections:
        window(chip_smoke, dev, timed)
        window_grid(chip_smoke, dev, timed)
        view_replay(chip_smoke, dev)
    if "support" in args.sections:
        support(chip_smoke, dev, timed)
    if "routes" in args.sections:
        routes(chip_smoke, dev)
    torch.cuda.synchronize()
    return 0


# The sources each section builds.
SECTIONS = {"lanes": ("ed25519_msm", "ed25519_staged", "ed25519_verify"),
            "walk": ("dag_window",), "reach": ("dag_window",), "commit": ("dag_window",),
            "reduce": ("ed25519_msm", "ed25519_staged"),
            "steps": ("dag_window", "ed25519_msm", "ed25519_staged", "ed25519_verify"),
            "window": ("dag_window",), "support": ("dag_window",), "routes": ("dag_window",)}


def decompress(chip_smoke, ed25519, dev, bucket, timed) -> None:
    """A3 through its wrapper on decompress_rows, held against its plain
    version first."""
    import numpy as np
    import torch

    rows, signs = chip_smoke.decompress_rows(np.random.default_rng(bucket), bucket)
    y, sg = torch.from_numpy(rows).to(dev), torch.from_numpy(signs).to(dev)
    pts, valid = ed25519.verify_decompress(y, sg)
    p_pts, p_valid = ed25519.verify_decompress_plain(y, sg)
    chip_smoke._same_bits("A3 valid", valid, p_valid)
    if chip_smoke._mod_p(pts.cpu().numpy()) != chip_smoke._mod_p(p_pts.cpu().numpy()):
        raise AssertionError("A3: coordinates differ mod p")
    timed(f"A3 verify_decompress decompress_rows B={bucket}",
          lambda: ed25519.verify_decompress(y, sg))


def straus(chip_smoke, ed25519, dev, bucket, timed) -> None:
    """A1 on signature_bucket's rows and A4 on their A set, held against
    their plain versions first."""
    import torch

    t = [torch.from_numpy(a).to(dev) for a in chip_smoke.signature_bucket(7, 300, bucket)[0]]
    strict, cof = ed25519.verify_batch(*t)
    p_strict, p_cof = ed25519.verify_batch_plain(*t)
    chip_smoke._same_bits("A1 strict", strict, p_strict)
    chip_smoke._same_bits("A1 cofactored", cof, p_cof)
    timed(f"A1 verify_batch B={bucket}", lambda: ed25519.verify_batch(*t))
    a_pt, _ = ed25519.verify_decompress(t[0], t[1])
    acc = ed25519.verify_straus(a_pt, t[4], t[5])
    chip_smoke._same_points("A4", acc, ed25519.verify_straus_plain(a_pt, t[4], t[5]))
    timed(f"A4 verify_straus B={bucket}", lambda: ed25519.verify_straus(a_pt, t[4], t[5]))


def verdict(chip_smoke, ed25519, dev, bucket, timed) -> None:
    """A5 on signature_bucket's rows (A3 and A4 outputs), held against its
    plain version first and timed."""
    import torch

    t = [torch.from_numpy(a).to(dev) for a in chip_smoke.signature_bucket(7, 300, bucket)[0]]
    a_pt, a_valid = ed25519.verify_decompress(t[0], t[1])
    r_pt, r_valid = ed25519.verify_decompress(t[2], t[3])
    acc = ed25519.verify_straus(a_pt, t[4], t[5])
    args = (acc, r_pt, t[2], t[3], a_valid, r_valid)
    strict, cof = ed25519.verify_verdict(*args)
    p_strict, p_cof = ed25519.verify_verdict_plain(*args)
    chip_smoke._same_bits("A5 strict", strict, p_strict)
    chip_smoke._same_bits("A5 cofactored", cof, p_cof)
    timed(f"A5 verify_verdict B={bucket}", lambda: ed25519.verify_verdict(*args))


def commit(chip_smoke, dev, timed) -> None:
    """B7 at chip_smoke.COMMIT_SHAPES (the path's: the consensus step's on
    B6's masks, the dry run's and the 2 x 2 mesh's shard blocks; then the
    rest), each held against its plain version first."""
    import numpy as np
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    rng = np.random.default_rng(16)
    host = chip_smoke.reach_many_inputs(rng, 64, 50, 64, 56)
    b6 = dk.reach_many(*(torch.from_numpy(a).to(dev) for a in host))
    for label, b, w, m, s, offset, stakes in chip_smoke.COMMIT_SHAPES:
        t = chip_smoke.commit_inputs(rng, dev, b, w, m, s, offset, stakes,
                                     b6 if label == "consensus step" else None)
        kc, kl = dk.consensus_commit(*t)
        pc, pl = dk.consensus_commit_plain(*t)
        chip_smoke._same_bits(f"B7 {label} committed", kc, pc)
        chip_smoke._same_bits(f"B7 {label} new_last", kl, pl)
        timed(f"B7 consensus_commit {label} B={b} W={w} M={m} S={s}",
              lambda: dk.consensus_commit(*t))


# B2's shapes off the main path, which the wide walk serves: (W, N, leader
# row) for committees of 65, 200 and 1024 and a window of 512 rows at N = 50
# (its tables outgrow shared memory).
WIDE_SHAPES = ((64, 65, 58), (64, 200, 58), (64, 1024, 58), (512, 50, 506))
# and (W, N) of healed-partition chains of two leaders, where the first
# leader's walk leaves half the committee's present, uncommitted columns
# unreached: each scans the whole frontier, the wide walk's slowest case.
HEALED_WIDE = ((64, 200), (64, 1024))


def walk(chip_smoke, dev, timed) -> None:
    """B2 at the main path's shape: from row 58, from row 2, and the leader
    four times over (three more walks of 58 rows that find nothing new);
    then at WIDE_SHAPES on chip_smoke.chain_inputs (one leader) and on the
    HEALED_WIDE chains."""
    import numpy as np
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    host = chip_smoke.healed_partition_chain(np.random.default_rng(13), 64, 50,
                                             chip_smoke.GC_DEPTH, 1, 1)
    parent, present, lc, lcr, offs, onehots = host
    t = [torch.from_numpy(a).to(dev) for a in (parent, present, lc, offs, onehots)]
    gc = chip_smoke.GC_DEPTH
    cases = {"row 58": (t[3], t[4]),
             "row 2": (torch.full_like(t[3], 2), t[4]),
             "row 58 x4": (t[3].repeat(4), t[4].repeat(4, 1))}
    for name, (o, h) in cases.items():
        got = dk.chain_commit(t[0], t[1], gc, t[2], lcr, o, h)
        chip_smoke._same_bits(f"B2 {name}", got,
                              dk.chain_commit_plain(t[0], t[1], gc, t[2], lcr, o, h))
        timed(f"B2 chain_commit W=64 N=50 {name}",
              lambda: dk.chain_commit(t[0], t[1], gc, t[2], lcr, o, h))
    for w, n, row in WIDE_SHAPES:
        parent, present, lc, lcr, offs, onehots = chip_smoke.chain_inputs(
            np.random.default_rng(w + n), w, n, (row,))
        t = [torch.from_numpy(a).to(dev) for a in (parent, present, lc, offs, onehots)]
        args = (t[0], t[1], gc, t[2], lcr, t[3], t[4])
        chip_smoke._same_bits(f"B2 W={w} N={n}", dk.chain_commit(*args),
                              dk.chain_commit_plain(*args))
        timed(f"B2 chain_commit W={w} N={n} row {row}", lambda: dk.chain_commit(*args))
    for w, n in HEALED_WIDE:
        parent, present, lc, lcr, offs, onehots = chip_smoke.healed_partition_chain(
            np.random.default_rng(w + n), w, n, gc, 2, 2)
        t = [torch.from_numpy(a).to(dev) for a in (parent, present, lc, offs, onehots)]
        args = (t[0], t[1], gc, t[2], lcr, t[3], t[4])
        chip_smoke._same_bits(f"B2 W={w} N={n} healed", dk.chain_commit(*args),
                              dk.chain_commit_plain(*args))
        timed(f"B2 chain_commit W={w} N={n} healed K=2 rows {offs.tolist()}",
              lambda: dk.chain_commit(*args))


def reach(chip_smoke, dev, timed) -> None:
    """B6 through the wrapper at the kernels phase's shape,
    chip_smoke.REACH_SHAPES and the consensus step's window."""
    import numpy as np
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    rng = np.random.default_rng(14)
    cases = [("sparse", 64, 50, 64, 56, None), *chip_smoke.REACH_SHAPES,
             ("consensus", 64, 50, 64, 64, 0.3)]
    for label, w, n, K, live, density in cases:
        if label == "consensus":
            host = chip_smoke.consensus_reach_inputs(rng, w, n, K)
        else:
            host = chip_smoke.reach_many_inputs(rng, w, n, K, live, density)
        t = [torch.from_numpy(a).to(dev) for a in host]
        tag = f"B6 reach_many {label} W={w} N={n} K={K} ({live} live)"
        plain = dk.reach_many_plain(*t)
        chip_smoke._same_bits(tag, dk.reach_many(*t), plain)
        timed(tag, lambda: dk.reach_many(*t))


def reduce(chip_smoke, ed25519, dev, timed) -> None:
    """A6' over k = 2 and 4 shards of the item bucket (B = 2048), both lane
    sets, as the sharded msm bucket calls it: one call where the package's
    msm_shard_reduce takes both sets, else a stack and a launch a set."""
    import inspect

    import torch

    both = "parts_r" in inspect.signature(ed25519.msm_shard_reduce).parameters
    t = [torch.from_numpy(a).to(dev) for a in chip_smoke.msm_item_bucket(23, 300, 2048)[0]]
    pa, _ = ed25519.verify_decompress(t[0], t[1])
    pr, _ = ed25519.verify_decompress(t[2], t[3])
    for k in (2, 4):
        parts_a, parts_r = chip_smoke.shard_lane_sets(pa, pr, t[4], t[5], k)
        if both:
            call = lambda: ed25519.msm_shard_reduce(parts_a, parts_r)  # noqa: E731
        else:
            call = lambda: (ed25519.msm_shard_reduce(torch.stack(parts_a)),  # noqa: E731
                            ed25519.msm_shard_reduce(torch.stack(parts_r)))
        for got, parts in zip(call(), (parts_a, parts_r)):
            chip_smoke._same_points(f"A6' k={k}", got,
                                    ed25519.msm_shard_reduce_plain(torch.stack(parts)))
        timed(f"A6' msm_shard_reduce k={k} A and R sets "
              + ("(one call)" if both else "(a stack and a launch a set)"), call)


# Runs of each step in section `steps` (the dry run takes ~50 ms).
STEP_REPS = {"consensus_step": 60, "dryrun": 20}


def steps(chip_smoke, dev) -> None:
    """The consensus step and the dry run as chip_smoke.py's phases run
    them, each once untimed, then STEP_REPS runs timed on the host clock
    (the step's outputs copied back, so the card has finished)."""
    import numpy as np
    import torch
    from narwhal_tpu_torch import entry as tentry
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    host = chip_smoke.support_inputs(np.random.default_rng(18), 64, 50, 64, 0.3)

    def consensus_step():
        return [x.cpu() for x in dk.consensus_step(*(torch.from_numpy(a).to(dev) for a in host))]

    def dryrun():
        fn, args = tentry.entry(device=dev)
        fn(*args).cpu()
        tentry.dryrun_multichip(4, devices=[dev] * 4)

    for name, fn in (("consensus_step", consensus_step), ("dryrun", dryrun)):
        fn()
        walls = []
        for _ in range(STEP_REPS[name]):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(walls, [25, 50, 75])
        print(f"step {name}: host wall median {med:.4f} ms, quartiles {q1:.4f}-{q3:.4f} "
              f"over {len(walls)} runs", flush=True)


# Section `window`: the windows, slot counts and shifts at N = 50, and the
# replays of the engine stream's views.
WINDOW_WS = (64, 128)
WINDOW_TS = (1, 64, 128)
WINDOW_SHIFTS = (0, 1)
VIEW_REPLAYS = 5


def window(chip_smoke, dev, timed) -> None:
    """B4, B3 and the sync of a view through the package's wrappers, each
    held against the plain roll then place first."""
    import numpy as np
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    n = 50
    sync = getattr(dk, "sync_window", None)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for w in WINDOW_WS:
        rng = np.random.default_rng(w)
        p, q = (up(a) for a in chip_smoke._random_window(rng, w, n))
        for shift in WINDOW_SHIFTS:
            chip_smoke._same_bits(f"B4 W={w} shift={shift}",
                                  torch.cat([x.flatten() for x in dk.roll_window(p, q, shift)]),
                                  torch.cat([x.flatten()
                                             for x in dk.roll_window_plain(p, q, shift)]))
            timed(f"B4 roll_window W={w} N={n} shift={shift}",
                  lambda: dk.roll_window(p, q, shift))
        for T in WINDOW_TS:
            offs, idxs, rows = chip_smoke.sync_slots(rng, w, n, T)
            valid = np.ones(T, np.uint8)

            def place(pp, qq):
                if sync is None:  # the slots uploaded as that package's device_view does
                    return dk.place_batch(pp, qq, up(offs), up(idxs), up(rows), up(valid))
                return dk.place_batch(pp, qq, offs, idxs, rows, valid)

            def view(pp, qq, shift):
                if sync is not None:
                    return dk.sync_window(pp, qq, shift, offs, idxs, rows)
                if shift:
                    pp, qq = dk.roll_window(pp, qq, shift)
                return place(pp, qq)

            def plain(pp, qq, shift):
                pp, qq = dk.roll_window_plain(pp, qq, shift)
                return dk.place_batch_plain(pp, qq, *(up(a) for a in (offs, idxs, rows, valid)))

            for shift in WINDOW_SHIFTS:
                got, want = view(p.clone(), q.clone(), shift), plain(p.clone(), q.clone(), shift)
                chip_smoke._same_bits(f"sync W={w} T={T} shift={shift}",
                                      torch.cat([x.flatten() for x in got]),
                                      torch.cat([x.flatten() for x in want]))
            wp, wq = p.clone(), q.clone()
            timed(f"B3 place_batch W={w} N={n} T={T}", lambda: place(wp, wq))
            for shift in WINDOW_SHIFTS:
                timed(f"sync W={w} N={n} T={T} shift={shift} "
                      + ("(sync_window)" if sync is not None else "(roll, then place)"),
                      lambda: view(wp, wq, shift))


# The grid shapes of window_sync the section sweeps: bytes of a parent row
# a CTA (0: the kernel's default, 640 at N = 50; 16384 a CTA a row; 1280,
# 640, 320 and 160 split a 2,500-byte row over 2, 4, 8 and 16 CTAs) and
# threads a CTA.
GRID_CHUNKS = (0, 16384, 1280, 640, 320, 160)
GRID_THREADS = (64, 128, 256)


def window_grid(chip_smoke, dev, timed) -> None:
    """sync_window's grid at N = 50, W = 64 and 128, shift 1, T = 0 (the
    roll alone) and 64: each shape held against the plain roll then place,
    then timed. A package whose sync_window takes no grid is skipped."""
    import inspect

    import numpy as np
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    if "chunk" not in inspect.signature(getattr(dk, "sync_window", lambda: None)).parameters:
        print("window grid: this package's sync_window takes no grid", flush=True)
        return
    n, shift = 50, 1
    for w in WINDOW_WS:
        rng = np.random.default_rng(w + 1)
        p, q = (torch.from_numpy(a).to(dev) for a in chip_smoke._random_window(rng, w, n))
        for T in (0, 64):
            offs, idxs, rows = chip_smoke.sync_slots(rng, w, n, T)
            want = dk.sync_window_plain(p, q, shift, offs, idxs, rows)
            for chunk in GRID_CHUNKS:
                for threads in GRID_THREADS:
                    def run():
                        return dk.sync_window(p, q, shift, offs, idxs, rows, chunk=chunk,
                                              threads=threads)

                    chip_smoke._same_bits(f"grid W={w} T={T} chunk={chunk} threads={threads}",
                                          torch.cat([x.flatten() for x in run()]),
                                          torch.cat([x.flatten() for x in want]))
                    timed(f"grid W={w} N={n} T={T} shift={shift} chunk={chunk} "
                          f"threads={threads}", run)


def view_replay(chip_smoke, dev) -> None:
    """The host wall of DagWindow.device_view as GpuBullshark calls it on
    the engine phase's stream: the calls recorded once on the card, then
    replayed on fresh windows, each view timed alone (the card idle before
    it)."""
    import cProfile
    import pstats

    import numpy as np
    import torch
    from narwhal_tpu_torch.consensus import ConsensusState
    from narwhal_tpu_torch.fixtures import CommitteeFixture
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu import kernel_registry
    from narwhal_tpu_torch.types import Certificate

    f = CommitteeFixture(size=50)
    eng = dk.GpuBullshark(f.committee, None, chip_smoke.GC_DEPTH, device=dev)
    w0 = eng.win.W
    calls = []  # (cert, keep_floor) for an insert, None for a view
    insert, view = eng.win.insert, eng.win.device_view

    def rec_insert(cert, keep_floor):
        calls.append((cert, keep_floor))
        return insert(cert, keep_floor)

    def rec_view():
        calls.append(None)
        return view()

    eng.win.insert, eng.win.device_view = rec_insert, rec_view
    chip_smoke.feed_rounds(eng, ConsensusState(Certificate.genesis(f.committee)),
                           chip_smoke.engine_stream(f, 200, 3), 50)
    walls, ends, slots, kinds = [], [], [], {"upload": 0, "sync": 0, "none": 0}
    torch.cuda.synchronize()
    kernel_registry.reset_launch_counts()
    for _ in range(VIEW_REPLAYS):
        win = dk.DagWindow(f.committee, w0, device=dev)
        for call in calls:
            if call is not None:
                win.insert(*call)
                continue
            if win._dev is None or win._dev_stale:
                kind = "upload"
            elif win.round_base != win._dev_base or win._dev_pending:
                kind = "sync"
                pend = win._dev_pending  # (round, idx) pairs, or a flat list of them
                slots.append(len(pend) if isinstance(pend[0], tuple) else len(pend) // 2)
            else:
                kind = "none"
            kinds[kind] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            win.device_view()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if kind == "sync":
                walls.append((t1 - t0) * 1e3)
                ends.append((t2 - t0) * 1e3)
    launches = {k: v for k, v in kernel_registry.launch_counts().items() if v}
    # One more replay under cProfile: where a view's host time goes.
    prof = cProfile.Profile()
    win = dk.DagWindow(f.committee, w0, device=dev)
    for call in calls:
        if call is not None:
            win.insert(*call)
            continue
        torch.cuda.synchronize()
        prof.runcall(win.device_view)
    top = pstats.Stats(prof).sort_stats("tottime")
    rows = sorted(top.stats.items(), key=lambda kv: -kv[1][2])[:8]
    print("device_view profiled (own us a view): " + ", ".join(
        f"{fn[2]} {tt / calls.count(None) * 1e6:.1f}" for fn, (_c, _n, tt, _ct, _cl) in rows),
        flush=True)
    for label, xs in (("host wall", walls), ("to the card's end", ends)):
        q1, med, q3 = np.percentile(xs, [25, 50, 75])
        print(f"device_view {label}: median {med:.4f} ms, quartiles {q1:.4f}-{q3:.4f} over "
              f"{len(xs)} views that roll or place", flush=True)
    print(f"device_view replays: {VIEW_REPLAYS} x {calls.count(None)} views ({kinds}); "
          f"pending slots a syncing view: median {np.median(slots):.0f}, max {max(slots)}; "
          f"launches {launches}", flush=True)


_PHASE_LIB = []


def phases(ed25519, kernel_registry, dev, t, pa, pr, tag) -> None:
    """The chain kernel's phases (a build with -DMSM_PHASE_TIMES), launched
    with the wrappers' arguments: A2 on the bucket t, A6 on its A and R
    sets pa and pr."""
    import ctypes
    import subprocess

    import numpy as np
    import torch

    if not _PHASE_LIB:
        out = kernel_registry.BUILD_DIR / "ed25519_msm-phases.so"
        subprocess.run([kernel_registry.nvcc(), *kernel_registry.NVCC_FLAGS, "-DMSM_PHASE_TIMES",
                        "-o", str(out), str(kernel_registry.CSRC / "ed25519_msm.cu")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ed25519_msm_window.argtypes = [P] * 5 + [I] * 5 + [P]
        lib.ed25519_msm_accumulate.argtypes = [P] * 11 + [I] * 4 + [P]
        lib.ed25519_msm_phase_times.argtypes = [P]
        _PHASE_LIB.append(lib)
    lib = _PHASE_LIB[0]
    consts = ed25519._const("KERNEL_CONSTS", dev)
    stream = torch.cuda.current_stream().cuda_stream
    B = t[0].shape[0]
    runs = []
    for name, lanes in (("A2", (64, 32)), ("A6 64 lanes", (64, 0)), ("A6 32 lanes", (32, 0))):
        plan = ed25519.msm_plan("msm_window", B, *lanes)
        geo = (plan["ctas"], plan["tile"], plan["smem"])
        sums = torch.empty((plan["ctas"] * sum(lanes) * 40,), dtype=torch.int32, device=dev)
        v = torch.empty((2, 4, 20, 64), dtype=torch.int32, device=dev)
        valid = torch.empty((B,), dtype=torch.bool, device=dev)
        if name == "A2":
            ptrs = [x.data_ptr() for x in (*t, consts, sums, v[0], v[1], valid)]
            call = lambda: lib.ed25519_msm_accumulate(*ptrs, B, *geo, stream)  # noqa: E731
        else:
            pts, dig = (pa, t[4]) if lanes[0] == 64 else (pr, t[5])
            ptrs = [x.data_ptr() for x in (pts, dig, consts, sums, v[0])]
            call = lambda: lib.ed25519_msm_window(*ptrs, B, lanes[0], *geo, stream)  # noqa: E731
        for _ in range(3):
            if call() != 0:
                raise RuntimeError(f"{name}: the phase-timed launch failed")
            torch.cuda.synchronize()
        stamps = np.zeros((128, 4), np.uint64)
        if lib.ed25519_msm_phase_times(stamps.ctypes.data) != 0:
            raise RuntimeError("reading the phase times failed")
        ts = stamps[:plan["ctas"]].astype(np.int64)
        rel = (ts - ts[:, 0].min()) / 1e3
        runs.append(f"{name}: stage {np.median(rel[:, 1] - rel[:, 0]):.1f} us, tables "
                    f"{np.median(rel[:, 2] - rel[:, 1]):.1f}, chains "
                    f"{np.median(rel[:, 3] - rel[:, 2]):.1f}, last CTA done {rel[:, 3].max():.1f}")
    print(f"phases {tag}: " + "; ".join(runs), flush=True)


def support(chip_smoke, dev, timed) -> None:
    """B5 at the consensus step's shape, B = 1 and 200, and a 2 x 2 mesh's
    shard block, each held against its plain version first."""
    import numpy as np
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    parent, present, stakes, offs, _oh, leaders, _last = chip_smoke.support_inputs(
        np.random.default_rng(15), 64, 50, 64, 0.3)
    shapes = {"B=64": (parent, present, stakes, offs, leaders)}
    for b in (1, 200):
        p, q, st, o, _h, ld, _l = chip_smoke.support_inputs(np.random.default_rng(b), 64, 50,
                                                            b, 0.3)
        shapes[f"B={b}"] = (p, q, st, o, ld)
    shapes["shard block M=25 B=32"] = (np.ascontiguousarray(parent[..., :25]), present, stakes,
                                       offs[:32], leaders[:32] % 25)
    for label, host in shapes.items():
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host]
        chip_smoke._same_bits(f"B5 {label}", dk.leader_support(*t), dk.leader_support_plain(*t))
        timed(f"B5 leader_support W=64 N=50 {label}", lambda: dk.leader_support(*t))


def routes(chip_smoke, dev) -> None:
    """The sharded compositions forced onto each route of the package, on
    this card: events ms a call and the launches of one call."""
    import numpy as np
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu import kernel_registry
    from narwhal_tpu_torch.gpu import mesh as mesh_mod

    mesh = mesh_mod.auth_mesh(2, devices=[dev] * 2)
    grid = mesh_mod.auth_mesh(2, devices=[dev] * 4, data=2)
    chain = chip_smoke.healed_partition_chain(np.random.default_rng(19), 64, 50, 50, 1, 1)
    parent, present, lc, lcr, offs, onehots = chain
    t = [torch.from_numpy(a).to(dev) for a in (parent, present, lc, offs, onehots)]
    want_c = dk.chain_commit(t[0], t[1], 50, t[2], lcr, t[3], t[4])
    rin = chip_smoke.reach_many_inputs(np.random.default_rng(21), 64, 50, 64, 56)
    want_r = dk.reach_many(*(torch.from_numpy(a).to(dev) for a in rin))
    step = chip_smoke.support_inputs(np.random.default_rng(18), 64, 50, 64, 0.3)
    want_s = [x.cpu() for x in dk.consensus_step(*(torch.from_numpy(a).to(dev) for a in step))]
    calls = {
        "chain_commit_sharded K=1 row 58": (
            lambda r: dk.chain_commit_sharded(mesh, parent, present, 50, lc, lcr, offs, onehots,
                                              route=r), want_c),
        "reach_many_sharded K=64": (lambda r: dk.reach_many_sharded(mesh, *rin, route=r),
                                    want_r),
        "consensus_step_sharded 2x2 B=64": (
            lambda r: dk.consensus_step_sharded(grid, *step, route=r), want_s),
    }
    for r in mesh_mod.ROUTES:
        for name, (fn, want) in calls.items():
            got = fn(r)
            if isinstance(want, list):
                for a, b in zip(got, want):
                    chip_smoke._same_bits(f"{name} {r}", a.cpu(), b)
            else:
                chip_smoke._same_bits(f"{name} {r}", got, want)
            kernel_registry.reset_launch_counts()
            fn(r)
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernel_registry.launch_counts().items() if v}
            ms = chip_smoke.time_ms(lambda: fn(r), dev, reps=5)
            print(f"route {r} {name}: events {ms:.4f} ms a call, launches {launches}",
                  flush=True)


if __name__ == "__main__":
    t0 = time.time()
    rc = main()
    print(f"msm_breakdown: {time.time() - t0:.1f} s", flush=True)
    sys.exit(rc)
