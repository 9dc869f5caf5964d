#!/usr/bin/env python3
"""Per-launch device times of the window-lane kernels, A1, A3, A4, B2, B6 and
A6' on one NVIDIA card.

    python3 msm_breakdown.py [--package DIR] [--bucket B ...] [--phases]
                             [--sections S ...]

For each bucket (default the verifier's 2048 rows and a shard's 1024): A2
`msm_accumulate` on the group-lane and item buckets of `chip_smoke.py`, A6
`msm_window` on their A (64 lanes) and R (32 lanes) sets and A3
`verify_decompress` on their A set and on `chip_smoke.decompress_rows`
(the edge encodings); A1 `verify_batch` on `chip_smoke.signature_bucket`
(forged, torsion, zero and random-limb rows) and A4 `verify_straus` on its
A set decompressed by A3. Then B2 `chain_commit`
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
bit for bit, lanes as affine points). Section `steps`: the host wall of
two steps `chip_smoke.py` times once each, repeated: the unmeshed
consensus step (B = 64 walks on its W = 64, N = 50 window, copies in and
out) and the dry run (`entry()`'s walk, then `dryrun_multichip(4)` over
this card four times); the median and quartiles over `STEP_REPS` runs.
`--sections` picks among `lanes` (A2, A6, A3, A1, A4; the default runs
every section), `walk` (B2), `reach`, `reduce` and `steps`.

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
    if "walk" in args.sections:
        walk(chip_smoke, dev, timed)
    if "reach" in args.sections:
        reach(chip_smoke, dev, timed)
    if "reduce" in args.sections:
        reduce(chip_smoke, ed25519, dev, timed)
    if "steps" in args.sections:
        steps(chip_smoke, dev)
    torch.cuda.synchronize()
    return 0


# The sources each section builds.
SECTIONS = {"lanes": ("ed25519_msm", "ed25519_staged", "ed25519_verify"),
            "walk": ("dag_window",), "reach": ("dag_window",),
            "reduce": ("ed25519_msm", "ed25519_staged"),
            "steps": ("dag_window", "ed25519_msm", "ed25519_staged", "ed25519_verify")}


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


if __name__ == "__main__":
    t0 = time.time()
    rc = main()
    print(f"msm_breakdown: {time.time() - t0:.1f} s", flush=True)
    sys.exit(rc)
