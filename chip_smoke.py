#!/usr/bin/env python3
"""Drive the PyTorch port's certificate and DAG paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
  build     print the card (nvidia-smi name and power limit), build every
            CUDA kernel of the path from `narwhal_tpu_torch/gpu/csrc/` (one
            nvcc per source, all started together) and print each build
            wall (nvcc logs under chiprun_out/chip_smoke/);
  kernels   each kernel against its plain PyTorch version on the same card
            tensors at the main path's shapes (N = 50, W = 64, 2048-row
            buckets; window_sync, a view's roll and placements, at W = 64
            and 128, N = 50 and 49, T = 64 and past a parameter block,
            shifts 0, 1, W - 1 and W, and through B4 roll_window and B3
            place_batch, each of those with its library call's time;
            chain_commit on a healed partition where the gc filter
            provably bites; msm_accumulate in the group-lane shape, 20
            compact proofs of 50 signers as 2000 doubled rows plus 48 zero
            rows, and in the item shape with real R and z digits, a torsion
            row and an invalid encoding; reach_many at K = 64 with padding
            slots, W = 64 and 128, the Dag service's dense window at W =
            64 and 128 with K = 1, 8, 64, the consensus step's window with
            its uncommitted mask, and N = 65, 200 and W = 512 (the wide
            route; each shape's route logged); the staged kernels of the sharded
            verifier at B = 2048: verify_decompress on the item bucket's A
            and R sets, verify_straus and verify_verdict on its output,
            msm_window on the msm item and group buckets' A (64 lanes) and
            R (32 lanes) sets, msm_shard_reduce over 2 and 4 shards (both
            lane sets in one launch); A2
            and A3 -> A6 again at B = 16, 512, 1024 (a shard's rows) and
            8192 (two tiles of shared memory) on both buckets; A1, A4 and
            A3 -> A4 -> A5 again at B = 1, 7, 1024 and 8192 (verify_rows:
            torsion, forged, zero and random-limb rows), and A5 alone at
            those B and 2048 (R from the plain A3's loose limbs, rows of
            random limbs, validity bits flipped);
            leader_support at B = 64 (rows 0 and W - 1 among the offsets;
            then an out-of-range offset and an out-of-range leader, each
            raising the CPU's ValueError from the kernel's error words, the
            call's other walks equal to the plain version without it),
            consensus_commit at COMMIT_SHAPES (B6's K = 64 masks, the dry
            run's and the 2 x 2 mesh's shard blocks, N = 200 and 1024, one
            walk, an unaligned slab and a misaligned view, a wrapping stake
            sum; support at quorum and one below), one launch each;
            sharded_walk over 2 and 4 shards of the card (N = 50 padded
            to 52) on the "cluster" route and on "peer" and "host" forced
            (a launch per shard), against its plain version, chain_commit
            (chain mode, K = 1, 2, 4 on the healed-partition chains) and
            reach_many (many mode, K = 64 at W = 64 and 128), and the
            compositions chain_commit_sharded / reach_many_sharded on every
            route against B2 / B6; one exchange of each of "peer" and
            "host" reused across modes and walk counts; then a missing peer
            (one of two launches issued, a 100 ms deadline) must raise on
            both), with
            kernel / plain / library times from CUDA events (median of
            repeats; for msm_accumulate and msm_window also
            torch.profiler's device time by launch and ptxas's figures).
            Verdicts, masks and validity bit-equal;
            verify_decompress's coordinates equal mod p; msm_accumulate's,
            msm_window's and the reduce's window lanes and verify_straus's
            accumulators equal as affine points (canonical x and y), and
            the epilogue verdicts. The compositions against the monoliths:
            decompress -> straus -> verdict bit-equal to verify_batch,
            decompress -> msm_window (A, R) equal to msm_accumulate (lanes
            as points, validity bit-equal), the reduced shards equal to its
            V_a and V_r;
  engine    GpuBullshark.process_batch_async on the card over a lossy
            unsigned N = 50 DAG of 200 rounds, built so the window both
            slides and grows and chains of up to 4 leaders commit at once;
            the commit sequence must equal the same engine's on the CPU
            and the port's host Bullshark's;
  dag_shards
            GpuBullshark(mesh=auth_mesh(2)) (--dag-shards 2) over two cards,
            or the one card twice, on the engine phase's stream: the same
            sequence as the host Bullshark and the unmeshed card engine,
            through the sharded walk only (chain_commit and window_sync
            launch 0 times): one sharded_walk launch per card per commit
            event on the mesh's route ("cluster" on one card, "peer" or
            "host" across cards); then the same on the "host" route forced
            where the mesh's is another, counted apart. Certificates/s
            beside the engine's;
  pipeline  FusedCertificatePipeline (strict item lane) on the card,
            continuing the engine phase's engine, over a fully signed
            N = 50 stream of the next 12 rounds (600 certificates x 50
            votes, batches of 40 certificates = 2000 items per 2048 bucket)
            with forged certificates mixed in: exactly the forged ones are
            rejected and the sequence equals the CPU engine's on the
            accepted stream; then the same run again under torch.profiler
            gives the card's busy and idle share and the host stages;
  compact   the same 12 rounds as compact certificates (half-aggregated
            from the pipeline phase's own vote signatures, no new signing)
            through FusedCertificatePipeline's group lane, on an engine
            brought to the same start state by replaying the unsigned
            stream, with the same 3 certificates forged (one bit of agg_s):
            exactly those rejected after exactly 3 host re-checks, and the
            sequence equals the CPU engine's and the pipeline phase's; then
            profiled as the pipeline phase is, with the host epilogue timed;
  service   VerifyService.shared("item") serves the compact groups and a
            2048-item burst of header signatures concurrently from an
            asyncio loop; VerifyService.shared("msm") then checks one bucket
            of valid vote signatures (the msm check alone: no verify_batch
            launch) and one with a forged and a torsion item (verify_batch
            fallback, cofactored: forged rejected, torsion accepted).
  sharded   VerifyService.shared("item" and "msm", shards=k) over every
            card (k = the card count), or over the one card twice, on the
            service phase's inputs: every verdict equal to the unsharded
            services', through the staged kernels and the shard reduce
            only (verify_batch and msm_accumulate launch 0 times);
  tusk      GpuTusk.process_batch_async on the card over another lossy
            N = 50 DAG of 200 rounds built like the engine phase's: the
            sequence must equal the port's host Tusk's and the CPU engine's;
  runner    consensus.Consensus (the consensus runner) over GpuBullshark on
            the card and a durable NodeStorage in a temporary directory on
            the native storage engine, fed the engine phase's stream: each
            certificate group-committed to the certificate store before it
            is sent, in bursts of two rounds (the runner drains 64 a pass
            into process_batch_async) and every tenth round one certificate
            at a time (process_certificate_async); after round 100 the
            input drains, the shutdown goes out on the Watch, the storage
            closes and reopens on the same directory, and a new engine and
            Consensus recover from it (new_from_store, GpuBullshark.recover)
            and take rounds 101-200. The joined outputs, the tx_primary
            stream and the ConsensusStore record must equal the port's host
            Bullshark's over the stream without a stop. Then GpuTusk (a
            stream built like the tusk phase's) against the host Tusk, and
            Bullshark again on the Python WAL (NARWHAL_NATIVE=0) over 60
            rounds restarted after 30, inside a stretch without commits.
            Prints certificates/s, the commit stage's p50 and p99 from a
            Tracer behind ConsensusMetrics, and StorageStats' groups;
  dag_service
            the external-consensus Dag service: 200 rounds of N = 50
            certificates, about half with an empty payload, fed through
            Dag.spawn() on a Channel into Dag(backend="cuda",
            policy="device") and a host Dag(backend="cpu"), with the
            certificates below the GC horizon removed every 10 rounds (not
            in rounds 70..109, so the window grows once); at rounds 70
            (W = 64) and 200 (W = 128) bursts of K in (1, 8, 64) concurrent
            read_causal and node_read_causal calls over starts spread
            across the live window (and one read at round 150, so the
            grown window slides on the card): every answer equals the host
            service's, reach_many launches once per fused dispatch; then
            the same stream and
            reads through an adaptive Dag(backend="cuda"), whose answers
            must equal the host's too and whose routing_stats() give the
            router's verdict;
  consensus_step
            B7 on the card: B = 64 walks on an N = 50, W = 64 window
            through consensus_step (reach_many, leader_support,
            consensus_commit), then over a 2 x 2 data x auth mesh (four
            cards, or the card four times: the mesh's route, the path's
            launches read just after it; then the other routes forced,
            "host" included, each counted apart): every output equal;
  dryrun    narwhal_tpu_torch.entry: entry()'s walk on the card equals the
            plain reach; dryrun_multichip(4) over four cards, or the card
            four times, passes every check of its three legs.
Launch counts are set to 0 just before each of the eleven paths and read
just after it, and each path must have launched the kernels it names
(PATH_KERNELS; the script prints the sharded walk's route), and a path
that syncs a device window may launch window_sync at most once per view
that rolls or places, more only for a sync past a parameter block (the
views and those launches are counted where they happen, beside the launch
counts, and printed). Then one JSON line with every kernel's numbers
(launches summed over the paths and per path; the consensus_step phase's
forced routes apart, under "forced_route_launches"), and as the last line
{"ok": true, "device": {...}}.

The script needs a CUDA card: without one it exits 2 before printing any
result. It imports nothing of JAX and nothing of `narwhal_tpu`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# H100 SXM peaks used for the bounds (NVIDIA data sheet / Hopper white paper):
# HBM3 at 3.35 TB/s; 132 SMs x 64 INT32 lanes at the 1.98 GHz boost clock
# that the data sheet's 67 TFLOP/s fp32 figure implies = 16.73e12 32-bit
# integer multiply-adds per second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

N = 50  # the reference's largest published committee (bench-0-50-1-True-100000-512)
GC_DEPTH = 50  # the reference default (config.py Parameters.gc_depth)
W = GC_DEPTH + 14  # the engine's window
BUCKET = 2048  # the verifier's fixed bucket

# The kernels each driven path must launch (counts from 0 just before it).
PATH_KERNELS = {
    "engine": ("window_sync", "chain_commit"),
    "pipeline": ("verify_batch", "window_sync", "chain_commit"),
    "compact": ("msm_accumulate", "window_sync", "chain_commit"),
    "service": ("verify_batch", "msm_accumulate"),
    "tusk": ("window_sync", "chain_commit"),
    "runner": ("window_sync", "chain_commit"),
    "dag_service": ("reach_many", "window_sync"),
    "sharded": ("verify_decompress", "verify_straus", "verify_verdict", "msm_window",
                "msm_shard_reduce"),
    "dag_shards": ("sharded_walk",),
    "consensus_step": ("reach_many", "leader_support", "consensus_commit", "sharded_walk"),
    "dryrun": ("reach_many", "sharded_walk", "leader_support", "consensus_commit",
               "verify_decompress", "verify_straus", "verify_verdict", "msm_window",
               "msm_shard_reduce"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def time_ms(fn, device, reps: int, groups: int = 5) -> float:
    """Median over `groups` of the mean time of `reps` back-to-back calls:
    CUDA events on the card, the host clock on the CPU (rehearsal only)."""
    import torch

    fn()  # warm up
    samples = []
    for _ in range(groups):
        if device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            samples.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(samples)


def device_breakdown(fn, device, reps: int = 20) -> tuple[float | None, dict]:
    """Device time of one call of `fn` from torch.profiler, for a call that
    launches each of its kernels once: by kernel name the mean duration of
    its captured launches (the profiler drops some now and then), and their
    sum, in ms. A capture without any kernel is taken again, up to three
    times. (None, {}) off the card or without a capture."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None, {}
    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per: dict[str, float] = {}
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0)
            if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
                name = evt.key.replace("(anonymous namespace)::", "").split("(")[0]
                name = name.replace("void ", "").strip()
                per[name] = per.get(name, 0.0) + dev_us / evt.count / 1e3
        if per:
            return sum(per.values()), per
    log("  device_breakdown: the profiler captured no kernel three times; no device time")
    return None, {}


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


# Each path's window syncs, read with its launches: the views that rolled or
# placed a window on the card (counted by DagWindow.device_view) and the
# window_sync launches past a sync's first (counted by the wrapper when a
# sync's slots fill more than one parameter block).
PATH_SYNCS: dict[str, dict] = {}


def require_launches(path: str, launches: dict, device) -> None:
    """Fail unless every kernel the path names launched on it (on the card;
    a CPU rehearsal launches nothing). A path that syncs a window may
    launch window_sync at most once a view that rolls or places, more only
    for a sync past a parameter block: launches <= views + the launches
    past a sync's first (the event counts, read with the launches)."""
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu import kernel_registry

    for k in PATH_KERNELS[path]:
        if device.type == "cuda" and launches[k] <= 0:
            raise AssertionError(f"{path}: {k} never launched")
    if "window_sync" in PATH_KERNELS[path]:
        events = kernel_registry.event_counts()
        views = events.get(dk.WINDOW_VIEWS, 0)
        extra = events.get(dk.SYNC_LAUNCHES_PAST_FIRST, 0)
        PATH_SYNCS[path] = {"views": views, "launches_past_first": extra}
        if device.type == "cuda" and launches["window_sync"] > views + extra:
            raise AssertionError(f"{path}: {launches['window_sync']} window_sync launches for "
                                 f"{views} syncing views and {extra} launches past a sync's "
                                 "first")
        log(f"{path}: {views} views rolled or placed, {launches['window_sync']} window_sync "
            f"launches ({extra} past a sync's first)")


# ---------------------------------------------------------------------------
# Phase: build
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    from narwhal_tpu_torch.gpu import kernel_registry

    walls = kernel_registry.build()
    os.makedirs(OUT_DIR, exist_ok=True)
    for stem, text in kernel_registry.build_logs().items():
        with open(os.path.join(OUT_DIR, f"nvcc_{stem}.log"), "w") as f:
            f.write(text)
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {stem}: {line.strip()}")
    for stem, wall in sorted(walls.items()):
        log(f"build {stem}.cu: {wall:.2f} s")
    return walls


def ptxas_report(stem: str) -> dict:
    """ptxas's figures for each kernel of `stem`'s build (nvcc -Xptxas -v):
    name<template args> -> "N registers, S bytes spill stores, M bytes smem"."""
    import re

    from narwhal_tpu_torch.gpu import kernel_registry

    out, name = {}, None
    for line in kernel_registry.build_logs().get(stem, "").splitlines():
        m = re.search(r"Compiling entry function '_Z(\w+)'", line)
        if m:
            sym = m.group(1)
            if sym.startswith("N"):  # a namespace (anonymous or named) before the name
                k = re.match(r"N(\d+)", sym)
                sym = sym[k.end() + int(k.group(1)):]
            k = re.match(r"(\d+)", sym)
            n = int(k.group(1))
            base, rest = sym[k.end():k.end() + n], sym[k.end() + n:]
            targs = rest.split("EEv")[0] + "E" if rest.startswith("I") else ""
            args = re.findall(r"L[ib](\d+)E", targs)
            name = base + (f"<{', '.join(args)}>" if args else "")
            out[name] = ""
        elif name and "spill stores" in line:
            out[name] = line.split(",")[1].strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = f"{regs} registers, {out[name]}" + (f", {smem.group(1)} bytes smem"
                                                             if smem else "")
    return out


# ---------------------------------------------------------------------------
# Phase: kernels against their plain versions
# ---------------------------------------------------------------------------


def _torsion_item(rng: random.Random):
    """A signature under a torsion-shifted public key A' = A + T (T of small
    order): strict verification rejects it, cofactored accepts it."""
    from narwhal_tpu_torch.gpu import ed25519_ref as ref

    while True:
        y = rng.randrange(ref.P)
        x = ref.recover_x(y, 0)
        if x is None:
            continue
        t = ref.point_mul(ref.L, (x, y, 1, x * y % ref.P))
        if t[0] % ref.P != 0 or (t[1] - t[2]) % ref.P != 0:
            break
    while True:
        a = rng.randrange(ref.L)
        pk = ref.compress(ref.point_add(ref.point_mul(a, ref.G), t))
        msg = b"torsion probe %d" % rng.randrange(1 << 30)
        r = rng.randrange(ref.L)
        r_bytes = ref.compress(ref.point_mul(r, ref.G))
        k = ref.sha512_mod_l(r_bytes, pk, msg)
        if k % 2 == 1:  # [k]T != identity for any non-identity 8-torsion T
            break
    s = (r + k * a) % ref.L
    return pk, msg, r_bytes + s.to_bytes(32, "little")


def signature_bucket(seed: int, n_keys: int, bucket: int):
    """A `bucket`-row verify input mixing valid signatures, corrupt R,
    corrupt S, wrong messages and torsion-defect signatures (rows reused to
    fill the bucket: signing is pure Python here), then padding rows that
    repeat row 0, all-zero rows and random-limb rows. Returns (the six
    host arrays, the items of the first rows, their count)."""
    from narwhal_tpu_torch.crypto import KeyPair
    from narwhal_tpu_torch.gpu.verifier import GpuVerifier

    rng = random.Random(seed)
    items = []
    for i in range(n_keys):
        kp = KeyPair.from_seed(rng.randbytes(32))
        msg = rng.randbytes(8 + i % 40)
        sig = kp.sign(msg)
        kind = i % 5
        if kind == 1:
            b = bytearray(sig)
            b[rng.randrange(31)] ^= 1 << rng.randrange(8)
            sig = bytes(b)
        elif kind == 2:
            b = bytearray(sig)
            b[32 + rng.randrange(31)] ^= 1 << rng.randrange(8)
            sig = bytes(b)
        elif kind == 3:
            msg = msg + b"!"
        items.append((kp.public, msg, sig))
    items += [_torsion_item(rng) for _ in range(4)]
    packer = GpuVerifier(mode="item", device="cpu")
    idx, packed = packer.pack(items)
    checked = [items[i] for i in idx]
    m = len(checked)
    n_pad, n_zero, n_junk = bucket // 64, bucket // 128, bucket // 128
    n_reuse = bucket - n_pad - n_zero - n_junk
    if n_reuse < m:
        raise ValueError(f"bucket {bucket} too small for {m} distinct rows")
    reuse = [i % m for i in range(n_reuse)]
    base = GpuVerifier.bucket_arrays(packed, 0, m, 0)
    arrays = [np.concatenate([a[reuse], np.repeat(a[:1], n_pad, axis=0)]) for a in base]
    nprng = np.random.default_rng(seed)
    extra = []
    for j, a in enumerate(arrays):
        z = np.zeros((n_zero + n_junk,) + a.shape[1:], a.dtype)
        if j in (0, 2):
            z[n_zero:] = nprng.integers(0, 1 << 13, (n_junk,) + a.shape[1:])
        elif j in (4, 5):
            z[n_zero:] = nprng.integers(0, 16, (n_junk,) + a.shape[1:])
        elif j in (1, 3):
            z[n_zero:] = nprng.integers(0, 2, (n_junk,))
        extra.append(np.ascontiguousarray(np.concatenate([a, z])))
    return extra, checked, m


def verify_rows(seed: int, n_keys: int, b: int):
    """A1's six host arrays at B = b: `signature_bucket`'s bucket of b rows
    when b >= 1024, else the first b of eight rows of its 128-row bucket
    (at most 16 keys): the last checked row (a torsion-defect item), rows
    1-3 (corrupt R, corrupt S, a wrong message), a zero row, a random-limb
    row, row 0 (a valid signature) and a padding row."""
    if b >= 1024:
        return signature_bucket(seed, n_keys, b)[0]
    arrays, _checked, m = signature_bucket(seed, min(n_keys, 16), 128)
    pick = [m - 1, 1, 2, 3, 126, 127, 0, 124][:b]
    return [np.ascontiguousarray(a[pick]) for a in arrays]


VERIFY_SIZES = (1, 7, 1024, 8192)  # beside the bucket's 2048


def verdict_inputs(rng: np.random.Generator, acc, r_y, r_sign, a_valid, r_valid):
    """A5's six inputs off A1's path, from a bucket's accumulators and its R
    rows: R decompressed by the plain A3 (its loose limbs), acc and R of rows
    3, 7, 11, ... random radix-2^13 limbs up to 9500, and the validity bits
    of about a quarter of the rows flipped (invalid A, invalid R)."""
    import torch
    from narwhal_tpu_torch.gpu import ed25519

    dev, B = acc.device, acc.shape[2]
    r_pt, _ = ed25519.verify_decompress_plain(r_y, r_sign)
    acc, r_pt = acc.clone(), r_pt.contiguous().clone()
    rows = torch.tensor(list(range(3, B, 4)), dtype=torch.long, device=dev)
    for pts in (acc, r_pt):
        pts[..., rows] = torch.from_numpy(
            rng.integers(0, 9501, (4, 20, len(rows)), dtype=np.int32)).to(dev)
    flip_a, flip_r = (torch.from_numpy(rng.random(B) < 0.25).to(dev) for _ in range(2))
    return acc, r_pt, r_y, r_sign, a_valid ^ flip_a, r_valid ^ flip_r


def check_verdict_alone(device, acc, r_y, r_sign, a_valid, r_valid, b: int) -> None:
    """A5 bit-equal to its plain version on verdict_inputs."""
    from narwhal_tpu_torch.gpu import ed25519

    v = verdict_inputs(np.random.default_rng(b), acc, r_y, r_sign, a_valid, r_valid)
    (strict, cof), (p_strict, p_cof) = ed25519.verify_verdict(*v), ed25519.verify_verdict_plain(*v)
    _same_bits(f"verify_verdict B={b} alone strict", strict, p_strict)
    _same_bits(f"verify_verdict B={b} alone cofactored", cof, p_cof)


def check_verify_sizes(device, n_keys: int, sizes=VERIFY_SIZES) -> dict:
    """A1, A4 and A5 at B in `sizes` on `verify_rows`: A1's verdicts
    bit-equal to verify_batch_plain, A4's accumulators equal to
    verify_straus_plain as affine points, A3 -> A4 -> A5 bit-equal to A1,
    and A5 alone bit-equal to verify_verdict_plain (`check_verdict_alone`).
    Returns each kernel's largest difference."""
    import torch
    from narwhal_tpu_torch.gpu import ed25519

    errs = {"verify_batch": 0, "verify_straus": 0}
    for b in sizes:
        t = [torch.from_numpy(a).to(device) for a in verify_rows(7, n_keys, b)]
        strict, cof = ed25519.verify_batch(*t)
        p_strict, p_cof = ed25519.verify_batch_plain(*t)
        _same_bits(f"verify_batch B={b} strict", strict, p_strict)
        _same_bits(f"verify_batch B={b} cofactored", cof, p_cof)
        a_pt, a_valid = ed25519.verify_decompress(t[0], t[1])
        r_pt, r_valid = ed25519.verify_decompress(t[2], t[3])
        acc = ed25519.verify_straus(a_pt, t[4], t[5])
        errs["verify_straus"] = max(errs["verify_straus"], _same_points(
            f"verify_straus B={b}", acc, ed25519.verify_straus_plain(a_pt, t[4], t[5])))
        s_strict, s_cof = ed25519.verify_verdict(acc, r_pt, t[2], t[3], a_valid, r_valid)
        _same_bits(f"A3 -> A4 -> A5 B={b} strict against verify_batch", s_strict, strict)
        _same_bits(f"A3 -> A4 -> A5 B={b} cofactored against verify_batch", s_cof, cof)
        check_verdict_alone(device, acc, t[2], t[3], a_valid, r_valid, b)
        log(f"verify_batch, verify_straus, verify_verdict: B={b}, A1 == plain "
            f"({int(strict.sum())} strict, {int(cof.sum())} cofactored valid), A4 == plain as "
            f"affine points, A3 -> A4 -> A5 == A1, A5 == plain on loose, random-limb and "
            f"flipped-validity rows")
    return errs


def check_verify_batch(device, bucket: int, n_keys: int, n_ref: int, plain_reps: int):
    import torch
    from narwhal_tpu_torch.gpu import ed25519
    from narwhal_tpu_torch.gpu import ed25519_ref as ref

    arrays, checked, m = signature_bucket(7, n_keys, bucket)
    tensors = [torch.from_numpy(a).to(device) for a in arrays]
    strict, cof = ed25519.verify_batch(*tensors)
    p_strict, p_cof = ed25519.verify_batch_plain(*tensors)
    if device.type == "cuda":
        torch.cuda.synchronize()
    err = max(int((strict.int() - p_strict.int()).abs().max()),
              int((cof.int() - p_cof.int()).abs().max()))
    if not (torch.equal(strict, p_strict) and torch.equal(cof, p_cof)):
        bad = (strict != p_strict) | (cof != p_cof)
        raise AssertionError(
            f"verify_batch: kernel != plain at rows {bad.nonzero().flatten()[:10].tolist()}"
        )
    s_host, c_host = strict.cpu().numpy(), cof.cpu().numpy()
    for i in range(min(n_ref, m)):
        pk, msg, sig = checked[i]
        want = ref.verify(pk, msg, sig)
        if bool(s_host[i]) != want:
            raise AssertionError(f"verify_batch row {i}: strict {s_host[i]} != ref {want}")
    # The torsion-defect rows close the checked list: strict no, cofactored yes.
    for i in range(m - 4, m):
        if s_host[i] or not c_host[i]:
            raise AssertionError(f"torsion row {i}: strict {s_host[i]} cof {c_host[i]}")
    n_valid = int(s_host.sum())
    log(f"verify_batch: B={bucket}, {m} distinct rows, {n_valid} strict-valid, "
        f"{int(c_host.sum())} cofactored-valid: kernel == plain, {min(n_ref, m)} rows == ref")
    ms = time_ms(lambda: ed25519.verify_batch(*tensors), device, reps=5)
    plain_ms = time_ms(lambda: ed25519.verify_batch_plain(*tensors), device, reps=1,
                       groups=plain_reps)
    per = ed25519.field_muls_per_signature()
    ops = bucket * (per["mul"] * 100 + per["sq"] * 55)
    nbytes = bucket * (2 * 20 * 2 + 2 + 2 * 64 + 2)
    b, by = bound_ms(nbytes, ops)
    return {
        "name": "verify_batch", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"B={bucket}", "sigs_per_s_kernel": bucket / ms * 1e3,
    }


def _recording_verifier(bucket: int):
    """A CPU GpuVerifier whose msm launches only record their host arrays:
    the packing the main path gives the kernel, without the kernel."""
    from narwhal_tpu_torch.gpu.verifier import GpuVerifier

    v = GpuVerifier(max_bucket=bucket, mode="msm", msm_min_bucket=16, fixed_bucket=True,
                    device="cpu")
    calls = []
    v._launch_msm = lambda arrays: calls.append([np.ascontiguousarray(a) for a in arrays])
    return v, calls


def compact_groups(f, n_groups: int, round0: int = 1):
    """`n_groups` compact certificates' proofs, each signed by the whole
    committee (one header per group)."""
    from narwhal_tpu_torch.types import Certificate, Vote

    groups = []
    for g in range(n_groups):
        h = f.header(author=g % f.committee.size(), round=round0 + g)
        signers, sigs = [], []
        for a in f.authorities:
            signers.append(f.committee.index_of(a.public))
            sigs.append(Vote.for_header(h, a.public, a.keypair).signature)
        cert = Certificate.compact_from_votes(h, tuple(signers), tuple(sigs))
        groups.append(cert.aggregate_group(f.committee))
    return groups


def msm_group_bucket(f, bucket: int):
    """The group lane's launch at the main path's shape: as many compact
    proofs of the committee's n signers as fill the bucket (20 x 50 signers
    = 2000 doubled rows, then zero rows), the R slot all zero. Returns (the
    six host arrays, sum_s, the number of doubled rows)."""
    n_groups = bucket // (2 * f.committee.size())
    v, calls = _recording_verifier(bucket)
    handle = v.submit_groups(compact_groups(f, n_groups))
    [(chunk, (_none, sum_s))] = handle[2]
    return calls[0], sum_s, 2 * sum(len(g[1]) for g in chunk)


def msm_item_bucket(seed: int, n_keys: int, bucket: int):
    """The msm item lane's launch: real A, R, z*k and z digits. Valid,
    corrupt-S and wrong-message signatures, torsion-defect signatures and
    one signature whose R encodes a y with no x on the curve (it passes the
    host precheck, so only the kernel's decompression flags it); rows are
    reused to fill the bucket less 1/64, which stays zero padding. Returns
    (the six host arrays, sum_s, the rows that must be invalid)."""
    from narwhal_tpu_torch.crypto import KeyPair
    from narwhal_tpu_torch.gpu import ed25519_ref as ref

    rng = random.Random(seed)
    items = []
    for i in range(n_keys):
        kp = KeyPair.from_seed(rng.randbytes(32))
        msg = rng.randbytes(8 + i % 40)
        sig = kp.sign(msg)
        if i % 7 == 1:
            b = bytearray(sig)
            b[32 + rng.randrange(31)] ^= 1 << rng.randrange(8)
            sig = bytes(b)
        elif i % 7 == 2:
            msg = msg + b"!"
        items.append((kp.public, msg, sig))
    items += [_torsion_item(rng) for _ in range(2)]
    while True:
        y = rng.randrange(ref.P)
        if ref.recover_x(y, 0) is None:
            break
    pk, msg, sig = items[0]
    items.append((pk, msg, y.to_bytes(32, "little") + sig[32:]))
    v, calls = _recording_verifier(bucket)
    idx, packed = v.pack(items)
    m = idx.size
    if idx[-1] != len(items) - 1:  # some corrupt S may exceed L; the bad R may not
        raise AssertionError("msm item bucket: the invalid-R item failed the host precheck")
    n_rows = bucket - bucket // 64
    reuse = [i % m for i in range(n_rows)]
    rows = tuple(np.ascontiguousarray(a[reuse]) for a in packed)
    _none, sum_s = v._dispatch_msm(rows, 0, n_rows, bucket - n_rows)
    invalid = {j for j, i in enumerate(reuse) if i == m - 1}
    return calls[0], sum_s, invalid


def _affine_lanes(v: np.ndarray) -> list[tuple[int, int]]:
    """Canonical affine (x, y) of each window lane of V [4, NLIMB, W]."""
    from narwhal_tpu_torch.gpu import ed25519
    from narwhal_tpu_torch.gpu import ed25519_ref as ref

    out = []
    for w in range(v.shape[2]):
        X, Y, Z = (ed25519.limbs_to_int(v[c, :, w]) % ref.P for c in range(3))
        zi = pow(Z, ref.P - 2, ref.P)
        out.append((X * zi % ref.P, Y * zi % ref.P))
    return out


def check_msm_accumulate(device, f, bucket: int, n_keys: int, plain_reps: int):
    import torch
    from narwhal_tpu_torch.gpu import ed25519
    from narwhal_tpu_torch.gpu.verifier import msm_epilogue_check

    group_arrays, group_sum, group_rows = msm_group_bucket(f, bucket)
    item_arrays, item_sum, invalid = msm_item_bucket(23, n_keys, bucket)
    err, row = 0, None
    for shape, arrays, sum_s in (("group", group_arrays, group_sum),
                                 ("item", item_arrays, item_sum)):
        t = [torch.from_numpy(a).to(device) for a in arrays]
        va, vr, valid = ed25519.msm_accumulate(*t)
        pva, pvr, pvalid = ed25519.msm_accumulate_plain(*t)
        if device.type == "cuda":
            torch.cuda.synchronize()
        if not torch.equal(valid, pvalid):
            bad = (valid != pvalid).nonzero().flatten()[:10].tolist()
            raise AssertionError(f"msm_accumulate {shape}: valid differs at rows {bad}")
        host = [x.cpu().numpy() for x in (va, vr, pva, pvr)]
        for k_v, p_v, name in ((host[0], host[2], "V_a"), (host[1], host[3], "V_r")):
            for w, (a, b) in enumerate(zip(_affine_lanes(k_v), _affine_lanes(p_v))):
                err = max(err, abs(a[0] - b[0]), abs(a[1] - b[1]))
                if a != b:
                    raise AssertionError(f"msm_accumulate {shape}: {name} lane {w} differs")
        got_invalid = set(np.flatnonzero(~valid.cpu().numpy()).tolist())
        want_invalid = invalid if shape == "item" else set()
        if got_invalid != want_invalid:
            raise AssertionError(f"msm_accumulate {shape}: invalid rows {sorted(got_invalid)}")
        verdicts = []
        for s in (sum_s, sum_s + 1):
            kv = msm_epilogue_check(host[0], host[1], s)
            pv = msm_epilogue_check(host[2], host[3], s)
            if kv != pv:
                raise AssertionError(f"msm_accumulate {shape}: epilogue {kv} != plain {pv}")
            verdicts.append(kv)
        want = [True, False] if shape == "group" else [False, False]
        if verdicts != want:
            raise AssertionError(f"msm_accumulate {shape}: epilogue verdicts {verdicts}")
        live = group_rows if shape == "group" else bucket - bucket // 64
        log(f"msm_accumulate {shape}: B={bucket} ({live} live rows), valid bit-equal "
            f"({len(want_invalid)} invalid), 96 lanes equal as affine points, epilogue "
            f"verdicts {verdicts} == plain")
        ms = time_ms(lambda: ed25519.msm_accumulate(*t), device, reps=5)
        plain_ms = time_ms(lambda: ed25519.msm_accumulate_plain(*t), device, reps=1,
                           groups=plain_reps)
        # The work this launch's data needs: nonzero encodings decompress,
        # rows with a nonzero digit in a slot build a table and add into
        # that slot's lanes (zero rows and the group lane's R slot do not).
        a_y, a_sign, r_y, r_sign, ak, z = arrays
        points = int((a_y.any(1) | (a_sign != 0)).sum() + (r_y.any(1) | (r_sign != 0)).sum())
        cnt = ed25519.msm_field_ops(points, int(ak.any(1).sum()), int(z.any(1).sum()), bucket)
        ops = cnt["mul"] * 100 + cnt["sq"] * 55
        nbytes = bucket * (2 * 20 * 2 + 2 + 64 + 32 + 1) + 4 * 20 * 96 * 4
        b, by = bound_ms(nbytes, ops)
        log(f"  msm_accumulate {shape} shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b:.6f} ms ({by}: {points} points decompressed, {cnt['mul']:.0f} mul + "
            f"{cnt['sq']} sq), {100 * b / ms:.2f} % of bound")
        dev_ms, per_launch = device_breakdown(lambda: ed25519.msm_accumulate(*t), device)
        log(f"  msm_accumulate {shape} shape: profiler device time {dev_ms} ms a call: "
            f"{per_launch}")
        if shape == "group":
            row = {"name": "msm_accumulate", "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b, "bound_by": by, "library_ms": None,
                   "shape": f"B={bucket} group lane ({group_rows} doubled rows of "
                            f"{group_rows // (2 * f.committee.size())} proofs, N="
                            f"{f.committee.size()})",
                   "rows_per_s_kernel": bucket / ms * 1e3,
                   "extra": {"device_ms": dev_ms, "device_ms_by_launch": per_launch,
                             "ptxas": ptxas_report("ed25519_msm")}}
        else:
            row["extra"].update({"ms_item_shape": ms, "plain_ms_item_shape": plain_ms,
                                 "bound_ms_item_shape": b, "device_ms_item_shape": dev_ms})
    row["max_abs_err"] = err
    return row


def check_msm_shapes(device, bucket_sizes=(16, 512, 1024, 8192), n_keys: int = 300):
    """A2 and A3 -> A6 at the other bucket shapes the kernels meet (the
    smallest bucket, the sharded verifier's per-shard 1024 rows, the largest
    bucket, whose A2 rows take two tiles of shared memory): on the group lane
    (compact proofs of the N = 50 committee, or of 4 signers where 2 x 50
    rows do not fit; the R slot all zero) and the item bucket (invalid
    encodings among its rows). A2's lanes and A6's equal to their plain
    versions as affine points, A6's to A2's, validity bit for bit. Returns
    the largest affine difference (0 when equal)."""
    import torch
    from narwhal_tpu_torch.fixtures import CommitteeFixture
    from narwhal_tpu_torch.gpu import ed25519

    err = 0
    for bucket in bucket_sizes:
        f = CommitteeFixture(size=50 if bucket >= 100 else 4)
        keys = min(n_keys, max(4, bucket // 4))
        item, _sum, invalid = msm_item_bucket(29, keys, bucket)
        for shape, host in (("group", msm_group_bucket(f, bucket)[0]), ("item", item)):
            t = [torch.from_numpy(a).to(device) for a in host]
            va, vr, valid = ed25519.msm_accumulate(*t)
            pva, pvr, pvalid = ed25519.msm_accumulate_plain(*t)
            _same_bits(f"msm_accumulate B={bucket} {shape} valid", valid, pvalid)
            err = max(err, _same_points(f"msm_accumulate B={bucket} {shape} V_a", va, pva),
                      _same_points(f"msm_accumulate B={bucket} {shape} V_r", vr, pvr))
            want = invalid if shape == "item" else set()
            got = set(np.flatnonzero(~valid.cpu().numpy()).tolist())
            if got != want:
                raise AssertionError(f"msm_accumulate B={bucket} {shape}: invalid rows {got}")
            pa, a_ok = ed25519.verify_decompress(t[0], t[1])
            pr, r_ok = ed25519.verify_decompress(t[2], t[3])
            _same_bits(f"A3 -> A6 B={bucket} {shape} valid", a_ok & r_ok, valid)
            for pts, digits, mono, lanes in ((pa, t[4], va, "A"), (pr, t[5], vr, "R")):
                v = ed25519.msm_window(pts, digits)
                err = max(err, _same_points(f"msm_window B={bucket} {shape} {lanes}", v,
                                            ed25519.msm_window_plain(pts, digits)))
                _same_points(f"A3 -> A6 B={bucket} {shape} {lanes} against msm_accumulate",
                             v, mono)
            log(f"msm shapes: B={bucket} {shape}: A2 and A3 -> A6 (64 and 32 lanes) equal to "
                f"plain and to each other as affine points, valid bit-equal "
                f"({len(want)} invalid rows)")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return err


def decompress_rows(rng: np.random.Generator, b: int, pool: int = 32):
    """A3 inputs, y limbs [b, 20] int16 and signs [b] int8: the edge
    encodings first (y = 0, 1, p - 1, p and p + 3 and 2^255 - 1 (not
    canonical), each with both signs), then by turns the y of a multiple of
    the base point (a pool of `pool`) with its x's sign bit or the other
    one, and a random 255-bit y (about half are not on the curve)."""
    from narwhal_tpu_torch.gpu import ed25519
    from narwhal_tpu_torch.gpu import ed25519_ref as ref

    points = [ref.affine(ref.point_mul(int(rng.integers(1, 2**62)) * 977 + i, ref.G))
              for i in range(pool)]
    ys, signs = [], []
    for y in (0, 1, ref.P - 1, ref.P, ref.P + 3, (1 << 255) - 1):
        ys += [y, y]
        signs += [0, 1]
    i = 0
    while len(ys) < b:
        if i % 2 == 0:
            x, y = points[(i // 2) % pool]
            ys.append(y)
            signs.append((x & 1) ^ ((i // 2) % 5 == 4))
        else:
            ys.append(int.from_bytes(rng.bytes(32), "little") & ((1 << 255) - 1))
            signs.append(int(rng.integers(0, 2)))
        i += 1
    rows = np.stack([ed25519.int_to_limbs(y) for y in ys[:b]]).astype(np.int16)
    return rows, np.asarray(signs[:b], np.int8)


def _mod_p(v: np.ndarray) -> list:
    """Every coordinate of V [4, NLIMB, n] as its value mod p."""
    from narwhal_tpu_torch.gpu import ed25519
    from narwhal_tpu_torch.gpu import ed25519_ref as ref

    return [[ed25519.limbs_to_int(v[c, :, j]) % ref.P for j in range(v.shape[2])]
            for c in range(4)]


def _same_points(kernel: str, got, want) -> int:
    """Fail unless the points of two [4, NLIMB, n] tensors are equal as
    affine points; the largest difference of their affine coordinates."""
    a, b = _affine_lanes(got.cpu().numpy()), _affine_lanes(want.cpu().numpy())
    bad = [j for j, (p, q) in enumerate(zip(a, b)) if p != q]
    if bad:
        raise AssertionError(f"{kernel}: points differ at lanes {bad[:10]}")
    return max(max(abs(p[0] - q[0]), abs(p[1] - q[1])) for p, q in zip(a, b))


def _same_bits(kernel: str, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        bad = (got != want).nonzero().flatten()[:10].tolist()
        raise AssertionError(f"{kernel}: differs at rows {bad}")


def shard_lane_sets(pa, pr, digits_a, digits_r, k: int):
    """A6 over k equal shards of a bucket's decompressed A and R sets, as
    the sharded verifier's msm bucket runs it: (parts_a, parts_r)."""
    from narwhal_tpu_torch.gpu import ed25519

    n = digits_a.shape[0] // k
    cut = [slice(i * n, (i + 1) * n) for i in range(k)]
    return ([ed25519.msm_window(pa[..., c].contiguous(), digits_a[c]) for c in cut],
            [ed25519.msm_window(pr[..., c].contiguous(), digits_r[c]) for c in cut])


def check_staged(device, f, bucket: int, n_keys: int, plain_reps: int):
    """A3-A6 and the shard reduce against their plain versions on the same
    card tensors at B = `bucket`, and the compositions against the
    monoliths: A3 -> A4 -> A5 against A1 on the item bucket of
    `signature_bucket` (its forged, torsion, zero and random-limb rows), A3
    -> A6 (A and R sets) against A2 on the msm item and group buckets (the
    group lane's R set all zero), the reduce of both sets over k = 2 and 4
    shards of the item bucket against A2's V_a and V_r (the invalid R row's
    digits zeroed for V_r). Validity and verdicts bit-equal, A3's coordinates
    equal mod p, every other point equal as an affine point."""
    import torch
    from narwhal_tpu_torch.gpu import ed25519

    arrays, _checked, _m = signature_bucket(7, n_keys, bucket)
    a_y, a_sign, r_y, r_sign, kd, sd = (torch.from_numpy(a).to(device) for a in arrays)
    errs = {name: 0 for name in ("verify_decompress", "verify_straus", "verify_verdict",
                                 "msm_window", "msm_shard_reduce")}

    a_pt, a_valid = ed25519.verify_decompress(a_y, a_sign)
    r_pt, r_valid = ed25519.verify_decompress(r_y, r_sign)
    for name, (pt, valid), (y, sg) in (("A", (a_pt, a_valid), (a_y, a_sign)),
                                        ("R", (r_pt, r_valid), (r_y, r_sign))):
        p_pt, p_valid = ed25519.verify_decompress_plain(y, sg)
        _same_bits(f"verify_decompress {name} valid", valid, p_valid)
        if _mod_p(pt.cpu().numpy()) != _mod_p(p_pt.cpu().numpy()):
            raise AssertionError(f"verify_decompress {name}: coordinates differ mod p")
    n_invalid = int((~a_valid).sum() + (~r_valid).sum())
    dec_rows = {}
    for b in (1, 7, 1024, 2048, 8192):
        rows, signs = decompress_rows(np.random.default_rng(b), b)
        y, sg = torch.from_numpy(rows).to(device), torch.from_numpy(signs).to(device)
        pt, valid = ed25519.verify_decompress(y, sg)
        p_pt, p_valid = ed25519.verify_decompress_plain(y, sg)
        _same_bits(f"verify_decompress B={b} valid", valid, p_valid)
        if _mod_p(pt.cpu().numpy()) != _mod_p(p_pt.cpu().numpy()):
            raise AssertionError(f"verify_decompress B={b}: coordinates differ mod p")
        dec_rows[b] = (y, sg)
    log("verify_decompress: B in (1, 7, 1024, 2048, 8192), the edge encodings (y = 0, 1, "
        "p - 1, p, p + 3, 2^255 - 1, both signs), points with either sign, random y: valid "
        "bit-equal, coordinates equal mod p")
    acc = ed25519.verify_straus(a_pt, kd, sd)
    errs["verify_straus"] = _same_points("verify_straus", acc,
                                         ed25519.verify_straus_plain(a_pt, kd, sd))
    strict, cof = ed25519.verify_verdict(acc, r_pt, r_y, r_sign, a_valid, r_valid)
    p_strict, p_cof = ed25519.verify_verdict_plain(acc, r_pt, r_y, r_sign, a_valid, r_valid)
    _same_bits("verify_verdict strict", strict, p_strict)
    _same_bits("verify_verdict cofactored", cof, p_cof)
    m_strict, m_cof = ed25519.verify_batch(a_y, a_sign, r_y, r_sign, kd, sd)
    _same_bits("A3 -> A4 -> A5 strict against verify_batch", strict, m_strict)
    _same_bits("A3 -> A4 -> A5 cofactored against verify_batch", cof, m_cof)
    check_verdict_alone(device, acc, r_y, r_sign, a_valid, r_valid, bucket)
    log(f"staged item: B={bucket}, A3 valid bit-equal and coordinates equal mod p "
        f"({n_invalid} invalid points), A4 equal as affine points, A5 bit-equal; "
        f"A3 -> A4 -> A5 == verify_batch ({int(strict.sum())} strict, {int(cof.sum())} "
        f"cofactored valid)")
    item_t = (a_y, a_sign, r_y, r_sign, kd, sd)

    msm = {"item": msm_item_bucket(23, n_keys, bucket)[0], "group": msm_group_bucket(f, bucket)[0]}
    msm_t = {}
    for shape, host in msm.items():
        t = [torch.from_numpy(a).to(device) for a in host]
        msm_t[shape] = t
        m_va, m_vr, m_valid = ed25519.msm_accumulate(*t)
        pa, va_ok = ed25519.verify_decompress(t[0], t[1])
        pr, vr_ok = ed25519.verify_decompress(t[2], t[3])
        for pts, digits, mono, lanes in ((pa, t[4], m_va, "V_a"), (pr, t[5], m_vr, "V_r")):
            v = ed25519.msm_window(pts, digits)
            err = _same_points(f"msm_window {shape} {lanes}", v,
                               ed25519.msm_window_plain(pts, digits))
            errs["msm_window"] = max(errs["msm_window"], err)
            _same_points(f"A3 -> A6 {shape} {lanes} against msm_accumulate", v, mono)
        _same_bits(f"A3 -> A6 {shape} valid against msm_accumulate", va_ok & vr_ok, m_valid)
        log(f"staged msm {shape}: B={bucket}, A6 (64 and 32 lanes) equal to plain as affine "
            f"points; A3 -> A6 == msm_accumulate (V_a, V_r as points, valid bit-equal, "
            f"{int((~m_valid).sum())} invalid)")

    # A6' as the sharded msm bucket runs it: the item bucket cut into k
    # shards, A6 over each shard's A and R sets, both sets reduced in one
    # call. Against A2 with the invalid R row's digits zeroed as well: off
    # the curve the shards' grouping of the additions gives another point.
    t = msm_t["item"]
    pa, _ = ed25519.verify_decompress(t[0], t[1])
    pr, r_ok = ed25519.verify_decompress(t[2], t[3])
    z_on_curve = torch.where(r_ok[:, None], t[5], torch.zeros_like(t[5]))
    whole_a, _, _ = ed25519.msm_accumulate(*t)
    whole_r = ed25519.msm_accumulate(*t[:5], z_on_curve)[1]
    for k in (2, 4):
        parts_a, parts_r = shard_lane_sets(pa, pr, t[4], t[5], k)
        got_a, got_r = ed25519.msm_shard_reduce(parts_a, parts_r)
        for lanes, got, parts in (("V_a", got_a, parts_a), ("V_r", got_r, parts_r)):
            err = _same_points(f"msm_shard_reduce k={k} {lanes}", got,
                               ed25519.msm_shard_reduce_plain(torch.stack(parts)))
            errs["msm_shard_reduce"] = max(errs["msm_shard_reduce"], err)
        _same_points(f"msm_shard_reduce k={k} against msm_accumulate V_a", got_a, whole_a)
        on_curve = ed25519.msm_shard_reduce(*shard_lane_sets(pa, pr, t[4], z_on_curve, k))
        _same_points(f"msm_shard_reduce k={k} against msm_accumulate V_r", on_curve[1], whole_r)
        if k == 2:
            sets2 = (parts_a, parts_r)
    log(f"msm_shard_reduce: k in (2, 4) shards of the item bucket, the A and R sets in one "
        f"launch: equal to plain as affine points (the invalid R row included), and to "
        f"msm_accumulate's V_a and V_r (that row's digits zeroed)")
    if device.type == "cuda":
        torch.cuda.synchronize()

    # Times and bounds (operations: 55 multiply-adds a squaring, 100 a
    # product, as A1's; bytes: each input read once, each output written once).
    per = ed25519.staged_field_ops()
    pts_bytes = 4 * 20 * 4 * bucket

    def ops_of(name, rows):
        return rows * (per[name]["mul"] * 100 + per[name]["sq"] * 55)

    group_t = msm_t["group"]
    g_pts, _ = ed25519.verify_decompress(group_t[0], group_t[1])
    g_live = int(group_t[4].any(1).sum())
    timed = dict(verify_decompress=(
        lambda: ed25519.verify_decompress(a_y, a_sign),
        lambda: ed25519.verify_decompress_plain(a_y, a_sign),
        ops_of("verify_decompress", bucket), bucket * (2 * 20 + 1) + pts_bytes + bucket,
        f"B={bucket} (A set of the item bucket)"),
        verify_straus=(
        lambda: ed25519.verify_straus(a_pt, kd, sd),
        lambda: ed25519.verify_straus_plain(a_pt, kd, sd),
        ops_of("verify_straus", bucket), 2 * pts_bytes + bucket * 2 * 64, f"B={bucket}"),
        verify_verdict=(
        lambda: ed25519.verify_verdict(acc, r_pt, r_y, r_sign, a_valid, r_valid),
        lambda: ed25519.verify_verdict_plain(acc, r_pt, r_y, r_sign, a_valid, r_valid),
        ops_of("verify_verdict", bucket), 2 * pts_bytes + bucket * (2 * 20 + 1 + 2 + 2),
        f"B={bucket}"),
        msm_window=(
        lambda: ed25519.msm_window(g_pts, group_t[4]),
        lambda: ed25519.msm_window_plain(g_pts, group_t[4]),
        ed25519.msm_window_ops(g_live, 64, bucket) * 100,
        pts_bytes + bucket * 64 + 4 * 20 * 64 * 4,
        f"B={bucket} group lane A set, 64 lanes ({g_live} live rows)"),
        msm_shard_reduce=(
        lambda: ed25519.msm_shard_reduce(*sets2),
        lambda: [ed25519.msm_shard_reduce_plain(torch.stack(p)) for p in sets2],
        (2 - 1) * 96 * 9 * 100, 3 * 4 * 20 * 96 * 4,
        "k=2 shards, the A (64 lanes) and R (32 lanes) sets in one launch"),
    )
    rows = []
    for name, (kernel, plain, ops, nbytes, shape) in timed.items():
        ms = time_ms(kernel, device, reps=5)
        plain_ms = time_ms(plain, device, reps=1, groups=plain_reps)
        b, by = bound_ms(nbytes, ops)
        rows.append({"name": name, "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by, "library_ms": None, "shape": shape})
    # A6's other shape on the path: the R set's 32 lanes (the item bucket).
    r_live = int(t[5].any(1).sum())
    dev_ms, per_launch = device_breakdown(lambda: ed25519.msm_window(g_pts, group_t[4]), device)
    dev_r, per_r = device_breakdown(lambda: ed25519.msm_window(pr, t[5]), device)
    rows[3]["extra"] = {
        "ms_r_lanes": time_ms(lambda: ed25519.msm_window(pr, t[5]), device, reps=5),
        "bound_ms_r_lanes": bound_ms(pts_bytes + bucket * 32 + 4 * 20 * 32 * 4,
                                     ed25519.msm_window_ops(r_live, 32, bucket) * 100)[0],
        "device_ms": dev_ms, "device_ms_by_launch": per_launch,
        "device_ms_r_lanes": dev_r, "device_ms_by_launch_r_lanes": per_r,
    }
    log(f"  msm_window profiler device time {dev_ms} ms a call (64 lanes): {per_launch}; "
        f"{dev_r} ms (32 lanes): {per_r}")
    rows[4]["extra"] = {"device_ms": device_breakdown(
        lambda: ed25519.msm_shard_reduce(*sets2), device)[0]}
    log(f"  msm_shard_reduce k=2, both sets: events {rows[4]['ms']:.4f} ms, device "
        f"{rows[4]['extra']['device_ms']} ms")
    # The staged item path on one card beside A1 (both on the same bucket).
    def staged_item():
        ap, av = ed25519.verify_decompress(a_y, a_sign)
        rp, rv = ed25519.verify_decompress(r_y, r_sign)
        return ed25519.verify_verdict(ed25519.verify_straus(ap, kd, sd), rp, r_y, r_sign, av, rv)

    rows[0]["extra"] = {"staged_item_ms": time_ms(staged_item, device, reps=5),
                        "verify_batch_ms": time_ms(lambda: ed25519.verify_batch(*item_t),
                                                   device, reps=5)}
    # A3's device time at the bucket, and at a shard's 1024 rows (the sharded
    # path's launches) on decompress_rows' inputs.
    rows[0]["extra"]["device_ms"] = device_breakdown(
        lambda: ed25519.verify_decompress(a_y, a_sign), device)[0]
    y1, s1 = dec_rows[1024]
    rows[0]["extra"].update({
        "ms_b1024": time_ms(lambda: ed25519.verify_decompress(y1, s1), device, reps=5),
        "device_ms_b1024": device_breakdown(lambda: ed25519.verify_decompress(y1, s1),
                                            device)[0],
        "plain_ms_b1024": time_ms(lambda: ed25519.verify_decompress_plain(y1, s1), device,
                                  reps=1, groups=plain_reps),
        "bound_ms_b1024": bound_ms(1024 * (2 * 20 + 1) + 4 * 20 * 4 * 1024 + 1024,
                                   ops_of("verify_decompress", 1024))[0],
    })
    log(f"  verify_decompress: B={bucket} events {rows[0]['ms']:.4f} ms, device "
        f"{rows[0]['extra']['device_ms']} ms; B=1024 events "
        f"{rows[0]['extra']['ms_b1024']:.4f} ms, device {rows[0]['extra']['device_ms_b1024']} ms")
    rows[2]["extra"] = {"device_ms": device_breakdown(
        lambda: ed25519.verify_verdict(acc, r_pt, r_y, r_sign, a_valid, r_valid), device)[0]}
    log(f"  verify_verdict: B={bucket} events {rows[2]['ms']:.4f} ms, device "
        f"{rows[2]['extra']['device_ms']} ms")
    log(f"  staged item path (A3 x2, A4, A5) {rows[0]['extra']['staged_item_ms']:.4f} ms "
        f"beside verify_batch {rows[0]['extra']['verify_batch_ms']:.4f} ms at B={bucket}")
    return rows


def _random_window(rng: np.random.Generator, w: int, n: int):
    parent = (rng.random((w, n, n)) < 0.7).astype(np.uint8)
    present = (rng.random((w, n)) < 0.9).astype(np.uint8)
    return parent, present


def sync_slots(rng: np.random.Generator, w: int, n: int, T: int, n_dup: int = 4,
               n_below: int = 0):
    """T placements of a window sync as host arrays (offs, idxs, rows), the
    offsets relative to the rolled window: distinct cells with 0/1 rows,
    then the last `n_dup` slots (when T >= 8) repeating the first ones with
    identical rows (device_view reads a duplicate's row from its mirror),
    and `n_below` of the others below the window (dropped)."""
    dup = n_dup if T >= 8 else 0
    cells = rng.choice(w * n, T - dup, replace=False)
    offs = np.concatenate([cells // n, cells[:dup] // n]).astype(np.int32)
    idxs = np.concatenate([cells % n, cells[:dup] % n]).astype(np.int32)
    rows = (rng.random((T - dup, n)) < 0.7).astype(np.uint8)
    rows = np.concatenate([rows, rows[:dup]])
    offs[dup:dup + n_below] = -1 - np.arange(n_below, dtype=np.int32)
    return offs, idxs, rows


def _slot_bytes(w: int, n: int, T: int) -> int:
    """Bytes of T slots in window_sync's parameter block (offset, index and
    row bits a slot)."""
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    return -(-T * dk.sync_layout(w, n)[1] // 8)


def check_place_batch(device, n: int, w: int):
    """B3 through window_sync (in place, shift 0), the slots as host arrays
    with padding and duplicates, against its plain version."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    rng = np.random.default_rng(11)
    out, err = None, 0
    for T, n_live in ((64, 44), (1, 1)):
        parent, present = _random_window(rng, w, n)
        # Distinct coordinates, then explicit duplicates: the engine's
        # contract is that duplicate slots carry identical rows.
        cells = rng.choice(w * n, T, replace=False)
        offs, idxs = (cells // n).astype(np.int32), (cells % n).astype(np.int32)
        rows = (rng.random((T, n)) < 0.7).astype(np.uint8)
        valid = np.zeros(T, np.uint8)
        valid[:n_live] = 1
        if T > 8:  # duplicate slots carry identical rows
            for d in range(4):
                offs[10 + d], idxs[10 + d], rows[10 + d] = offs[d], idxs[d], rows[d]
        t = {k: torch.from_numpy(v).to(device) for k, v in
             dict(parent=parent, present=present, offs=offs, idxs=idxs, rows=rows,
                  valid=valid).items()}
        kp, kq = dk.place_batch(t["parent"].clone(), t["present"].clone(), offs, idxs, rows,
                                valid)
        pp, pq = dk.place_batch_plain(t["parent"].clone(), t["present"].clone(),
                                      t["offs"], t["idxs"], t["rows"], t["valid"])
        err = max(err, int((kp.int() - pp.int()).abs().max()),
                  int((kq.int() - pq.int()).abs().max()))
        if not (torch.equal(kp, pp) and torch.equal(kq, pq)):
            raise AssertionError(f"place_batch T={T}: kernel != plain")
        if T != 64:
            continue
        wp, wq = t["parent"].clone(), t["present"].clone()
        ms = time_ms(lambda: dk.place_batch(wp, wq, offs, idxs, rows, valid), device, reps=50)
        dev_ms, _ = device_breakdown(lambda: dk.place_batch(wp, wq, offs, idxs, rows, valid),
                                     device)
        plain_ms = time_ms(lambda: dk.place_batch_plain(wp, wq, t["offs"], t["idxs"],
                                                        t["rows"], t["valid"]),
                           device, reps=3)
        live = t["valid"].bool()
        o, i, r = t["offs"][live].long(), t["idxs"][live].long(), t["rows"][live]
        ones = torch.ones(o.shape[0], dtype=torch.uint8, device=device)

        def library():
            wp.index_put_((o, i), r)
            wq.index_put_((o, i), ones)

        library_ms = time_ms(library, device, reps=50)
        # the live slots' bits read; each distinct (off, idx) cell written
        # once (row and present byte)
        n_distinct = len(set(zip(offs[:n_live].tolist(), idxs[:n_live].tolist())))
        b, by = bound_ms(_slot_bytes(w, n, n_live) + n_distinct * (n + 1))
        out = {"name": "place_batch", "replaces": "narwhal_tpu/tpu/dag_kernels.py:95",
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "bound_ms": b, "bound_by": by, "library_ms": library_ms,
               "shape": f"W={w} N={n} T={T} ({n_live} valid, 4 duplicates)"}
    out["max_abs_err"] = err
    log("place_batch: T in (64, 1), duplicates + padding: window_sync == plain")
    return out


def check_roll_window(device, n: int, w: int):
    """B4 through window_sync (no slots, out of place) against its plain
    version."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    rng = np.random.default_rng(12)
    parent, present = _random_window(rng, w, n)
    tp, tq = torch.from_numpy(parent).to(device), torch.from_numpy(present).to(device)
    err = 0
    for shift in (0, 1, w - 1, w, w + 5):
        kp, kq = dk.roll_window(tp, tq, shift)
        pp, pq = dk.roll_window_plain(tp, tq, shift)
        err = max(err, int((kp.int() - pp.int()).abs().max()),
                  int((kq.int() - pq.int()).abs().max()))
        if not (torch.equal(kp, pp) and torch.equal(kq, pq)):
            raise AssertionError(f"roll_window shift={shift}: kernel != plain")
    log(f"roll_window: shifts (0, 1, {w - 1}, {w}, {w + 5}): window_sync == plain")
    shift = 1
    ms = time_ms(lambda: dk.roll_window(tp, tq, shift), device, reps=50)
    dev_ms, _ = device_breakdown(lambda: dk.roll_window(tp, tq, shift), device)
    plain_ms = time_ms(lambda: dk.roll_window_plain(tp, tq, shift), device, reps=50)

    def library():
        a = torch.roll(tp, -shift, 0)
        a[w - shift:] = 0
        b = torch.roll(tq, -shift, 0)
        b[w - shift:] = 0

    library_ms = time_ms(library, device, reps=50)
    row = n * n + n
    b, by = bound_ms((w - shift) * row + w * row)
    return {"name": "roll_window", "replaces": "narwhal_tpu/tpu/dag_kernels.py:79",
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms,
            "shape": f"W={w} N={n} shift={shift}"}


# The window syncs the kernels phase holds to the plain version, (W, N, T):
# the engine's window, the Dag service's grown W 128, an odd N, and a batch
# past one parameter block (three launches).
SYNC_SHAPES = ((W, N, 64), (2 * W, N, 64), (W, N - 1, 64), (W, N, "past"))


def check_window_sync(device, n: int, w: int):
    """sync_window, the view's roll and placements in one window_sync
    launch, at SYNC_SHAPES and shifts 0 (in place), 1, W - 1 and W, with
    four duplicates and two slots below the window: bit-equal to the plain
    roll then place, one launch a parameter block. Timed at the engine's
    view, W = w, N = n, T = 64, shift 1."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu import kernel_registry

    rng = np.random.default_rng(15)
    err = 0
    for ww, nn, T in SYNC_SHAPES:
        parent, present = _random_window(rng, ww, nn)
        tp, tq = torch.from_numpy(parent).to(device), torch.from_numpy(present).to(device)
        cap, _bits = dk.sync_layout(ww, nn)
        size = 2 * cap + 7 if T == "past" else T
        offs, idxs, rows = sync_slots(rng, ww, nn, size, n_below=2)
        blocks = -(-int((offs >= 0).sum()) // cap)
        for shift in (0, 1, ww - 1, ww):
            kernel_registry.reset_launch_counts()
            kp, kq = dk.sync_window(tp.clone(), tq.clone(), shift, offs, idxs, rows)
            launches = kernel_registry.launch_counts()["window_sync"]
            pp, pq = dk.sync_window_plain(tp.clone(), tq.clone(), shift, offs, idxs, rows)
            err = max(err, int((kp.int() - pp.int()).abs().max()),
                      int((kq.int() - pq.int()).abs().max()))
            if not (torch.equal(kp, pp) and torch.equal(kq, pq)):
                raise AssertionError(f"window_sync W={ww} N={nn} T={size} shift={shift}: "
                                     "kernel != plain")
            if device.type == "cuda" and launches != blocks:
                raise AssertionError(f"window_sync W={ww} N={nn} T={size}: {launches} "
                                     f"launches for {blocks} parameter blocks")
        log(f"window_sync: W={ww} N={nn} T={size} ({blocks} block(s) of {cap}), shifts 0, 1, "
            f"{ww - 1}, {ww}: kernel == plain")
    parent, present = _random_window(rng, w, n)
    tp, tq = torch.from_numpy(parent).to(device), torch.from_numpy(present).to(device)
    offs, idxs, rows = sync_slots(rng, w, n, 64)
    shift = 1
    ms = time_ms(lambda: dk.sync_window(tp, tq, shift, offs, idxs, rows), device, reps=50)
    dev_ms, _ = device_breakdown(lambda: dk.sync_window(tp, tq, shift, offs, idxs, rows),
                                 device)
    plain_ms = time_ms(lambda: dk.sync_window_plain(tp, tq, shift, offs, idxs, rows),
                       device, reps=3)
    # (W - shift) rows read and W rows written, parent and present, and the
    # slots' bits read
    row = n * n + n
    b, by = bound_ms((w - shift) * row + w * row + _slot_bytes(w, n, 64))
    return {"name": "window_sync", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": f"W={w} N={n} T=64 (4 duplicates) shift={shift}",
            "extra": {"device_ms": dev_ms}}


def healed_partition_chain(rng: np.random.Generator, w: int, n: int, gc_depth: int,
                           k_slots: int, live: int):
    """One commit event after a healed partition, as numpy inputs of
    chain_commit: (parent, present, lc_rel, lcr_rel, offs, onehots).

    Up to row `w - 8` the committee was split in two halves, each linking
    only its own half of the round below. The chain's `live` leaders sit
    two rounds apart, the newest at row `w - 6`; all but the newest are in
    the first half, so they reach only that half, and the newest (above the
    healed row) reaches the second half's uncommitted certificates too.
    Authority 0 committed the round just below the first leader, which sets
    lcr; the others committed long ago (lc below `w - 8 - gc_depth`), so
    the gc filter drops some of what each leader reaches, and the newest
    leader's filter depends on the lcr its earlier leaders advanced. Slots
    `live..k_slots` are padding (zero one-hot)."""
    parent, present = _random_window(rng, w, n)
    top = w - 8
    half = np.arange(n) >= n // 2
    parent[: top + 1, half[:, None] != half[None, :]] = 0
    rows = [top + 2 - 2 * (live - 1 - k) for k in range(live)]
    offs = np.zeros(k_slots, np.int32)
    onehots = np.zeros((k_slots, n), np.uint8)
    for k, row in enumerate(rows):
        col = int(rng.integers(0, n // 2 if k < live - 1 else n))
        offs[k] = row
        onehots[k, col] = 1
        present[row, col] = 1
    lc = rng.integers(-3, top - gc_depth - 1, n).astype(np.int32)
    lc[0] = rows[0] - 2
    return parent, present, lc, int(lc.max()), offs, onehots


def chain_inputs(rng: np.random.Generator, w: int, n: int, rows, density: float = 0.7):
    """A random window and one commit event's chain, as numpy inputs of
    chain_commit: (parent, present, lc_rel, lcr_rel, offs, onehots). The
    leaders sit at `rows` (oldest first; None is a padding slot), each at a
    random authority whose certificate is present and not yet committed; lc
    is random over the lower half of the window (so some reached
    certificates are committed already) and lcr its max."""
    parent = (rng.random((w, n, n)) < density).astype(np.uint8)
    present = (rng.random((w, n)) < 0.9).astype(np.uint8)
    lc = rng.integers(-3, max(w // 2, 1), n).astype(np.int32)
    offs = np.zeros(len(rows), np.int32)
    onehots = np.zeros((len(rows), n), np.uint8)
    for k, row in enumerate(rows):
        if row is None:
            continue
        col = int(rng.integers(0, n))
        offs[k] = row
        onehots[k, col] = 1
        present[row, col] = 1
        lc[col] = min(lc[col], row - 1)  # a leader is not committed yet
    return parent, present, lc, int(lc.max()), offs, onehots


# B2's shapes beyond the main path's healed chains: (W, N, gc_depth, leader
# rows): the committee at a 32-bit word edge (64, 65), a wide committee
# (200), the widest the kernel takes (1024) at a short window, leaders on
# the top row and on row 1, a padding slot between live ones, and a window
# of 512 rows at N = 50, whose tables outgrow shared memory (the wide walk).
CHAIN_SHAPES = (
    (64, 64, GC_DEPTH, (40, None, 58)),
    (64, 65, GC_DEPTH, (40, None, 58)),
    (64, 200, GC_DEPTH, (50, 58)),
    (8, 1024, 2, (3, None, 7)),
    (64, 50, GC_DEPTH, (63,)),
    (64, 50, GC_DEPTH, (1,)),
    (128, 50, GC_DEPTH, (1, 120, None, 127)),
    (512, 50, GC_DEPTH, (200, None, 505)),
)


def gc_filter_effects(parent, present, gc_depth: int, lc_rel, lcr_rel: int, offs, onehots):
    """Walk the chain as chain_commit does, with the plain reach_mask on CPU
    tensors, and count the reached, uncommitted certificates that the gc
    filter acts on: `dropped` (the filter drops them), `by_advanced_lcr`
    (dropped, though the chain's starting lcr keeps them: a kernel that
    never advances lcr between leaders keeps them), `by_own_round` (kept,
    though the leader's own round as lcr drops them: a kernel that applies
    a leader's update before its own filter drops them). Returns the counts
    and the masks, which equal chain_commit_plain's."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    w = parent.shape[0]
    rows = torch.arange(w, dtype=torch.int32)[:, None]
    lc, lcr = lc_rel.clone(), int(lcr_rel)
    counts = {"dropped": 0, "by_advanced_lcr": 0, "by_own_round": 0}
    masks = []
    for off, onehot in zip(offs.tolist(), onehots):
        uncommitted = present.bool() & (rows > lc[None, :])
        reach = dk.reach_mask(parent, uncommitted, off, onehot)
        keep = reach & (rows + gc_depth >= lcr)
        if onehot.any():
            counts["dropped"] += int((reach & ~keep).sum())
            counts["by_advanced_lcr"] += int((reach & ~keep & (rows + gc_depth >= lcr_rel)).sum())
            counts["by_own_round"] += int((keep & (rows + gc_depth < max(lcr, off))).sum())
        committed = torch.where(keep, rows, torch.full_like(rows, -(2**30))).amax(dim=0)
        lc = torch.maximum(lc, committed)
        lcr = max(lcr, int(committed.max()))
        masks.append(keep)
    return counts, torch.stack(masks)


def check_chain_commit(device, n: int, w: int, gc_depth: int = GC_DEPTH):
    """B2 against its plain version, bit for bit: the healed-partition
    chains (K = 1, 2, 4 with a padded slot, where the gc filter provably
    bites) at W = w and the grown 2w, N = n, at 8w (past shared memory)
    and at W = w, N = 4n (the wide walk: the partition leaves present,
    uncommitted columns unreached, so their scans run long), and every shape of
    CHAIN_SHAPES (committees of 64, 65, 200 and 1024, leaders on the top
    row and on row 1). Timed at the main path's shape (W = w, K = 1, leader
    row w - 6): CUDA events, torch.profiler's device time, the row time
    (the slope to a walk from row 2 of the same window), plain, bound."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    rng = np.random.default_rng(13)
    out, err = None, 0
    # the main path's window, the grown one, and two the wide walk serves:
    # a window past shared memory and a wider committee
    for ww, nn in ((w, n), (2 * w, n), (8 * w, n), (w, 4 * n)):
        for K, live in ((1, 1), (2, 2), (4, 3)):
            parent, present, lc, lcr, offs, onehots = healed_partition_chain(
                rng, ww, nn, gc_depth, K, live)
            t = [torch.from_numpy(a).to(device) for a in (parent, present, lc, offs, onehots)]
            km = dk.chain_commit(t[0], t[1], gc_depth, t[2], lcr, t[3], t[4])
            pm = dk.chain_commit_plain(t[0], t[1], gc_depth, t[2], lcr, t[3], t[4])
            err = max(err, int((km.int() - pm.int()).abs().max()))
            if not torch.equal(km, pm):
                raise AssertionError(f"chain_commit W={ww} N={nn} K={K}: kernel != plain")
            if int(km.sum()) == 0:
                raise AssertionError(f"chain_commit W={ww} N={nn} K={K}: empty commit masks")
            hp, hq, hlc, ho, hh = (torch.from_numpy(a)
                                   for a in (parent, present, lc, offs, onehots))
            counts, masks = gc_filter_effects(hp, hq, gc_depth, hlc, lcr, ho, hh)
            if not torch.equal(masks, pm.cpu()):
                raise AssertionError(f"chain_commit W={ww} N={nn} K={K}: the filter walk != plain")
            need = ("dropped", "by_own_round") + (("by_advanced_lcr",) if live > 1 else ())
            if any(counts[c] == 0 for c in need):
                raise AssertionError(f"chain_commit W={ww} N={nn} K={K}: the gc filter does "
                                     f"not bite: {counts}")
            log(f"chain_commit W={ww} N={nn} K={K} ({live} leaders): gc filter drops "
                f"{counts['dropped']}, {counts['by_advanced_lcr']} of them by the advanced "
                f"lcr; the own-round rule would drop {counts['by_own_round']} more")
            if ww != w or nn != n or K != 1:
                continue
            args = (t[0], t[1], gc_depth, t[2], lcr, t[3], t[4])
            ms = time_ms(lambda: dk.chain_commit(*args), device, reps=50)
            plain_ms = time_ms(lambda: dk.chain_commit_plain(*args), device, reps=3)
            dev_ms, _ = device_breakdown(lambda: dk.chain_commit(*args), device)
            # Rows above the newest leader are never read: parent rows
            # 1..max(offs), present rows 0..max(offs), lc, offs, one-hots in;
            # the K masks out.
            top = int(offs.max())
            nbytes = top * n * n + (top + 1) * n + 4 * n + 4 * K + K * n + K * w * n
            b, by = bound_ms(nbytes)
            # The time a row costs, measured: the slope between this walk and
            # one from row 2 of the same window (rows are sequential).
            low = (*args[:5], torch.full_like(t[3], 2), t[4])
            low_ms = time_ms(lambda: dk.chain_commit(*low), device, reps=50)
            low_dev, _ = device_breakdown(lambda: dk.chain_commit(*low), device)
            # The device slope is the row time; the events slope is reported
            # too, but at ~20 us of device time it is within the wrapper's
            # host noise.
            extra = {"row_ms_events": (ms - low_ms) / (top - 2), "device_ms": dev_ms,
                     "row_ms": None}
            if dev_ms is not None and low_dev is not None:
                extra["row_ms"] = (dev_ms - low_dev) / (top - 2)
            out = {"name": "chain_commit", "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b, "bound_by": by, "library_ms": None,
                   "shape": f"W={w} N={n} K={K} leader row {top}", "extra": extra}
            log(f"  chain_commit W={w} N={n} K=1 row {top}: events {ms:.4f} ms, device "
                f"{dev_ms} ms, a row {extra['row_ms']} ms (device slope), "
                f"{extra['row_ms_events']} ms (events slope)")
    for i, (ww, nn, gc, rows) in enumerate(CHAIN_SHAPES):
        host = chain_inputs(np.random.default_rng(100 + i), ww, nn, rows)
        parent, present, lc, lcr, offs, onehots = host
        t = [torch.from_numpy(a).to(device) for a in (parent, present, lc, offs, onehots)]
        km = dk.chain_commit(t[0], t[1], gc, t[2], lcr, t[3], t[4])
        pm = dk.chain_commit_plain(t[0], t[1], gc, t[2], lcr, t[3], t[4])
        err = max(err, int((km.int() - pm.int()).abs().max()))
        if not torch.equal(km, pm):
            raise AssertionError(f"chain_commit W={ww} N={nn} leaders {rows}: kernel != plain")
        if int(km.sum()) == 0:
            raise AssertionError(f"chain_commit W={ww} N={nn} leaders {rows}: empty masks")
        log(f"chain_commit W={ww} N={nn} gc={gc} leader rows {rows}: kernel == plain "
            f"({int(km.sum())} kept)")
    out["max_abs_err"] = err
    log(f"chain_commit: K in (1, 2, 4 with a padded slot), healed partition, W = {w}, {2 * w} "
        f"and {8 * w} at N = {n} and W = {w} at N = {4 * n}, and {len(CHAIN_SHAPES)} more "
        f"shapes: kernel == plain")
    return out


def reach_many_inputs(rng: np.random.Generator, w: int, n: int, k_slots: int, live: int,
                      density: float | None = None):
    """Inputs of one coalesced read dispatch, as numpy arrays: a random
    window (by default sparse, two parent links a certificate on average, 4
    % at N = 50, so walks branch and die out instead of saturating; the Dag
    service's window links ~70 %), `uncommitted` (the service passes
    `present`) at 90 %, and `live` distinct random starts over rows 0..w-1
    (one at the top row), each present and linking at least one parent,
    then `k_slots - live` padding slots (offset 0, zero one-hot)."""
    density = 2.0 / n if density is None else density
    parent = (rng.random((w, n, n)) < density).astype(np.uint8)
    present = (rng.random((w, n)) < 0.9).astype(np.uint8)
    offs = np.zeros(k_slots, np.int32)
    onehots = np.zeros((k_slots, n), np.uint8)
    cells = rng.choice(w * n, live, replace=False)
    offs[:live], cols = cells // n, cells % n
    offs[0] = w - 1
    onehots[np.arange(live), cols] = 1
    present[offs[:live], cols] = 1  # a read starts at a certificate
    parent[offs[:live], cols, rng.integers(0, n, live)] = 1
    return parent, present, offs, onehots


def consensus_reach_inputs(rng: np.random.Generator, w: int, n: int, b: int):
    """B6's operands in the consensus step: `support_inputs`' 30 % window
    and B walks, with the uncommitted mask the step is given, present and
    above each authority's last committed round (so not `present`)."""
    parent, present, _stakes, offs, onehots, _leaders, last = support_inputs(rng, w, n, b, 0.3)
    unc = (present & (np.arange(w)[:, None] > last[None, :])).astype(np.uint8)
    assert not np.array_equal(unc, present)
    return parent, unc, offs, onehots


def reach_many_bytes(w: int, n: int, offs, onehots=None) -> int:
    """B6's least traffic: parent rows 1..top and uncommitted rows 0..top
    read once (top the highest start of a read with a one-hot), offs and
    the one-hots read, the K masks written."""
    k = len(offs)
    live = offs if onehots is None else offs[np.asarray(onehots).any(1)]
    top = int(np.max(live)) if len(live) else -1
    return max(top, 0) * n * n + (top + 1) * n + 4 * k + k * n + k * w * n


# B6's shapes beside the kernels phase's (W 64, N 50, K 64 of which 56 live,
# the sparse window): (label, W, N, K, live, link density; None: sparse).
# The sparse window grown to 128 and read once; the Dag service's dense
# window (70 % links) at its W 64 and grown 128 in its bursts of K 1, 8 and
# 64 (padded to a power of two); the wide route: N 65 and 200 at W 64, and a
# 512-row window at N 50 (past shared memory). The consensus step's shape
# (consensus_reach_inputs, uncommitted != present) is checked beside them.
REACH_SHAPES = (
    ("sparse", 128, 50, 64, 61, None), ("sparse", 64, 50, 1, 1, None),
    *(("service", w, 50, k, k - k // 8, 0.7) for w in (64, 128) for k in (1, 8, 64)),
    ("wide", 64, 65, 64, 56, None), ("wide", 64, 200, 64, 56, None),
    ("wide", 512, 50, 64, 56, None),
)


def check_reach_many(device, n: int, w: int):
    """B6 against its plain version, bit for bit: the kernels phase's sparse
    window (W = w, K = 64, 56 live), every shape of REACH_SHAPES and the
    consensus step's (W = w, B = 64, 30 % links, its uncommitted mask), on
    the route each takes (logged). Timed at the first: CUDA events,
    torch.profiler's device time, plain, bound; the others by events."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    rng = np.random.default_rng(14)
    cases = [("sparse", w, n, 64, 56, None), *REACH_SHAPES, ("consensus", w, n, 64, 64, 0.3)]
    out, err, extra = None, 0, {"route_by_shape": {}, "ms_by_shape": {}, "bound_ms_by_shape": {}}
    for label, ww, nn, K, live, density in cases:
        if label == "consensus":
            host = consensus_reach_inputs(rng, ww, nn, K)
        else:
            host = reach_many_inputs(rng, ww, nn, K, live, density)
        t = [torch.from_numpy(a).to(device) for a in host]
        km = dk.reach_many(*t)
        pm = dk.reach_many_plain(*t)
        err = max(err, int((km.int() - pm.int()).abs().max()))
        tag = f"{label} W={ww} N={nn} K={K}"
        if not torch.equal(km, pm):
            raise AssertionError(f"reach_many {tag}: kernel != plain")
        hits = pm.flatten(1).sum(1)
        if label == "consensus":
            if int((hits > 1).sum()) < K // 4:
                raise AssertionError(f"reach_many {tag}: walks {hits.tolist()}")
        elif int(hits[live:].sum()) != 0 or int((hits[:live] > 1).sum()) < live // 2:
            raise AssertionError(f"reach_many {tag}: walks {hits.tolist()}")
        route = dk.reach_route(ww, nn, device) if device.type == "cuda" else "plain"
        extra["route_by_shape"][tag] = route
        log(f"reach_many {tag} ({live} starts, {K - live} padding, {route} route): "
            f"kernel == plain, {int(hits.sum())} certificates reached, padding rows empty")
        b, by = bound_ms(reach_many_bytes(ww, nn, host[2], host[3]))
        if out is not None:
            extra["ms_by_shape"][tag] = time_ms(lambda: dk.reach_many(*t), device, reps=20)
            extra["bound_ms_by_shape"][tag] = b
            continue
        ms = time_ms(lambda: dk.reach_many(*t), device, reps=50)
        plain_ms = time_ms(lambda: dk.reach_many_plain(*t), device, reps=1, groups=3)
        extra["device_ms"] = device_breakdown(lambda: dk.reach_many(*t), device)[0]
        out = {"name": "reach_many", "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b, "bound_by": by, "library_ms": None,
               "shape": f"W={ww} N={nn} K={K} ({live} starts, top row {int(host[2].max())})"}
    out["max_abs_err"] = err
    out["extra"] = extra
    log(f"  reach_many: device {extra['device_ms']} ms at "
        f"{out['shape']}; events ms by shape {extra['ms_by_shape']}")
    return out


def support_inputs(rng: np.random.Generator, w: int, n: int, b: int, density: float):
    """B walks of one consensus step on a random window: parent links at
    `density`, present at 90 %, stakes 1..4, offsets and leaders at random
    (row 0 and the top row among them), each walk's one-hot on its leader,
    and each authority's last committed round."""
    parent = (rng.random((w, n, n)) < density).astype(np.uint8)
    present = (rng.random((w, n)) < 0.9).astype(np.uint8)
    stakes = rng.integers(1, 5, n).astype(np.int32)
    offs = rng.integers(0, w, b).astype(np.int32)
    offs[:2] = (w - 1, 0)[:b]
    leaders = rng.integers(0, n, b).astype(np.int32)
    onehots = np.zeros((b, n), np.uint8)
    onehots[np.arange(b), leaders] = 1
    last = rng.integers(-3, w // 2, n).astype(np.int32)
    return parent, present, stakes, offs, onehots, leaders, last


def check_leader_support(device, n: int, w: int):
    """B5 at the consensus step's shape against its plain version, then its
    range check: an offset outside the window and a leader outside the
    link columns, each in a call of the same walks, raise the CPU's
    ValueError (the lowest bad walk named) from the kernel's error words,
    and the other walks of that call are the plain version's. Timed, with
    the device time of one call."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    rng = np.random.default_rng(15)
    parent, present, stakes, offs, _oh, leaders, _last = support_inputs(rng, w, n, 64, 0.3)
    t = [torch.from_numpy(a).to(device) for a in (parent, present, stakes, offs, leaders)]
    got, want = dk.leader_support(*t), dk.leader_support_plain(*t)
    if not torch.equal(got, want):
        raise AssertionError("leader_support: kernel != plain")
    if tuple(got.shape) != (64,) or not 0 < int(got.min()) < int(got.max()):
        raise AssertionError(f"leader_support: sums {got.tolist()}")
    for what, bad_offs, bad_leaders in (("offset", (w, -1), None), ("leader", None, (n, -3))):
        o, l = offs.copy(), leaders.copy()
        for b, v in zip((41, 17), bad_offs or bad_leaders):
            (o if bad_offs else l)[b] = v
        messages = []
        for dev in ("cpu", device):
            bt = [torch.from_numpy(a).to(dev) for a in (parent, present, stakes, o, l)]
            try:
                dk.leader_support(*bt)
            except ValueError as e:
                messages.append(str(e))
            else:
                raise AssertionError(f"leader_support: an out-of-range {what} on {dev} did "
                                     "not raise")
        if messages[0] != messages[1] or "walk 17 " not in messages[0]:
            raise AssertionError(f"leader_support: out-of-range {what}: {messages}")
        if device.type == "cuda":  # the call's in-range walks, read past the raise
            bt = [torch.from_numpy(a).to(device) for a in (parent, present, stakes, o, l)]
            part, _check = dk._leader_support(*bt)
            keep = torch.ones(64, dtype=torch.bool)
            keep[[17, 41]] = False
            if not torch.equal(part.cpu()[keep], want.cpu()[keep]) or bool(part[[17, 41]].any()):
                raise AssertionError(f"leader_support: the in-range walks of a call with an "
                                     f"out-of-range {what} differ")
    log(f"leader_support W={w} N={n} B=64 (rows 0 and {w - 1} among the offsets): "
        f"kernel == plain, support {int(got.min())}..{int(got.max())}; an out-of-range "
        f"offset and leader each raise as on the CPU: {messages[1]}")
    ms = time_ms(lambda: dk.leader_support(*t), device, reps=50)
    plain_ms = time_ms(lambda: dk.leader_support_plain(*t), device, reps=20)
    # Per walk its parent column (N bytes) and offset and leader read, its
    # sum written; each distinct present row and the stakes read once.
    nbytes = 64 * (n + 8 + 4) + len(set(offs.tolist())) * n + 4 * n
    b, by = bound_ms(nbytes)
    return {"name": "leader_support", "max_abs_err": int((got - want).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None, "shape": f"W={w} N={n} B=64",
            "extra": {"device_ms": device_breakdown(lambda: dk.leader_support(*t),
                                                     device)[1].get("leader_support_kernel")}}


# B7's shapes (label, B, W, M, S, masks' offset past a 16-byte boundary,
# stakes): the consensus step's (on B6's masks), the dry run's shard block
# (W 8, N 8 over a 2 x 2 mesh: M 4 of S 8), a shard block of the consensus
# step's 2 x 2 mesh (M 25 of S 50), N 200 and 1024, one walk, a slab of 91
# bytes (walks straddle 16-byte words), the masks a view 3 bytes past a
# boundary (every byte alone), and a stake sum that wraps int32. Support
# is exactly at quorum in walk 0 and one below in walk 1.
COMMIT_SHAPES = (
    ("consensus step", 64, W, N, N, 0, "small"),
    ("dry run shard block", 2, 8, 4, 8, 0, "small"),
    ("mesh shard block", 32, W, 25, 2 * 25, 0, "small"),
    ("N 200", 8, W, 200, 200, 0, "small"),
    ("N 1024", 2, 16, 1024, 1024, 0, "small"),
    ("B 1", 1, W, N, N, 0, "small"),
    ("unaligned slab", 9, 7, 13, 13, 0, "small"),
    ("masks view", 9, 7, 13, 13, 3, "small"),
    ("wrapping stakes", 64, W, N, N, 0, "wrap"),
)


def commit_inputs(rng: np.random.Generator, device, b: int, w: int, m: int, s: int,
                  offset: int = 0, stakes: str = "small", masks=None):
    """consensus_commit's four tensors on `device`: `masks` (bool [b, w, m])
    or random ones at 30 %, a view `offset` bytes into its storage; stakes
    1..4, or large enough that their sum wraps int32; support around the
    quorum, walk 0 exactly at it and walk 1 one below; last_committed with
    negative entries."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    if masks is None:
        masks = torch.from_numpy(rng.random((b, w, m)) < 0.3).to(device)
    flat = torch.zeros((offset + b * w * m,), dtype=torch.bool, device=device)
    flat[offset:] = masks.reshape(-1)
    lo, hi = (2**30, 2**31 - 1) if stakes == "wrap" else (1, 5)
    st = rng.integers(lo, hi, s).astype(np.int32)
    quorum = dk._wrap32(int(st.astype(np.int64).sum())) // 3 + 1
    support = (quorum + rng.integers(-4, 4, b)).astype(np.int32)
    support[:2] = (quorum, quorum - 1)[:b]
    last = rng.integers(-3, max(w, 1), m).astype(np.int32)
    return [flat[offset:].view(b, w, m)] + [torch.from_numpy(a).to(device)
                                             for a in (support, st, last)]


def check_consensus_commit(device, n: int, w: int):
    """At each of COMMIT_SHAPES, the consensus step's on B6's K = 64 masks
    (the kernels phase's reach_many inputs): committed and new_last
    bit-equal to the plain version, one launch a call; the walks at quorum
    commit, the one below does not. Timed at the consensus step's shape."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu import kernel_registry

    rng = np.random.default_rng(16)
    host = reach_many_inputs(rng, w, n, 64, 56)
    b6 = dk.reach_many(*(torch.from_numpy(a).to(device) for a in host))
    err = 0
    for label, b, ww, m, s, offset, stakes in COMMIT_SHAPES:
        masks = b6 if label == "consensus step" else None
        t = commit_inputs(rng, device, b, ww, m, s, offset, stakes, masks)
        kernel_registry.reset_launch_counts()
        kc, kl = dk.consensus_commit(*t)
        if device.type == "cuda" and kernel_registry.launch_counts()["consensus_commit"] != 1:
            raise AssertionError(f"consensus_commit {label}: not one launch")
        pc, pl = dk.consensus_commit_plain(*t)
        if not (torch.equal(kc, pc) and torch.equal(kl, pl)):
            raise AssertionError(f"consensus_commit {label}: kernel != plain")
        if b > 1 and not (bool(kc[0].any()) and not bool(kc[1].any())):
            raise AssertionError(f"consensus_commit {label}: the quorum test is off")
        err = max(err, int((kl - pl).abs().max()) if m else 0)
        if label == "consensus step":
            main = t
    kc, kl = dk.consensus_commit(*main)
    log(f"consensus_commit: {', '.join(c[0] for c in COMMIT_SHAPES)}: kernel == plain, one "
        f"launch each; W={w} N={n} B=64: {int(kc.any(dim=(1, 2)).sum())} of 64 walks commit, "
        f"{int((kl != main[3]).sum())} last-committed rounds moved")
    ms = time_ms(lambda: dk.consensus_commit(*main), device, reps=50)
    plain_ms = time_ms(lambda: dk.consensus_commit_plain(*main), device, reps=50)
    # The masks read and the committed masks written once; support, stakes,
    # last_committed read, new_last written.
    b, by = bound_ms(2 * 64 * w * n + 4 * 64 + 4 * n + 8 * n)
    return {"name": "consensus_commit", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None, "shape": f"W={w} N={n} B=64",
            "extra": {"device_ms": device_breakdown(lambda: dk.consensus_commit(*main),
                                                     device)[0]}}


def walk_blocks(auth: int, parent, present, lc, onehots):
    """numpy operands of sharded_walk over `auth` shards: the committee axis
    padded to a multiple of `auth` with absent slots, then cut into column
    blocks stacked first: parent [a, W, Npad, m], present [a, W, m], lc
    [a, m] (None passes through), the one-hots whole [K, Npad]."""
    n = present.shape[1]
    pad = -(-n // auth) * auth - n
    m = (n + pad) // auth

    def blocks(x):
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
        return np.ascontiguousarray(np.stack([x[..., i * m:(i + 1) * m] for i in range(auth)]))

    parent = np.pad(parent, ((0, 0), (0, pad), (0, 0)))
    return (blocks(parent), blocks(present), None if lc is None else blocks(lc),
            np.pad(onehots, ((0, 0), (0, pad))))


def unblock(masks, n: int):
    """sharded_walk's masks [a, K, W, m] as [K, W, N]."""
    a, k, w, m = masks.shape
    return masks.permute(1, 2, 0, 3).reshape(k, w, a * m)[..., :n]


def walk_routes(device) -> tuple:
    """The walk routes a device can be forced onto: all three on the card;
    on the CPU (a rehearsal) the peer exchange has no form."""
    return ("cluster", "peer", "host") if device.type == "cuda" else ("cluster", "host")


EXCHANGE_ROUTES = ("peer", "host")  # the routes whose launches exchange across cards


def walk_exchange(mesh, ops, gc_depth: int, lcr: int, chain: bool, route: str = "peer", **kw):
    """sharded_walk on an exchange route ("peer" or "host") over the mesh's
    first auth row (on one card repeated, forced: each slot its own launch,
    stream and exchange buffer; over cards, a launch per card). `ops` are
    the cluster form's tensors on one card; returns the masks in that form,
    on that card."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    ex = mesh.walk(0, route)
    parent, present, lc, offs, onehots = ops
    cut = (lambda t: None if t is None else [t[s].to(d) for s, d in zip(ex.groups, ex.devices)])
    whole = (lambda t: [t.to(d) for d in ex.devices])
    masks = dk.sharded_walk(cut(parent), cut(present), cut(lc), whole(offs), whole(onehots),
                            gc_depth, lcr, chain, exchange=ex, **kw)
    out = torch.empty((parent.shape[0], *masks[0].shape[1:]), dtype=torch.bool,
                      device=parent.device)
    for s, m in zip(ex.groups, masks):
        out[s] = m.to(parent.device)
    return out


def walk_bytes(w: int, npad: int, offs, onehots, k: int) -> int:
    """sharded_walk's least traffic: with top the highest start row of a
    live walk, each shard's parent rows 1..top and present rows 0..top of
    its block, lc, offs and the one-hots read, the K masks written."""
    live = np.asarray(onehots).any(axis=1)
    top = int(min(np.max(np.asarray(offs)[live]), w - 1)) if live.any() else 0
    return top * npad * npad + (top + 1) * npad + 4 * npad + 4 * k + k * npad + k * w * npad


def check_sharded_walk(device, n: int, w: int, gc_depth: int = GC_DEPTH):
    """sharded_walk against its plain version and against B2 / B6 over
    `auth` in {2, 4} shards of this card (N = 50 padded to 52 over 4), on
    the "cluster" route and on "peer" and "host" forced on the card
    repeated: chain mode at K = 1, 2, 4 on the healed-partition chains (a
    padding slot at K = 4), many mode at K = 64 on the sparse read windows
    (W and 2W); and the compositions chain_commit_sharded /
    reach_many_sharded on every route against chain_commit / reach_many.
    Bit-equal."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu.mesh import auth_mesh

    rng = np.random.default_rng(19)
    routes = walk_routes(device)
    out, err, extra = None, 0, {"walk_routes": list(routes)}
    exchanges = EXCHANGE_ROUTES if device.type == "cuda" else ()  # card tensors only

    def same(what, got, want):
        nonlocal err
        err = max(err, int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"sharded_walk {what}: differs")

    for auth in (2, 4):
        mesh = auth_mesh(auth, devices=[device] * auth)
        for K, live in ((1, 1), (2, 2), (4, 3)):
            parent, present, lc, lcr, offs, onehots = healed_partition_chain(
                rng, w, n, gc_depth, K, live)
            ct = [torch.from_numpy(a).to(device) for a in (parent, present, lc, offs, onehots)]
            want = dk.chain_commit(ct[0], ct[1], gc_depth, ct[2], lcr, ct[3], ct[4])
            pb, qb, lb, oh = walk_blocks(auth, parent, present, lc, onehots)
            ops = [torch.from_numpy(a).to(device) for a in (pb, qb, lb, offs, oh)]
            km = dk.sharded_walk(*ops, gc_depth, lcr, True)
            same(f"chain auth={auth} K={K} cluster against plain", km,
                 dk.sharded_walk_plain(*ops, gc_depth, lcr, True))
            same(f"chain auth={auth} K={K} cluster against chain_commit", unblock(km, n), want)
            for route in exchanges:
                same(f"chain auth={auth} K={K} {route} against cluster",
                     walk_exchange(mesh, ops, gc_depth, lcr, True, route), km)
            for route in routes:
                same(f"chain_commit_sharded auth={auth} K={K} {route}",
                     dk.chain_commit_sharded(mesh, parent, present, gc_depth, lc, lcr, offs,
                                             onehots, route=route), want)
            if auth == 2 and K == 1:
                args = (*ops, gc_depth, lcr, True)
                ms = time_ms(lambda: dk.sharded_walk(*args), device, reps=50)
                plain_ms = time_ms(lambda: dk.sharded_walk_plain(*args), device, reps=3)
                for route in exchanges:
                    extra[f"{route}_ms"] = time_ms(
                        lambda: walk_exchange(mesh, ops, gc_depth, lcr, True, route),
                        device, reps=20)
                extra["chain_commit_ms_same_inputs"] = time_ms(
                    lambda: dk.chain_commit(ct[0], ct[1], gc_depth, ct[2], lcr, ct[3], ct[4]),
                    device, reps=50)
                for route in routes:
                    extra[f"chain_commit_sharded_ms_{route}"] = time_ms(
                        lambda: dk.chain_commit_sharded(mesh, parent, present, gc_depth, lc,
                                                        lcr, offs, onehots, route=route),
                        device, reps=20)
                top = int(offs.max())
                b, by = bound_ms(walk_bytes(w, n, offs, onehots, K))
                # The time a row costs, measured: the slope between this walk
                # and one from row 2 of the same window (rows are sequential).
                low = [*ops[:3], torch.full_like(ops[3], 2), ops[4]]
                low_ms = time_ms(lambda: dk.sharded_walk(*low, gc_depth, lcr, True), device,
                                 reps=50)
                extra["row_ms"] = (ms - low_ms) / (top - 2)
                extra["rows_ms"] = extra["row_ms"] * top
                out = {"name": "sharded_walk", "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b, "bound_by": by, "library_ms": None,
                       "shape": f"W={w} N={n} auth=2 ({pb.shape[-1]} columns a shard) K=1 "
                                f"leader row {top}, chain mode, cluster route"}
        for ww, K, live in ((w, 64, 56), (2 * w, 64, 61)):
            rin = reach_many_inputs(rng, ww, n, K, live)
            want = dk.reach_many(*(torch.from_numpy(a).to(device) for a in rin))
            pb, qb, _lb, oh = walk_blocks(auth, rin[0], rin[1], None, rin[3])
            ops = [torch.from_numpy(a).to(device) for a in (pb, qb)] + [None] + [
                torch.from_numpy(a).to(device) for a in (rin[2], oh)]
            km = dk.sharded_walk(*ops, 0, -(2**30), False)
            same(f"many auth={auth} W={ww} cluster against plain", km,
                 dk.sharded_walk_plain(*ops, 0, -(2**30), False))
            same(f"many auth={auth} W={ww} cluster against reach_many", unblock(km, n), want)
            for route in exchanges:
                same(f"many auth={auth} W={ww} {route} against cluster",
                     walk_exchange(mesh, ops, 0, -(2**30), False, route), km)
            for route in routes:
                same(f"reach_many_sharded auth={auth} W={ww} {route}",
                     dk.reach_many_sharded(mesh, *rin, route=route), want)
            if auth == 2 and ww == w:
                extra["many_ms_k64"] = time_ms(
                    lambda: dk.sharded_walk(*ops, 0, -(2**30), False), device, reps=50)
                extra["many_bound_ms_k64"] = bound_ms(
                    walk_bytes(ww, n, rin[2], rin[3], K) - 4 * n)[0]
                extra["reach_many_ms_same_inputs"] = time_ms(
                    lambda: dk.reach_many(*(torch.from_numpy(a).to(device) for a in rin)),
                    device, reps=20)
                for route in routes:
                    extra[f"reach_many_sharded_ms_{route}"] = time_ms(
                        lambda: dk.reach_many_sharded(mesh, *rin, route=route), device,
                        reps=10)
        log(f"sharded_walk auth={auth} (N={n} padded to {-(-n // auth) * auth}): == plain, "
            f"== chain_commit (K 1, 2, 4) and == reach_many (K 64, W {w} and {2 * w}) on "
            f"{extra['walk_routes']}; the compositions == B2 / B6 on {list(routes)}")
    per_route = (lambda what: " / ".join(f"{extra[f'{what}_ms_{r}']:.4f}" for r in routes))
    log(f"sharded_walk: chain K=1 {out['ms']:.4f} ms (cluster), peer / host (a launch a shard "
        f"on the card) {extra.get('peer_ms', float('nan')):.4f} / "
        f"{extra.get('host_ms', float('nan')):.4f} ms; "
        f"B2 {extra['chain_commit_ms_same_inputs']:.4f} ms; "
        f"many K=64 {extra['many_ms_k64']:.4f} ms (B6 {extra['reach_many_ms_same_inputs']:.4f}); "
        f"bound {out['bound_ms']:.7f} ms ({out['bound_by']}); measured {extra['row_ms']:.5f} ms "
        f"a row, {extra['rows_ms']:.4f} ms for its {top} sequential rows; {'/'.join(routes)}: "
        f"chain_commit_sharded {per_route('chain_commit_sharded')} ms, reach_many_sharded "
        f"{per_route('reach_many_sharded')} ms")
    out["max_abs_err"] = err
    out["extra"] = extra
    return out


def check_peer_reuse(device, n: int = 50, w: int = 64, devices=None,
                     route: str = "peer") -> list:
    """One exchange of `route` ("peer" or "host") over 4 shards of the card
    (forced), or over `devices` (cards), reused by calls
    that change mode and walk count, each on fresh inputs: many mode at
    K = 64 (the buffers laid out for 64 walk slots), chain mode (one slot),
    many at K = 64, many at K = 5, chain again. Each result must equal B6 /
    B2: a launch with fewer walks than the buffers were laid out for must
    find every flag where the earlier launches left it, not on bytes that
    held another call's lcr or frontier. Returns the (mode, K) sequence."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu.mesh import auth_mesh

    devices = devices or [device] * 4
    mesh = auth_mesh(len(devices), devices=devices)
    rng = np.random.default_rng(23)
    seq = [("many", 64), ("chain", 4), ("many", 64), ("many", 5), ("chain", 2)]
    for mode, K in seq:
        if mode == "many":
            rin = reach_many_inputs(rng, w, n, K, K - 2)
            want = dk.reach_many(*(torch.from_numpy(a).to(device) for a in rin))
            got = dk.reach_many_sharded(mesh, *rin, route=route).to(device)
        else:
            parent, present, lc, lcr, offs, onehots = healed_partition_chain(
                rng, w, n, GC_DEPTH, K, K - 1)
            t = [torch.from_numpy(a).to(device) for a in (parent, present, lc, offs, onehots)]
            want = dk.chain_commit(t[0], t[1], GC_DEPTH, t[2], lcr, t[3], t[4])
            got = dk.chain_commit_sharded(mesh, parent, present, GC_DEPTH, lc, lcr, offs,
                                          onehots, route=route).to(device)
        if not (bool(want.any()) and torch.equal(got, want)):
            raise AssertionError(f"sharded_walk: the reused {route} exchange differs at {mode} "
                                 f"K={K}")
    log(f"sharded_walk: one {route} exchange over {[str(d) for d in devices]} reused by {seq}: "
        f"each == B6 / B2")
    return seq


def check_walk_deadline(device, n: int = 50, w: int = 64, timeout_ms: int = 100,
                        route: str = "peer"):
    """A missing peer: only slot 0 of a forced exchange route (`route`)
    launched, with a short deadline. The call must raise RuntimeError within the deadline
    (plus the host's own wait), and the exchange must work again after."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu.mesh import auth_mesh

    parent, present, lc, lcr, offs, onehots = healed_partition_chain(
        np.random.default_rng(20), w, n, GC_DEPTH, 1, 1)
    pb, qb, lb, oh = walk_blocks(2, parent, present, lc, onehots)
    ops = [torch.from_numpy(a).to(device) for a in (pb, qb, lb, offs, oh)]
    mesh = auth_mesh(2, devices=[device] * 2)
    want = dk.sharded_walk(*ops, GC_DEPTH, lcr, True)
    t0 = time.perf_counter()
    try:
        walk_exchange(mesh, ops, GC_DEPTH, lcr, True, route, launch=[0], timeout_ms=timeout_ms)
    except RuntimeError as e:
        wall = time.perf_counter() - t0
        log(f"sharded_walk: a missing peer on {route} raised after {wall * 1e3:.1f} ms "
            f"(deadline {timeout_ms} ms): {e}")
    else:
        raise AssertionError(f"sharded_walk: a missing peer on {route} did not raise")
    if wall > timeout_ms / 1e3 + 2.0:
        raise AssertionError(f"sharded_walk: a missing peer on {route} took {wall:.3f} s to "
                             "raise")
    if not torch.equal(walk_exchange(mesh, ops, GC_DEPTH, lcr, True, route), want):
        raise AssertionError(f"sharded_walk: the {route} route differs after a missed deadline")
    return wall


def phase_kernels(device, f, w=W, bucket=BUCKET, n_keys=300, n_ref=300, plain_reps=3):
    n = f.committee.size()
    rows = [
        check_verify_batch(device, bucket, n_keys, n_ref, plain_reps),
        check_msm_accumulate(device, f, bucket, n_keys, plain_reps),
        *check_staged(device, f, bucket, n_keys, plain_reps),
        check_window_sync(device, n, w),
        check_place_batch(device, n, w),
        check_roll_window(device, n, w),
        check_chain_commit(device, n, w),
        check_reach_many(device, n, w),
        check_leader_support(device, n, w),
        check_consensus_commit(device, n, w),
        check_sharded_walk(device, n, w),
    ]
    shapes_err = check_msm_shapes(device) if device.type == "cuda" else 0
    sizes_err = check_verify_sizes(device, n_keys, VERIFY_SIZES if device.type == "cuda"
                                   else VERIFY_SIZES[:2])
    for r in rows:
        if r["name"] in ("msm_accumulate", "msm_window"):
            r["max_abs_err"] = max(r["max_abs_err"], shapes_err)
        r["max_abs_err"] = max(r["max_abs_err"], sizes_err.get(r["name"], 0))
    if device.type == "cuda":
        for route in EXCHANGE_ROUTES:
            check_peer_reuse(device, n, w, route=route)
            check_walk_deadline(device, n, w, route=route)
    by_name = {r["name"]: r for r in rows}
    # B4 and B3 are window_sync's wrappers: their numbers ride on its row
    sync = by_name["window_sync"]
    for name in ("roll_window", "place_batch"):
        wrapped = {k: v for k, v in by_name[name].items() if k != "name"}
        sync["extra"][name] = wrapped
        sync["max_abs_err"] = max(sync["max_abs_err"], wrapped["max_abs_err"])
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {r['name']:13s} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")
    return by_name


# ---------------------------------------------------------------------------
# Phase: the engine on an unsigned lossy DAG
# ---------------------------------------------------------------------------


def lossy_dag(committee, rounds: int, seed: int, gap: range, weak: set, failure=0.3):
    """Unsigned certificates, each round linking every previous-round
    certificate with probability 1 - failure (at least a quorum). In the
    `gap` rounds the elected leader's certificate is missing, so nothing
    commits and the window must grow; for a leader round in `weak`, only a
    fifth of the next round's certificates link the leader (below f + 1
    stake), so it commits later, as part of a chain."""
    from narwhal_tpu_torch.fixtures import mock_certificate
    from narwhal_tpu_torch.types import Certificate

    rng = random.Random(seed)
    keys = committee.authority_keys()
    n_weak = len(keys) // 5
    prev = {c.origin: c.digest for c in Certificate.genesis(committee)}
    certs = []
    for r in range(1, rounds + 1):
        leader_prev = committee.leader(r - 1) if (r - 1) in weak else None
        cur = {}
        for i, pk in enumerate(keys):
            if r in gap and r % 2 == 0 and pk == committee.leader(r):
                continue
            cands = sorted(prev.items())
            quorum = (2 * len(cands)) // 3 + 1
            kept = [d for p, d in cands if rng.random() >= failure]
            if len(kept) < quorum:
                kept = [d for _, d in rng.sample(cands, quorum)]
            if leader_prev is not None and leader_prev in prev:
                ld = prev[leader_prev]
                kept = [d for d in kept if d != ld]
                if i < n_weak:
                    kept.append(ld)
            cert = mock_certificate(committee, pk, r, set(kept))
            certs.append(cert)
            cur[pk] = cert.digest
        prev = cur
    return certs


def host_run(engine_cls, f, certs, gc=GC_DEPTH):
    """The port's host engine (`consensus.Bullshark` or `consensus.Tusk`,
    the pure-Python commit rules) over `certs`, one certificate at a time,
    on an in-memory store: (digest, consensus_index) of every commit, and
    the store's record (`store_record`)."""
    from narwhal_tpu_torch.consensus import ConsensusState
    from narwhal_tpu_torch.stores import NodeStorage
    from narwhal_tpu_torch.types import Certificate

    state = ConsensusState(Certificate.genesis(f.committee))
    store = NodeStorage(None).consensus_store
    eng = engine_cls(f.committee, store, gc)
    seq, i = [], 0
    for c in certs:
        outs = eng.process_certificate(state, i, c)
        i += len(outs)
        seq.extend((o.certificate.digest, o.consensus_index) for o in outs)
    return seq, store_record(store)


def store_record(store):
    """What a ConsensusStore holds: last committed round by authority, the
    next consensus index, and every sequenced (index, digest)."""
    return (store.read_last_committed(), store.last_consensus_index(),
            store.read_sequenced_digests_after(0))


def feed_rounds(eng, state, certs, n: int, idx: int = 0):
    """Feed `certs` to `eng` one round (n certificates) per
    process_batch_async call, as the consensus runner does. Returns the
    committed outputs and the largest window W seen."""
    out, max_w = [], eng.win.W

    async def drive():
        nonlocal idx, max_w
        for lo in range(0, len(certs), n):
            outs = await eng.process_batch_async(state, idx, certs[lo:lo + n])
            idx += len(outs)
            out.extend(outs)
            max_w = max(max_w, eng.win.W)

    asyncio.run(drive())
    return out, max_w


def engine_stream(f, rounds: int, seed: int):
    """The engine paths' lossy DAG: a gap of 22 rounds from 2/5 of the run
    with no elected leader (the window grows) and three weak leaders near
    13/20 of it (a chain of 3+ leaders commits at once)."""
    gap = range(rounds * 2 // 5, rounds * 2 // 5 + 22)
    weak = {r - (r % 2) for r in (rounds * 13 // 20 + d for d in (0, 2, 4))}
    return lossy_dag(f.committee, rounds, seed, gap, weak)


def engine_path(path, device, f, engine_cls, host_cls, certs, gc, ref_out, ref_state,
                mesh=None, label=None):
    """Drive `engine_cls` (GpuBullshark or GpuTusk) on `device`, or on
    `mesh` when given, over `certs`, one round per process_batch_async
    call, with the launch counts set to 0 just before and read just after.
    Its commit sequence must equal the CPU engine's (`ref_out`,
    `ref_state`) and the host engine's (`host_cls`); the window must grow
    and slide, and a chain of 3+ leaders commit in one event. Returns the
    engine, its state and outputs, the launch counts, the certificates per
    second and the number of commit events. `label` names the run in its
    messages (default `path`, whose kernels it must launch)."""
    import torch
    from narwhal_tpu_torch.consensus import ConsensusState
    from narwhal_tpu_torch.gpu import kernel_registry
    from narwhal_tpu_torch.stores import NodeStorage
    from narwhal_tpu_torch.types import Certificate

    n = f.committee.size()
    name = label or path
    state = ConsensusState(Certificate.genesis(f.committee))
    where = {"device": device} if mesh is None else {"mesh": mesh}
    eng = engine_cls(f.committee, NodeStorage(None).consensus_store, gc, **where)
    w0 = eng.win.W
    chains: list[int] = []  # the chain length K of every commit event
    dispatch = eng._dispatch_commit

    def counted_dispatch(*a):
        res = dispatch(*a)
        if res is not None:
            chains.append(res[1])
        return res

    eng._dispatch_commit = counted_dispatch
    kernel_registry.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, max_w = feed_rounds(eng, state, certs, n)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_registry.launch_counts()
    del eng._dispatch_commit

    seq = [(o.certificate.digest, o.consensus_index) for o in out]
    if seq != [(o.certificate.digest, o.consensus_index) for o in ref_out]:
        raise AssertionError(f"{name}: commit sequence differs from the CPU engine")
    if seq != host_run(host_cls, f, certs, gc)[0]:
        raise AssertionError(f"{name}: commit sequence differs from the host {host_cls.__name__}")
    if state.last_committed != ref_state.last_committed:
        raise AssertionError(f"{name}: last_committed differs from the CPU engine")
    if max_w <= w0 or eng.win.round_base == 0:
        raise AssertionError(f"{name}: the window must grow and slide (W {max_w}, "
                             f"base {eng.win.round_base})")
    if max(chains) < 3:
        raise AssertionError(f"{name}: no chain of 3+ leaders (max K {max(chains)})")
    require_launches(path, launches, device)
    log(f"{name}: N={n}, {certs[-1].round} rounds, {len(certs)} certificates, {len(out)} "
        f"committed (== CPU engine == host {host_cls.__name__}), window grew to W={max_w} "
        f"and slid to base {eng.win.round_base}; {len(chains)} commit events, chain "
        f"lengths {sorted(set(chains))}; {wall:.3f} s host wall, {len(certs) / wall:.1f} "
        f"certificates/s; launches {launches}")
    return eng, state, out, launches, len(certs) / wall, len(chains)


def phase_engine(device, f, rounds=200, gc=GC_DEPTH):
    """The engine entry point on its own. Returns what the pipeline phase
    continues from: the unsigned stream, the card engine and its state, and
    the CPU engine and its state after the same stream."""
    from narwhal_tpu_torch.consensus import Bullshark, ConsensusState
    from narwhal_tpu_torch.gpu.dag_kernels import GpuBullshark
    from narwhal_tpu_torch.stores import NodeStorage
    from narwhal_tpu_torch.types import Certificate

    certs = engine_stream(f, rounds, 3)
    ref_state = ConsensusState(Certificate.genesis(f.committee))
    ref_eng = GpuBullshark(f.committee, NodeStorage(None).consensus_store, gc, device="cpu")
    ref_out, ri = [], 0
    for c in certs:
        outs = ref_eng.process_certificate(ref_state, ri, c)
        ri += len(outs)
        ref_out.extend(outs)
    eng, state, out, launches, rate, _events = engine_path(
        "engine", device, f, GpuBullshark, Bullshark, certs, gc, ref_out, ref_state)
    return {"certs": certs, "eng": eng, "state": state, "index": len(out), "ref_out": ref_out,
            "ref_eng": ref_eng, "ref_state": ref_state, "launches": launches,
            "certificates_per_s": rate}


# ---------------------------------------------------------------------------
# Phase: GpuTusk on an unsigned lossy DAG
# ---------------------------------------------------------------------------


def phase_tusk(device, f, rounds=200, gc=GC_DEPTH):
    """GpuTusk.process_batch_async on the card over a lossy DAG built like
    the engine phase's (another seed), held to the CPU engine, fed the same
    way, and to the port's host Tusk."""
    from narwhal_tpu_torch.consensus import ConsensusState, Tusk
    from narwhal_tpu_torch.gpu.dag_kernels import GpuTusk
    from narwhal_tpu_torch.types import Certificate

    certs = engine_stream(f, rounds, 4)
    ref_state = ConsensusState(Certificate.genesis(f.committee))
    ref_out, _ = feed_rounds(GpuTusk(f.committee, None, gc, device="cpu"), ref_state, certs,
                             f.committee.size())
    _eng, _state, _out, launches, rate, _events = engine_path(
        "tusk", device, f, GpuTusk, Tusk, certs, gc, ref_out, ref_state)
    return {"launches": launches, "certificates_per_s": rate}


# ---------------------------------------------------------------------------
# Phase: the consensus runner over a durable node store, across a restart
# ---------------------------------------------------------------------------


def port_modules():
    """The port's modules the runner path uses, as one namespace. The CPU
    parity tests pass the JAX package's modules in its place, so one feed
    runs both packages' runners."""
    from types import SimpleNamespace

    import narwhal_tpu_torch.channels as channels
    import narwhal_tpu_torch.consensus as consensus
    import narwhal_tpu_torch.consensus.metrics as cmetrics
    import narwhal_tpu_torch.metrics as metrics
    import narwhal_tpu_torch.stores as stores
    import narwhal_tpu_torch.types as types

    return SimpleNamespace(channels=channels, consensus=consensus, cmetrics=cmetrics,
                           metrics=metrics, stores=stores, types=types)


def count_processed(engine) -> list:
    """Wrap the engine's process methods on the instance, so that each
    certificate it is handed adds one to the returned counter once the call
    returns; the second entry sums the calls' host wall. The runner emits a
    call's outputs before it next yields, so a counter that reached the
    certificates sent means they are processed and their outputs sent."""
    done = [0, 0.0]
    for name in ("process_certificate", "process_certificate_async", "process_batch_async"):
        fn = getattr(engine, name, None)
        if fn is None:
            continue
        if name == "process_batch_async":
            async def wrapped(state, index, certs, fn=fn):
                t0 = time.perf_counter()
                out = await fn(state, index, certs)
                done[0] += len(certs)
                done[1] += time.perf_counter() - t0
                return out
        elif name == "process_certificate_async":
            async def wrapped(state, index, cert, fn=fn):
                t0 = time.perf_counter()
                out = await fn(state, index, cert)
                done[0] += 1
                done[1] += time.perf_counter() - t0
                return out
        else:
            def wrapped(state, index, cert, fn=fn):
                t0 = time.perf_counter()
                out = fn(state, index, cert)
                done[0] += 1
                done[1] += time.perf_counter() - t0
                return out
        setattr(engine, name, wrapped)
    return done


def _drain(channel) -> list:
    out = []
    while (item := channel.try_recv()) is not None:
        out.append(item)
    return out


async def consensus_life(m, committee, engine, storage, bursts, gc, metrics=None, notes=None,
                         timeout: float = 600.0):
    """One life of a node's consensus: a new `m.consensus.Consensus` over
    `storage`'s consensus and certificate stores (its constructor recovers
    from them) drives `engine`. Each burst of `bursts` is group-committed to
    the certificate store (awaited), then sent on the certificate channel at
    once, so the runner drains up to 64 a pass; the next burst goes only when
    this one is processed. `notes` maps a burst's index to a
    ReconfigureNotification sent on the Watch (and taken) before it. Then
    the shutdown notification on the Watch ends the runner. Returns the
    runner's outputs (tx_output), its primary stream (tx_primary), the
    runner, and the host wall of the engine's calls."""
    rx, tx_primary, tx_output = (m.channels.Channel(1 << 20) for _ in range(3))
    watch = m.channels.Watch(m.types.ReconfigureNotification("boot"))
    runner = m.consensus.Consensus(committee, engine, storage.consensus_store,
                                   storage.certificate_store, rx, tx_primary, tx_output,
                                   watch, gc, metrics)
    done = count_processed(engine)
    task = runner.spawn()
    deadline = time.monotonic() + timeout

    async def settle(ready):
        while not ready():
            if task.done():
                task.result()
                raise AssertionError("runner: the runner ended before its input")
            if time.monotonic() > deadline:
                raise TimeoutError(f"runner: {done[0]} certificates processed")
            await asyncio.sleep(0.0005)

    want = 0
    for i, burst in enumerate(bursts):
        note = (notes or {}).get(i)
        if note is not None:
            watch.send(note)
            await settle(lambda: runner.committee is note.committee)
        await storage.certificate_store.write_all_async(burst)
        await rx.send_many(burst)
        want += sum(c.epoch == runner.committee.epoch for c in burst)
        await settle(lambda: done[0] >= want and rx.empty())
    watch.send(m.types.ReconfigureNotification("shutdown"))
    await asyncio.wait_for(task, timeout)
    return _drain(tx_output), _drain(tx_primary), runner, done[1]


def runner_bursts(certs, n: int, burst_rounds: int = 2, lone_every: int = 10) -> list:
    """The certificate stream as the runner's input: `burst_rounds` rounds
    of n certificates a burst, and every round that is a multiple of
    `lone_every` one certificate at a time."""
    by_round: dict[int, list] = {}
    for c in certs:
        by_round.setdefault(c.round, []).append(c)
    bursts, cur = [], []
    for r in sorted(by_round):
        if r % lone_every == 0:
            if cur:
                bursts.append(cur)
                cur = []
            bursts.extend([c] for c in by_round[r])
            continue
        cur.extend(by_round[r])
        if len(cur) >= burst_rounds * n:
            bursts.append(cur)
            cur = []
    if cur:
        bursts.append(cur)
    return bursts


def runner_restart(device, f, engine_cls, certs, stop_round: int, gc=GC_DEPTH, metrics=None,
                   native: bool = True):
    """The port's consensus runner over `engine_cls` on `device` and a
    durable `NodeStorage(tmpdir)` (the native engine, or with `native=False`
    the Python WAL through NARWHAL_NATIVE=0): rounds up to `stop_round`,
    then a shutdown through the Watch, the storage closed and reopened on
    the same directory, a new engine and a new Consensus that recover from
    it, and the rounds after `stop_round`. Returns the joined outputs, the
    primary stream, the store's record after the run, the second runner,
    and the walls of the two lives and of the restart between them, with
    the part of the lives in the engine's calls and, inside those, in the
    ConsensusStore's writes."""
    import tempfile

    m = port_modules()
    n = f.committee.size()
    lives = (("first", runner_bursts([c for c in certs if c.round <= stop_round], n)),
             ("second", runner_bursts([c for c in certs if c.round > stop_round], n)))
    env = os.environ.get("NARWHAL_NATIVE")
    os.environ["NARWHAL_NATIVE"] = "1" if native else "0"
    walls = {"restart_s": 0.0, "engine_s": 0.0, "store_write_s": 0.0}
    outs, prim = [], []
    try:
        with tempfile.TemporaryDirectory(prefix="runner-") as path:
            for life, bursts in lives:
                t0 = time.perf_counter()
                storage = m.stores.NodeStorage(path)
                if (storage.engine._native is not None) != native:
                    raise AssertionError("runner: the storage engine is not the "
                                         f"{'native' if native else 'Python WAL'} one")
                eng = engine_cls(f.committee, storage.consensus_store, gc, device=device)
                if life == "second":
                    walls["restart_s"] += time.perf_counter() - t0
                store_write = storage.consensus_store.write_consensus_state

                def timed_write(*a, write=store_write):
                    t1 = time.perf_counter()
                    write(*a)
                    walls["store_write_s"] += time.perf_counter() - t1

                storage.consensus_store.write_consensus_state = timed_write
                t0 = time.perf_counter()
                o, p, runner, engine_s = asyncio.run(
                    consensus_life(m, f.committee, eng, storage, bursts, gc, metrics))
                walls[f"{life}_s"] = time.perf_counter() - t0
                walls["engine_s"] += engine_s
                outs += o
                prim += p
                record = store_record(storage.consensus_store)
                t0 = time.perf_counter()
                storage.close()
                if life == "first":
                    walls["restart_s"] += time.perf_counter() - t0
    finally:
        if env is None:
            os.environ.pop("NARWHAL_NATIVE", None)
        else:
            os.environ["NARWHAL_NATIVE"] = env
    return outs, prim, record, runner, walls


def check_runner(name, outs, prim, record, runner, host, stop_round: int) -> None:
    """The runner's joined outputs, primary stream and store record against
    the host engine's run without a stop (`host_run`); the second life must
    have recovered a committed state and committed after it."""
    seq = [(o.certificate.digest, o.consensus_index) for o in outs]
    if seq != host[0]:
        at = next((i for i, (a, b) in enumerate(zip(seq, host[0])) if a != b),
                  min(len(seq), len(host[0])))
        raise AssertionError(f"{name}: outputs differ from the host engine's at {at} "
                             f"({len(seq)} against {len(host[0])})")
    if [c.digest for c in prim] != [d for d, _ in host[0]]:
        raise AssertionError(f"{name}: tx_primary differs from the committed certificates")
    if record != host[1]:
        raise AssertionError(f"{name}: the ConsensusStore record differs from the host "
                             "engine's")
    if not any(o.certificate.round <= stop_round for o in outs):
        raise AssertionError(f"{name}: nothing committed before the restart")
    if not any(o.certificate.round > stop_round for o in outs):
        raise AssertionError(f"{name}: nothing committed after the restart")
    if runner.state.last_committed_round <= stop_round:
        raise AssertionError(f"{name}: the second life did not commit past round {stop_round}")


def phase_runner(device, f, ctx, rounds=200, gc=GC_DEPTH, short=60):
    """`consensus.Consensus` over GpuBullshark, then GpuTusk, on `device`
    and a durable NodeStorage on the native engine, restarted halfway
    (`runner_restart`): the engine phase's stream for Bullshark, one built
    like the tusk phase's for Tusk, each held to the port's host engine over
    the same stream without a stop; then Bullshark again on the Python WAL
    (NARWHAL_NATIVE=0) over a shorter stream. A real Tracer behind
    ConsensusMetrics gives the commit stage's percentiles."""
    import torch
    from narwhal_tpu_torch import native, storage as storage_mod, tracing
    from narwhal_tpu_torch.consensus import Bullshark, Tusk
    from narwhal_tpu_torch.consensus.metrics import ConsensusMetrics
    from narwhal_tpu_torch.gpu import kernel_registry
    from narwhal_tpu_torch.gpu.dag_kernels import GpuBullshark, GpuTusk
    from narwhal_tpu_torch.metrics import Registry

    if native.load() is None:
        raise AssertionError("runner: the native storage engine did not build or load")
    runs = [("bullshark", GpuBullshark, Bullshark, ctx["certs"], rounds // 2, True),
            ("tusk", GpuTusk, Tusk, engine_stream(f, rounds, 4), rounds // 2, True),
            ("bullshark_wal", GpuBullshark, Bullshark, engine_stream(f, short, 6),
             short // 2, False)]
    hosts = [host_run(host_cls, f, certs, gc) for _, _, host_cls, certs, _, _ in runs]
    tracer = tracing.Tracer(node="runner", enabled=True, sample=1.0, ring=1 << 16)
    metrics = ConsensusMetrics(Registry(), tracer=tracer)
    groups0 = storage_mod.StorageStats.snapshot()
    results = {}
    kernel_registry.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize()
    for (name, eng_cls, _host_cls, certs, stop, on_native), host in zip(runs, hosts):
        outs, prim, record, runner, walls = runner_restart(
            device, f, eng_cls, certs, stop, gc, metrics=metrics, native=on_native)
        check_runner(f"runner {name}", outs, prim, record, runner, host, stop)
        live = walls["first_s"] + walls["second_s"]
        results[name] = {"certificates": len(certs), "committed": len(outs), "stop": stop,
                         "certificates_per_s": len(certs) / live, **walls}
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = kernel_registry.launch_counts()
    require_launches("runner", launches, device)
    groups1 = storage_mod.StorageStats.snapshot()
    n_groups = groups1["groups_committed"] - groups0["groups_committed"]
    n_ops = groups1["ops_committed"] - groups0["ops_committed"]
    spans = sorted(ev[4] - ev[3] for ev in tracer.events
                   if ev[0] == "span" and ev[1] == "commit")
    if not spans:
        raise AssertionError("runner: the tracer recorded no commit span")
    commit = {"count": len(spans), "p50_ms": spans[len(spans) // 2] * 1e3,
              "p99_ms": spans[min(len(spans) - 1, int(0.99 * len(spans)))] * 1e3}
    for name, r in results.items():
        log(f"runner {name}: {r['certificates']} certificates, {r['committed']} committed "
            f"(== the host engine without a stop; tx_primary and the ConsensusStore "
            f"record equal), restarted after round {r['stop']}; "
            f"{r['certificates_per_s']:.1f} certificates/s (host wall of both lives), "
            f"lives {r['first_s']:.3f} + {r['second_s']:.3f} s, of which engine calls "
            f"{r['engine_s']:.3f} s (ConsensusStore writes in them {r['store_write_s']:.3f} "
            f"s), restart {r['restart_s']:.3f} s")
    flush_s = groups1["flush_seconds_total"] - groups0["flush_seconds_total"]
    log(f"runner: commit stage (Tracer spans through ConsensusMetrics.commit_timer) "
        f"{commit['count']} spans, p50 {commit['p50_ms']:.3f} ms, p99 "
        f"{commit['p99_ms']:.3f} ms; StorageStats: {n_groups} groups, {n_ops} ops, "
        f"{n_ops / max(1, n_groups):.2f} ops a group, largest {groups1['max_group_ops']}, "
        f"{flush_s:.3f} s in their flushes; launches {launches}")
    return {"launches": launches, "results": results, "commit": commit,
            "storage_groups": {"groups": n_groups, "ops": n_ops,
                               "max_group_ops": groups1["max_group_ops"],
                               "flush_s": flush_s}}


# ---------------------------------------------------------------------------
# Phase: the committee-sharded engine, the consensus step, the dry run
# ---------------------------------------------------------------------------


def mesh_devices(device, k: int) -> list:
    """k devices for a mesh: the first k cards when there are k, else this
    card k times (on the CPU, a rehearsal, the CPU k times)."""
    import torch

    n = torch.cuda.device_count() if device.type == "cuda" else 0
    return [f"cuda:{i}" for i in range(k)] if n >= k else [device] * k


def phase_dag_shards(device, f, ctx, gc=GC_DEPTH):
    """GpuBullshark(mesh=auth_mesh(2, ...)) (`--dag-shards 2`) over the
    engine phase's stream: its sequence must equal the host Bullshark's and
    the unmeshed card engine's, through the sharded walk only (chain_commit
    and window_sync launch 0 times), one sharded_walk launch per card (per
    group of the route's exchange) per commit event. Then, where the mesh's
    route is another, the same on the "host" route forced (the engine walks
    on its mesh's route), counted apart."""
    from narwhal_tpu_torch.consensus import Bullshark
    from narwhal_tpu_torch.gpu.dag_kernels import GpuBullshark
    from narwhal_tpu_torch.gpu.mesh import auth_mesh

    def run(forced=None):
        mesh = auth_mesh(2, devices=mesh_devices(device, 2))
        if forced is not None:
            mesh.routes = [forced]
        route = mesh.routes[0]
        label = "dag_shards" if forced is None else f"dag_shards ({forced} forced)"
        groups = len(mesh.walk(0).groups)
        log(f"{label}: auth mesh over {[str(d) for d in mesh.rows('auth')[0]]}, route {route}")
        _eng, state, _out, launches, rate, events = engine_path(
            "dag_shards", device, f, GpuBullshark, Bullshark, ctx["certs"], gc,
            ctx["ref_out"], ctx["ref_state"], mesh=mesh, label=label)
        if state.last_committed != ctx["state"].last_committed:
            raise AssertionError(f"{label}: last_committed differs from the unmeshed card "
                                 "engine")
        for k in ("chain_commit", "window_sync"):
            if launches[k]:
                raise AssertionError(f"{label}: {k} launched {launches[k]} times on the "
                                     "meshed engine")
        if device.type == "cuda" and launches["sharded_walk"] != groups * events:
            raise AssertionError(f"{label}: {launches['sharded_walk']} sharded_walk launches "
                                 f"for {events} commit events on {groups} launch group(s)")
        log(f"{label}: route {route}, {events} commit events, {launches['sharded_walk']} "
            f"sharded_walk launches; {rate:.1f} certificates/s against the unmeshed engine's "
            f"{ctx['certificates_per_s']:.1f}")
        return {"launches": launches, "certificates_per_s": rate, "route": route,
                "commit_events": events, "devices": [str(d) for d in mesh.rows("auth")[0]]}

    out = run()
    if out["route"] != "host":
        forced = run("host")
        out["forced_host"] = {"certificates_per_s": forced["certificates_per_s"],
                              "sharded_walk_launches": forced["launches"]["sharded_walk"],
                              "commit_events": forced["commit_events"]}
    return out


def phase_consensus_step(device, f, w=W, b=64):
    """B7 on the card: B = 64 walks on an N = 50, W = 64 window through
    consensus_step (reach_many, leader_support, consensus_commit), then the
    same inputs over a 2 x 2 data x auth mesh (consensus_step_sharded) on
    the mesh's own route (the path's launches are read just after it), then
    on each other route the topology allows, forced and counted apart:
    every output equal, some walks at the quorum and some below."""
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu import kernel_registry
    from narwhal_tpu_torch.gpu.mesh import auth_mesh

    n = f.committee.size()
    host = support_inputs(np.random.default_rng(18), w, n, b, 0.3)
    mesh = auth_mesh(2, devices=mesh_devices(device, 4), data=2)
    route = mesh.routes[0]
    kernel_registry.reset_launch_counts()
    t0 = time.perf_counter()
    flat = dk.consensus_step(*(torch.from_numpy(a).to(device) for a in host))
    flat = [x.cpu() for x in flat]
    t1 = time.perf_counter()
    meshed = [x.cpu() for x in dk.consensus_step_sharded(mesh, *host)]
    t2 = time.perf_counter()
    launches = kernel_registry.launch_counts()  # the main path: the mesh's own route
    require_launches("consensus_step", launches, device)
    runs, walls = [(route, meshed)], {route: t2 - t1}
    # The other routes this topology allows, forced, each counted on its own
    # (not the main path's launches): every walk kernel runs.
    others = {"cluster": ("peer", "host"), "peer": ("host",), "host": ()}[route]
    others = [r for r in others if r in walk_routes(device)]
    forced = {}
    for r in others:
        kernel_registry.reset_launch_counts()
        t3 = time.perf_counter()
        runs.append((r, [x.cpu() for x in dk.consensus_step_sharded(mesh, *host, route=r)]))
        walls[r] = time.perf_counter() - t3
        forced[r] = kernel_registry.launch_counts()
        if device.type == "cuda" and forced[r]["sharded_walk"] <= 0:
            raise AssertionError(f"consensus_step: sharded_walk never launched on the forced {r} "
                                 "route")
    for r, out in runs:
        for name, a, c in zip(("committed", "support", "new_last"), flat, out):
            if not torch.equal(a, c):
                raise AssertionError(f"consensus_step: {name} differs meshed ({r}) and unmeshed")
    plain = dk.consensus_step(*(torch.from_numpy(a) for a in host))
    for name, a, c in zip(("committed", "support", "new_last"), flat, plain):
        if not torch.equal(a, c):
            raise AssertionError(f"consensus_step: {name} differs from the plain composition")
    quorum = int(host[2].sum()) // 3 + 1
    at = int((flat[1] >= quorum).sum())
    if not 0 < at < b:
        raise AssertionError(f"consensus_step: {at} of {b} walks at the quorum")
    log(f"consensus_step: W={w} N={n} B={b}, {at} walks at quorum {quorum}, "
        f"{int(flat[0].sum())} certificates committed; unmeshed {t1 - t0:.4f} s, over a "
        f"2 x 2 mesh ({route}) {t2 - t1:.4f} s; forced routes "
        f"{ {r: round(s, 6) for r, s in walls.items() if r != route} }; outputs equal (and "
        f"equal to the plain composition); launches {launches}; on the forced routes "
        f"{ {r: {k: c for k, c in v.items() if c} for r, v in forced.items()} }")
    return {"launches": launches, "forced_launches": forced, "unmeshed_s": t1 - t0,
            "meshed_s": t2 - t1, "route": route, "meshed_s_by_route": walls}


def phase_dryrun(device):
    """The port's driver entry points: entry()'s walk on the card equals the
    plain reach, then dryrun_multichip(4) over four cards, or this card four
    times, passes every check of its three legs."""
    import torch
    from narwhal_tpu_torch import entry as tentry
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu import kernel_registry

    kernel_registry.reset_launch_counts()
    t0 = time.perf_counter()
    fn, args = tentry.entry(device=device)
    mask = fn(*args)
    if not torch.equal(mask.cpu(), dk.reach_many_plain(*(a.cpu() for a in args))):
        raise AssertionError("dryrun: entry()'s walk differs from the plain reach")
    devices = mesh_devices(device, 4)
    if len(set(devices)) == 4:
        tentry.dryrun_multichip(4)
    else:
        tentry.dryrun_multichip(4, devices=devices)
    wall = time.perf_counter() - t0
    launches = kernel_registry.launch_counts()
    require_launches("dryrun", launches, device)
    log(f"dryrun: entry() reached {int(mask.sum())} certificates (== plain); "
        f"dryrun_multichip(4) over {[str(d) for d in devices]} passed in {wall:.3f} s; "
        f"launches {launches}")
    return {"launches": launches, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase: the external-consensus Dag service with device causal reads
# ---------------------------------------------------------------------------


def service_stream(committee, rounds: int, seed: int):
    """The Dag service's feed: N certificates a round, each linking a random
    70 % (at least a quorum) of the round below; about half carry an empty
    payload, so the DAG compresses them away as interiors."""
    from narwhal_tpu_torch.fixtures import mock_certificate
    from narwhal_tpu_torch.types import Certificate

    rng = random.Random(seed)
    keys = committee.authority_keys()
    prev = [c.digest for c in Certificate.genesis(committee)]
    quorum = 2 * len(keys) // 3 + 1
    certs = []
    for r in range(1, rounds + 1):
        cur = []
        for pk in keys:
            kept = [d for d in prev if rng.random() >= 0.3]
            if len(kept) < quorum:
                kept = rng.sample(prev, quorum)
            payload = {rng.randbytes(32): 0} if rng.random() < 0.5 else {}
            cur.append(mock_certificate(committee, pk, r, set(kept), payload=payload))
        prev = [c.digest for c in cur]
        certs.extend(cur)
    return certs


class DispatchLog:
    """Records the size of every fused device dispatch of a Dag service."""

    def __init__(self, svc):
        self.sizes: list[int] = []
        real = svc._device_causal_many

        def logged(starts):
            self.sizes.append(len(starts))
            return real(starts)

        svc._device_causal_many = logged


async def drive_dag_services(makers, f, certs, removals, checkpoints, horizon, pick_starts,
                             after_burst=None):
    """Feed each service (`makers`: name -> callable(channel) -> Dag) the
    stream through its own Channel and `Dag.spawn()`, one round at a time;
    after each round in `removals`, remove every certificate below the GC
    horizon (`horizon` rounds under the tip; genesis with the first batch)
    as the primary's block remover does; at each round in `checkpoints`
    (round -> the Ks read there), run a burst of K concurrent `read_causal`
    and `node_read_causal` calls (alternating) for each K on every service,
    over the starts `await pick_starts(round, K, removed_below)` gives. The
    K = 1 burst comes first, so it also carries the window's sync of the
    inserts since the last read. `after_burst()`, if given, runs after each
    burst, outside its walls. Returns the
    services, the bursts (each with every service's answers and wall) and
    the largest window W seen."""
    from narwhal_tpu_torch.channels import Channel
    from narwhal_tpu_torch.types import Certificate

    n = f.committee.size()
    rounds = len(certs) // n
    chans = {name: Channel(capacity=2 * n) for name in makers}
    svcs = {name: make(chans[name]) for name, make in makers.items()}
    tasks = [svc.spawn() for svc in svcs.values()]
    pending_gc = [c.digest for c in Certificate.genesis(f.committee)]
    removed_below, max_w, bursts = 0, 0, []
    try:
        for r in range(1, rounds + 1):
            batch = certs[(r - 1) * n:r * n]
            for ch in chans.values():
                await ch.send_many(batch)
            for svc in svcs.values():
                while not await svc.has_ever_contained(batch[-1].digest):
                    await asyncio.sleep(0)
                if svc._win is not None:
                    max_w = max(max_w, svc._win.W)
            if r in removals:
                gone = pending_gc + [c.digest for c in certs[removed_below * n:(r - horizon) * n]]
                pending_gc, removed_below = [], r - horizon
                for svc in svcs.values():
                    await svc.remove(gone)
            if r not in checkpoints:
                continue
            for k in checkpoints[r]:
                starts = await pick_starts(r, k, removed_below)
                rec = {"round": r, "K": k, "starts": starts}
                for name, svc in svcs.items():
                    # read_causal and node_read_causal alternate within a
                    # burst (and from one checkpoint to the next at K = 1).
                    calls = [svc.read_causal(c.digest) if (i + r // 10) % 2 == 0
                             else svc.node_read_causal(c.origin, c.round)
                             for i, c in enumerate(starts)]
                    t0 = time.perf_counter()
                    answers = await asyncio.gather(*calls)
                    rec[name] = (answers, time.perf_counter() - t0)
                bursts.append(rec)
                if after_burst is not None:
                    after_burst()
    finally:
        for svc in svcs.values():
            await svc.shutdown()
    if any(not task.done() for task in tasks):
        raise AssertionError("dag_service: a feed task outlived shutdown")
    return svcs, bursts, max_w


def phase_dag_service(device, f, rounds=200, horizon=GC_DEPTH, every=10, stretch=(70, 110),
                      checkpoints=None, b6_reps=20):
    """The external-consensus Dag service on the card: a device service
    (policy "device") and a host truth fed the same stream, with GC removals
    (none in `stretch`, so the window grows once) and bursts of K in
    (1, 8, 64) concurrent reads at the checkpoints. Every answer must equal
    the host's; B6 must launch once per fused dispatch. Then the same stream
    and reads through an adaptive service, whose answers must equal the
    host's too, for its routing verdict."""
    import torch
    from narwhal_tpu_torch.consensus import Dag
    from narwhal_tpu_torch.gpu import dag_kernels as dk
    from narwhal_tpu_torch.gpu import kernel_registry

    n = f.committee.size()
    if checkpoints is None:
        checkpoints = {70: (1, 8, 64), 150: (1,), rounds: (1, 8, 64)}
    t_build = time.perf_counter()
    certs = service_stream(f.committee, rounds, 21)
    log(f"dag_service: built {len(certs)} certificates of {rounds} rounds in "
        f"{time.perf_counter() - t_build:.1f} s (setup, untimed)")
    removals = {r for r in range(every, rounds + 1, every)
                if r > horizon and not stretch[0] <= r < stretch[1]}
    rng = random.Random(22)
    chosen: dict[tuple[int, int], list] = {}
    logs: dict[str, DispatchLog] = {}

    def make_dev(policy):
        def make(ch):
            svc = Dag(f.committee, rx_primary=ch, backend="cuda", policy=policy, device=device)
            logs[policy] = DispatchLog(svc)
            return svc
        return make

    host_ref = {}

    def make_host(ch):
        host_ref["svc"] = Dag(f.committee, rx_primary=ch)
        return host_ref["svc"]

    async def pick_live(r, k, removed_below):
        """k distinct live certificates spread over the live window."""
        host = host_ref["svc"]
        live = [c for c in certs[removed_below * n:r * n] if await host.contains(c.digest)]
        chosen[(r, k)] = rng.sample(live, k)
        return chosen[(r, k)]

    async def replay(r, k, _removed_below):
        return chosen[(r, k)]

    # B6 is timed afterwards on the inputs of the last dispatch at each
    # padded K. The wrapper keeps references only; they are copied after
    # the burst, outside its walls (no insert or removal runs in a burst).
    pending: dict[int, tuple] = {}
    captured: dict[int, tuple] = {}
    real_reach_many = dk.reach_many

    def capturing(*args):
        pending[args[2].shape[0]] = args
        return real_reach_many(*args)

    def keep_last():
        captured.update((k, tuple(a.clone() for a in args)) for k, args in pending.items())
        pending.clear()

    kernel_registry.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dk.reach_many = capturing
    try:
        t0 = time.perf_counter()
        svcs, bursts, max_w = asyncio.run(drive_dag_services(
            {"device": make_dev("device"), "host": make_host}, f, certs, removals,
            checkpoints, horizon, pick_live, keep_last))
        wall = time.perf_counter() - t0
        ada_svcs, ada_bursts, _ = asyncio.run(drive_dag_services(
            {"adaptive": make_dev("adaptive")}, f, certs, removals, checkpoints, horizon,
            replay, keep_last))
    finally:
        dk.reach_many = real_reach_many
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = kernel_registry.launch_counts()

    dev, ada = svcs["device"], ada_svcs["adaptive"]
    n_req = 0
    for rec, ada_rec in zip(bursts, ada_bursts):
        want = rec["host"][0]
        for name, got in (("device", rec["device"][0]), ("adaptive", ada_rec["adaptive"][0])):
            if got != want:
                raise AssertionError(f"dag_service {name}: a K={rec['K']} burst at round "
                                     f"{rec['round']} differs from the host service")
        if any(a[0] != c.digest for a, c in zip(want, rec["starts"])):
            raise AssertionError("dag_service: an answer does not start at its start")
        n_req += rec["K"]
    stats, ada_stats = dev.routing_stats(), ada.routing_stats()
    n_dispatch = len(logs["device"].sizes) + len(logs["adaptive"].sizes)
    if stats["dev_calls"] != sum(logs["device"].sizes) or stats["dev_calls"] != n_req:
        raise AssertionError(f"dag_service: {stats['dev_calls']} device calls, "
                             f"{sum(logs['device'].sizes)} served on the device, {n_req} reads")
    if ada_stats["dev_calls"] != sum(logs["adaptive"].sizes):
        raise AssertionError("dag_service adaptive: dev_calls != requests served on the device")
    if device.type == "cuda" and launches["reach_many"] != n_dispatch:
        raise AssertionError(f"dag_service: {launches['reach_many']} reach_many launches, "
                             f"{n_dispatch} fused dispatches")
    if max_w <= 64 or dev._win.round_base == 0:
        raise AssertionError(f"dag_service: the window must grow and slide (W {max_w}, "
                             f"base {dev._win.round_base})")
    require_launches("dag_service", launches, device)
    log(f"dag_service: N={n}, {rounds} rounds, {len(certs)} certificates through "
        f"Dag.spawn() on a Channel, GC every {every} rounds {horizon} under the tip (none in "
        f"rounds {stretch[0]}..{stretch[1] - 1}); window grew to W={max_w}, base "
        f"{dev._win.round_base} at the end; {n_req} reads at rounds {sorted(checkpoints)}, "
        f"every answer == host service; device service: {len(logs['device'].sizes)} fused "
        f"dispatches of sizes {sorted(set(logs['device'].sizes))}; {wall:.3f} s wall "
        f"(feed + reads, both services); launches {launches}")
    per_k = {}
    for k in (1, 8, 64):
        recs = [x for x in bursts if x["K"] == k]
        dev_s = sum(x["device"][1] for x in recs)
        host_s = sum(x["host"][1] for x in recs)
        ada_s = sum(x["adaptive"][1] for x in ada_bursts if x["K"] == k)
        b6 = b6_bound = None
        if k in captured:
            args = captured[k]
            b6 = time_ms(lambda: real_reach_many(*args), device, reps=b6_reps)
            b6_bound, _ = bound_ms(reach_many_bytes(args[1].shape[0], n, args[2].cpu().numpy()))
        per_k[k] = {"bursts": len(recs), "device_burst_ms": 1e3 * dev_s / len(recs),
                    "host_burst_ms": 1e3 * host_s / len(recs),
                    "adaptive_burst_ms": 1e3 * ada_s / len(recs),
                    "device_per_request_ms": 1e3 * dev_s / (len(recs) * k),
                    "host_per_request_ms": 1e3 * host_s / (len(recs) * k),
                    "reach_many_ms": b6, "reach_many_bound_ms": b6_bound}
        log(f"  K={k:2d}: burst wall device {per_k[k]['device_burst_ms']:.3f} ms, host "
            f"{per_k[k]['host_burst_ms']:.3f} ms, adaptive {per_k[k]['adaptive_burst_ms']:.3f}"
            f" ms; per request device {per_k[k]['device_per_request_ms']:.4f} ms, host "
            f"{per_k[k]['host_per_request_ms']:.4f} ms (mean of {len(recs)} bursts); "
            f"reach_many {b6 if b6 is None else f'{b6:.4f}'} ms on the last K={k} "
            f"dispatch's inputs")
    log(f"  device service routing_stats {stats}")
    log(f"  adaptive service routing_stats {ada_stats}")
    return {"launches": launches, "per_k": per_k, "routing_adaptive": ada_stats,
            "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase: the fused pipeline on a signed stream
# ---------------------------------------------------------------------------


def replay_engine(device, f, ctx):
    """A new engine and state brought to the engine phase's end state by
    replaying its unsigned stream (the pipeline phase's start state)."""
    from narwhal_tpu_torch.consensus import ConsensusState
    from narwhal_tpu_torch.gpu.dag_kernels import GpuBullshark
    from narwhal_tpu_torch.stores import NodeStorage
    from narwhal_tpu_torch.types import Certificate

    st = ConsensusState(Certificate.genesis(f.committee))
    eng = GpuBullshark(f.committee, NodeStorage(None).consensus_store, GC_DEPTH,
                       device=device)
    feed_rounds(eng, st, ctx["certs"], f.committee.size())
    return eng, st


def forge(cert, rng: random.Random):
    """The certificate with one vote signature's S corrupted (same header,
    so the same digest): exactly what the verify stage must reject."""
    from narwhal_tpu_torch.types import Certificate

    sigs = list(cert.signatures)
    j = rng.randrange(len(sigs))
    b = bytearray(sigs[j])
    b[40] ^= 0x10
    sigs[j] = bytes(b)
    return Certificate(cert.header, cert.signers, tuple(sigs))


def require_native_scalar(path: str):
    """The native scalar library (the verifier's precheck, challenge and
    folds in C), or a failed phase."""
    from narwhal_tpu_torch import native

    lib = native.load_scalar()
    if lib is None:
        raise AssertionError(f"{path}: the native scalar library did not build or load")
    return lib


def check_native_scalars(verifier, items, seed: int = 7) -> None:
    """On `items` (forged rows included): the native precheck bit-identical
    to the Python one (its verdicts, and the a, r, s and k rows of the items
    that pass: the only rows packed), and the native fold of the passing
    rows equal to the Python fold under one draw of weights."""
    lib = require_native_scalar("pipeline")
    t0 = time.perf_counter()
    got = verifier._precheck_native(items, lib)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = verifier._precheck_py(items)
    t_py = time.perf_counter() - t0
    if not np.array_equal(got[0], want[0]):
        raise AssertionError("pipeline: native precheck's verdicts differ from Python's")
    idx = np.flatnonzero(got[0])
    for field, a, b in zip(("a", "r", "s", "k"), got[1:], want[1:]):
        if not np.array_equal(a[idx], b[idx]):
            raise AssertionError(f"pipeline: native precheck's {field} rows differ from "
                                 "Python's")
    k_rows = np.ascontiguousarray(got[4][idx])
    s_rows = np.ascontiguousarray(got[3][idx])
    rnd = random.Random(seed).randbytes(16 * idx.size)
    fold = verifier._fold_native(lib, k_rows, s_rows, rnd)
    if not (np.array_equal(fold[0], (py := verifier._fold_py(k_rows, s_rows, rnd))[0])
            and fold[1] == py[1]):
        raise AssertionError("pipeline: native fold differs from Python's")
    log(f"pipeline: native precheck of {len(items)} items ({len(items) - idx.size} "
        f"failing) bit-identical to the Python one ({t_native * 1e3:.3f} ms against "
        f"{t_py * 1e3:.3f} ms), the native fold of {idx.size} rows equal to Python's")


def phase_pipeline(device, f, ctx, rounds=12, batch=40, bucket=BUCKET, n_forged=3):
    """The fused pipeline over a signed stream that continues the engine
    phase's DAG, so it runs on a window that slides (a node in steady
    state, not one fresh from genesis). The CPU engine of the engine phase
    continues over the accepted stream as the reference."""
    import torch
    from narwhal_tpu_torch.fixtures import make_signed_certificates
    from narwhal_tpu_torch.gpu import kernel_registry
    from narwhal_tpu_torch.gpu.pipeline import FusedCertificatePipeline
    from narwhal_tpu_torch.gpu.verifier import GpuVerifier

    require_native_scalar("pipeline")
    n = f.committee.size()
    last = ctx["certs"][-1].round
    tips = {c.digest for c in ctx["certs"] if c.round == last}
    t_sign = time.perf_counter()
    certs, _ = make_signed_certificates(f, last + 1, last + rounds, tips)
    signed = list(certs)
    rng = random.Random(5)
    forged_at = sorted(rng.sample(range(n, len(certs) - n), n_forged))
    for i in forged_at:
        certs[i] = forge(certs[i], rng)
    forged = {id(certs[i]) for i in forged_at}
    n_items = sum(len(c.signatures) for c in certs)
    log(f"pipeline: signed {len(certs)} certificates of rounds {last + 1}..{last + rounds} "
        f"({n_items} vote signatures) in {time.perf_counter() - t_sign:.1f} s (setup, untimed)")

    engine, state = ctx["eng"], ctx["state"]
    base0 = engine.win.round_base
    verifier = GpuVerifier(max_bucket=bucket, mode="item", fixed_bucket=True, device=device)
    pipe = FusedCertificatePipeline(verifier, engine, state, start_index=ctx["index"])
    batches = [certs[lo:lo + batch] for lo in range(0, len(certs), batch)]
    kernel_registry.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.run(batches)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_registry.launch_counts()

    if {id(c) for c in pipe.rejected} != forged or len(pipe.rejected) != n_forged:
        raise AssertionError(
            f"pipeline: rejected {[c.round for c in pipe.rejected]}, forged "
            f"{[certs[i].round for i in forged_at]}"
        )
    accepted = [c for c in certs if id(c) not in forged]
    ref_eng, ref_state = ctx["ref_eng"], ctx["ref_state"]
    ref_out, ri = [], ctx["index"]
    for c in accepted:
        outs = ref_eng.process_certificate(ref_state, ri, c)
        ri += len(outs)
        ref_out.extend(outs)
    if not ref_out:
        raise AssertionError("pipeline: the reference engine committed nothing")
    if [(o.certificate.digest, o.consensus_index) for o in out] != [
        (o.certificate.digest, o.consensus_index) for o in ref_out
    ]:
        raise AssertionError("pipeline: commit sequence differs from the CPU engine")
    if engine.win.round_base <= base0:
        raise AssertionError("pipeline: the window never slid")
    require_launches("pipeline", launches, device)
    check_native_scalars(verifier, [it for c in certs for it in c.verify_items(f.committee)])
    if device.type == "cuda":
        # The same run again under the profiler, on an engine brought to the
        # same state by replaying the unsigned stream (untraced).
        eng, st = replay_engine(device, f, ctx)
        spans = SpanTotals()
        traced = FusedCertificatePipeline(
            GpuVerifier(max_bucket=bucket, mode="item", fixed_bucket=True, device=device), eng, st,
            start_index=ctx["index"], tracer=spans)
        profile_run(lambda: traced.run(batches), device, "pipeline")
        log("  host stages (pipeline spans, summed over batches): " + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in sorted(spans.totals.items())))
        log(f"  with the native scalar library: device_dispatch "
            f"{spans.totals.get('device_dispatch', 0.0) * 1e3:.3f} ms, pack_items "
            f"{spans.totals.get('pack_items', 0.0) * 1e3:.3f} ms (with the Python "
            f"precheck, PERF.md section 5: 241.2 and 76.4 ms; a record, no claim)")
    log(f"pipeline: N={n}, {rounds} rounds, {len(certs)} certificates in batches of "
        f"{batch} ({batch * n} items per {bucket} bucket), {n_forged} forged -> "
        f"rejected exactly those; {len(out)} committed (== CPU engine); window base "
        f"{base0} -> {engine.win.round_base}; {wall:.3f} s wall: "
        f"{n_items / wall:.1f} signatures/s, {len(certs) / wall:.1f} certificates/s; "
        f"launches {launches}")
    return {"launches": launches, "signed": signed, "forged_at": forged_at,
            "batch": batch, "seq": [(o.certificate.digest, o.consensus_index) for o in out],
            "ref_seq": [(o.certificate.digest, o.consensus_index) for o in ref_out],
            "rates": {"signatures_per_s": n_items / wall,
                      "certificates_per_s": len(certs) / wall}}


# ---------------------------------------------------------------------------
# Phase: the compact-certificate path (the group lane) on the same rounds
# ---------------------------------------------------------------------------


def forge_aggregate(cert):
    """The compact certificate with one bit of agg_s flipped (same header,
    so the same digest): its proof fails, nothing else changes."""
    from narwhal_tpu_torch.types import Certificate

    agg = bytes([cert.agg_s[0] ^ 0x10]) + cert.agg_s[1:]
    return Certificate(cert.header, cert.signers, cert.signatures, agg)


class HostCalls:
    """Counts and times calls of one module function while installed."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.seconds: list[float] = []

    def __enter__(self):
        def wrapped(*args):
            t0 = time.perf_counter()
            try:
                return self.real(*args)
            finally:
                self.seconds.append(time.perf_counter() - t0)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def phase_compact(device, f, ctx, pctx, bucket=BUCKET):
    """FusedCertificatePipeline over the pipeline phase's rounds in compact
    form: each certificate half-aggregated from its own vote signatures
    (`compact_from_votes` without a committee, so no verdict is pre-seeded),
    the same 3 positions forged in agg_s. The strict item lane is unused:
    every proof goes through the group lane (msm_accumulate), and a forged
    one is re-checked on the host after its solo launch fails. The accepted
    stream carries the same digests as the pipeline phase's, so both its
    CPU-engine sequence and its card sequence are the reference."""
    import torch
    from narwhal_tpu_torch import types as types_mod
    from narwhal_tpu_torch.gpu import kernel_registry
    from narwhal_tpu_torch.gpu import verifier as verifier_mod
    from narwhal_tpu_torch.gpu.pipeline import FusedCertificatePipeline
    from narwhal_tpu_torch.gpu.verifier import GpuVerifier
    from narwhal_tpu_torch.types import Certificate

    require_native_scalar("compact")
    n = f.committee.size()
    t_agg = time.perf_counter()
    certs = [Certificate.compact_from_votes(c.header, c.signers, c.signatures)
             for c in pctx["signed"]]
    for i in pctx["forged_at"]:
        certs[i] = forge_aggregate(certs[i])
    forged = {id(certs[i]) for i in pctx["forged_at"]}
    log(f"compact: aggregated {len(certs)} certificates in "
        f"{time.perf_counter() - t_agg:.1f} s (setup, untimed)")
    batch = pctx["batch"]
    batches = [certs[lo:lo + batch] for lo in range(0, len(certs), batch)]

    eng, st = replay_engine(device, f, ctx)
    base0 = eng.win.round_base
    pipe = FusedCertificatePipeline(
        GpuVerifier(max_bucket=bucket, mode="item", fixed_bucket=True, device=device),
        eng, st, start_index=ctx["index"])
    kernel_registry.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize()
    with HostCalls(types_mod, "host_verify_aggregate") as host:
        t0 = time.perf_counter()
        out = pipe.run(batches)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernel_registry.launch_counts()

    if {id(c) for c in pipe.rejected} != forged or len(pipe.rejected) != len(forged):
        raise AssertionError(f"compact: rejected {[c.round for c in pipe.rejected]}")
    if len(host.seconds) != len(forged):
        raise AssertionError(f"compact: {len(host.seconds)} host re-checks, want {len(forged)}")
    seq = [(o.certificate.digest, o.consensus_index) for o in out]
    if seq != pctx["ref_seq"]:
        raise AssertionError("compact: commit sequence differs from the CPU engine")
    if seq != pctx["seq"]:
        raise AssertionError("compact: commit sequence differs from the full-format path")
    if eng.win.round_base <= base0:
        raise AssertionError("compact: the window never slid")
    require_launches("compact", launches, device)
    n_sigs = sum(len(c.signers) for c in certs)
    if device.type == "cuda":
        eng, st = replay_engine(device, f, ctx)
        spans = SpanTotals()
        traced = FusedCertificatePipeline(
            GpuVerifier(max_bucket=bucket, mode="item", fixed_bucket=True, device=device),
            eng, st, start_index=ctx["index"], tracer=spans)
        with HostCalls(verifier_mod, "msm_epilogue_check") as epi, \
                HostCalls(traced.verifier, "_dispatch_group_chunk") as packs, \
                HostCalls(types_mod, "host_verify_aggregate") as walks:
            profile_run(lambda: traced.run(batches), device, "compact")
        log("  host stages (compact spans, summed over batches): " + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in sorted(spans.totals.items())))
        for what, calls in (("msm epilogue", epi), ("group chunk pack + launch", packs),
                            ("host re-check", walks)):
            log(f"  {what}: {len(calls.seconds)} calls, {sum(calls.seconds) * 1e3:.3f} ms, "
                f"{statistics.median(calls.seconds) * 1e3:.3f} ms median")
    log(f"compact: N={n}, {len(certs)} compact certificates in batches of {batch} "
        f"({2 * n * batch} doubled rows per batch, {bucket}-row launches), "
        f"{len(forged)} forged agg_s -> rejected exactly those after {len(host.seconds)} "
        f"host re-checks ({sum(host.seconds):.3f} s); {len(out)} committed (== CPU engine "
        f"== full-format path); window base {base0} -> {eng.win.round_base}; {wall:.3f} s "
        f"wall: {n_sigs / wall:.1f} signatures/s, {len(certs) / wall:.1f} certificates/s; "
        f"launches {launches}")
    return {"launches": launches, "certs": certs,
            "rates": {"signatures_per_s": n_sigs / wall,
                      "certificates_per_s": len(certs) / wall}}


# ---------------------------------------------------------------------------
# Phase: the process-wide VerifyService, both modes
# ---------------------------------------------------------------------------


def _serve(svc, groups, items, timeout: float = 600.0):
    """Verdicts of `groups` (verify_aggregate) and `items` (verify) submitted
    together from one asyncio loop."""

    async def drive():
        g = asyncio.gather(*(svc.verify_aggregate(*x) for x in groups))
        i = asyncio.gather(*(svc.verify(*x) for x in items))
        return await asyncio.wait_for(asyncio.gather(g, i), timeout)

    t0 = time.perf_counter()
    gres, ires = asyncio.run(drive())
    return list(gres), list(ires), time.perf_counter() - t0


def phase_service(device, f, pctx, cctx, bucket=BUCKET):
    """VerifyService.shared("item") (the default strict config) serves the
    compact proofs and a burst of header signatures concurrently; then
    VerifyService.shared("msm") serves a bucket of valid vote signatures
    (the msm check alone) and one with a forged and a torsion item (the
    verify_batch fallback with the cofactored rule)."""
    import torch
    from narwhal_tpu_torch.gpu import kernel_registry
    from narwhal_tpu_torch.gpu.verifier import VerifyService

    require_native_scalar("service")
    forged_at = set(pctx["forged_at"])
    groups = [c.aggregate_group(f.committee) for c in cctx["certs"]]
    want_groups = [i not in forged_at for i in range(len(groups))]
    headers = [c.header.signature_item() for c in pctx["signed"]]
    burst = [headers[i % len(headers)] for i in range(bucket)]
    rng = random.Random(17)
    bad_headers = sorted(rng.sample(range(bucket), 4))
    for i in bad_headers:
        pk, msg, sig = burst[i]
        burst[i] = (pk, msg, sig[:40] + bytes([sig[40] ^ 0x01]) + sig[41:])
    want_burst = [i not in bad_headers for i in range(bucket)]

    votes = [it for c in pctx["signed"] for it in c.verify_items(f.committee)]
    valid_votes = votes[:bucket]
    mixed = list(votes[bucket:2 * bucket])
    pk, msg, sig = mixed[5]
    mixed[5] = (pk, msg, sig[:40] + bytes([sig[40] ^ 0x01]) + sig[41:])
    mixed[9] = _torsion_item(rng)
    want_mixed = [i != 5 for i in range(len(mixed))]

    kernel_registry.reset_launch_counts()
    item_svc = VerifyService.shared("item", device=device)
    msm_svc = VerifyService.shared("msm", device=device)
    try:
        gres, ires, wall_item = _serve(item_svc, groups, burst)
        if gres != want_groups:
            wrong = [i for i, (a, b) in enumerate(zip(gres, want_groups)) if a != b]
            raise AssertionError(f"service item: group verdicts wrong at {wrong}")
        if ires != want_burst:
            raise AssertionError("service item: header verdicts differ from the expected set")
        a1_before = kernel_registry.launch_counts()["verify_batch"]
        _g, valid_res, wall_valid = _serve(msm_svc, [], valid_votes)
        a1_after = kernel_registry.launch_counts()["verify_batch"]
        if valid_res != [True] * len(valid_votes):
            raise AssertionError("service msm: a valid vote was rejected")
        if device.type == "cuda" and a1_after != a1_before:
            raise AssertionError("service msm: the valid bucket fell back to verify_batch")
        _g, mixed_res, wall_mixed = _serve(msm_svc, [], mixed)
        if mixed_res != want_mixed:
            raise AssertionError(f"service msm: verdicts {mixed_res[:12]}...")
        if device.type == "cuda" and kernel_registry.launch_counts()["verify_batch"] <= a1_after:
            raise AssertionError("service msm: the failed bucket did not fall back")
        if device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        item_svc.shutdown()
        msm_svc.shutdown()
    for svc in (item_svc, msm_svc):
        if svc._submit_thread.is_alive() or svc._collect_thread.is_alive():
            raise AssertionError("service: a thread outlived shutdown")
    launches = kernel_registry.launch_counts()
    require_launches("service", launches, device)
    log(f"service: item mode served {len(groups)} compact proofs ({sum(want_groups)} valid) "
        f"and {bucket} header signatures ({len(bad_headers)} forged) concurrently in "
        f"{wall_item:.3f} s; msm mode: {len(valid_votes)} valid votes in {wall_valid:.3f} s "
        f"(no verify_batch launch), {len(mixed)} votes with a forged and a torsion item in "
        f"{wall_mixed:.3f} s (fallback: forged rejected, torsion accepted); both services "
        f"shut down; launches {launches}")
    return {"launches": launches,
            "rates": {"item_service_s": wall_item, "msm_valid_bucket_s": wall_valid,
                      "msm_fallback_bucket_s": wall_mixed},
            "inputs": {"groups": groups, "burst": burst, "valid_votes": valid_votes,
                       "mixed": mixed},
            "verdicts": {"groups": gres, "burst": ires, "valid_votes": valid_res,
                         "mixed": mixed_res}}


def phase_sharded(device, sctx):
    """VerifyService.shared("item" and "msm", shards=k, devices=D) on the
    service phase's inputs (the compact proofs with the header burst, the
    valid vote bucket, the bucket with a forged and a torsion item): every
    verdict must equal the unsharded services'; the path runs the staged
    kernels and the shard reduce, and never verify_batch or msm_accumulate."""
    import torch
    from narwhal_tpu_torch.gpu import kernel_registry
    from narwhal_tpu_torch.gpu.verifier import VerifyService

    # Every card present; on one card that card twice, so the split and the
    # cross-shard reduce run on it; on the CPU (a rehearsal) two CPU shards.
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    devices = ([f"cuda:{i}" for i in range(n)] if n > 1
               else ["cuda:0", "cuda:0"] if n == 1 else ["cpu", "cpu"])
    k = len(devices)
    log(f"sharded: {k} shards over {devices}"
        + (" (one device, repeated)" if len(set(devices)) < k else ""))
    inputs, want = sctx["inputs"], sctx["verdicts"]
    kernel_registry.reset_launch_counts()
    item_svc = VerifyService.shared("item", shards=k, devices=devices)
    msm_svc = VerifyService.shared("msm", shards=k, devices=devices)
    try:
        gres, ires, wall_item = _serve(item_svc, inputs["groups"], inputs["burst"])
        a4_before = kernel_registry.launch_counts()["verify_straus"]
        _g, valid_res, wall_valid = _serve(msm_svc, [], inputs["valid_votes"])
        a4_after = kernel_registry.launch_counts()["verify_straus"]
        _g, mixed_res, wall_mixed = _serve(msm_svc, [], inputs["mixed"])
    finally:
        item_svc.shutdown()
        msm_svc.shutdown()
    got = {"groups": gres, "burst": ires, "valid_votes": valid_res, "mixed": mixed_res}
    for name, verdicts in got.items():
        if verdicts != want[name]:
            wrong = [i for i, (a, b) in enumerate(zip(verdicts, want[name])) if a != b]
            raise AssertionError(f"sharded: {name} verdicts differ from the unsharded "
                                 f"service's at {wrong[:10]}")
    launches = kernel_registry.launch_counts()
    require_launches("sharded", launches, device)
    if launches["verify_batch"] or launches["msm_accumulate"]:
        raise AssertionError(f"sharded: a monolith launched ({launches})")
    if device.type == "cuda" and a4_after != a4_before:
        raise AssertionError("sharded: the valid msm bucket fell back to the item stages")
    log(f"sharded: item mode served {len(gres)} compact proofs and {len(ires)} header "
        f"signatures in {wall_item:.3f} s; msm mode {len(valid_res)} valid votes in "
        f"{wall_valid:.3f} s (no item-stage launch), {len(mixed_res)} votes with a forged "
        f"and a torsion item in {wall_mixed:.3f} s; every verdict equal to the unsharded "
        f"services'; launches {launches}")
    return {"launches": launches, "devices": devices,
            "rates": {"item_service_s": wall_item, "msm_valid_bucket_s": wall_valid,
                      "msm_fallback_bucket_s": wall_mixed}}


class SpanTotals:
    """The tracer interface FusedCertificatePipeline calls (`enabled`,
    `sampled`, `span`), summing each span's duration by name."""

    enabled = True

    def __init__(self):
        self.totals: dict[str, float] = {}

    def sampled(self, key) -> bool:
        return True

    def span(self, name, key, t0, t1, attrs=None) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + (t1 - t0)


def profile_run(fn, device, name: str) -> None:
    """One more run of `fn` under torch.profiler (the timed run above stays
    untraced): device time per kernel, and the device's busy and idle share
    of the run's wall, from the kernels' own durations. The Chrome trace is
    written to chiprun_out/chip_smoke/<name>_trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"{name}_trace.json"))
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile {name}: wall {wall_us / 1e3:.3f} ms (traced), device busy "
        f"{busy / 1e3:.3f} ms = {100 * busy / wall_us:.2f} % of wall, idle "
        f"{100 * (1 - busy / wall_us):.2f} %")
    for dev_us, count, key in rows[:12]:
        log(f"  {dev_us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")
    cpu = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    for evt in cpu[:8]:
        log(f"  host {evt.self_cpu_time_total / 1e3:10.3f} ms  x{evt.count:<6d} {evt.key[:80]}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    from narwhal_tpu_torch.fixtures import CommitteeFixture
    from narwhal_tpu_torch.gpu import kernel_registry, resolve_device

    device = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    log(card)

    phase_build()
    f = CommitteeFixture(size=N)
    kernels = phase_kernels(device, f)
    ctx = phase_engine(device, f)
    dsctx = phase_dag_shards(device, f, ctx)  # before the pipeline moves ctx's states on
    pctx = phase_pipeline(device, f, ctx)
    cctx = phase_compact(device, f, ctx, pctx)
    sctx = phase_service(device, f, pctx, cctx)
    shctx = phase_sharded(device, sctx)
    tctx = phase_tusk(device, f)
    rctx = phase_runner(device, f, ctx)
    dctx = phase_dag_service(device, f)
    csctx = phase_consensus_step(device, f)
    drctx = phase_dryrun(device)
    by_path = {"engine": ctx["launches"], "pipeline": pctx["launches"],
               "compact": cctx["launches"], "service": sctx["launches"],
               "sharded": shctx["launches"],
               "tusk": tctx["launches"], "runner": rctx["launches"],
               "dag_service": dctx["launches"],
               "dag_shards": dsctx["launches"], "consensus_step": csctx["launches"],
               "dryrun": drctx["launches"]}
    rates = {"engine_certificates_per_s": ctx["certificates_per_s"],
             "pipeline": pctx["rates"], "compact": cctx["rates"],
             "service": sctx["rates"],
             "sharded": {"devices": shctx["devices"], **shctx["rates"]},
             "tusk_certificates_per_s": tctx["certificates_per_s"],
             "runner": {"runs": rctx["results"], "commit_stage_ms": rctx["commit"],
                        "storage_groups": rctx["storage_groups"]},
             "dag_service": {"per_k": dctx["per_k"], "wall_s": dctx["wall_s"],
                             "adaptive_routing": dctx["routing_adaptive"]},
             "dag_shards": {"devices": dsctx["devices"], "route": dsctx["route"],
                            "commit_events": dsctx["commit_events"],
                            "certificates_per_s": dsctx["certificates_per_s"],
                            "forced_host": dsctx.get("forced_host")},
             "consensus_step": {"unmeshed_s": csctx["unmeshed_s"],
                                "meshed_s": csctx["meshed_s"], "route": csctx["route"],
                                "meshed_s_by_route": csctx["meshed_s_by_route"]},
             "dryrun_wall_s": drctx["wall_s"]}

    kernels["window_sync"]["extra"]["views_by_path"] = PATH_SYNCS
    rows = []
    build_walls = kernel_registry.build_walls()
    for kname, (stem, replaces) in kernel_registry.KERNELS.items():
        r = kernels[kname]
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": f"narwhal_tpu_torch/gpu/csrc/{stem}.cu",
            "replaces": replaces.split(" ")[0],
            "launches": sum(path[kname] for path in by_path.values()),
            "launches_by_path": {p: c[kname] for p, c in by_path.items()},
            "forced_route_launches": {r: c[kname]
                                      for r, c in csctx["forced_launches"].items()},
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": r["shape"],
            "build_s": build_walls.get(kname),
            **r.get("extra", {}),
        })
    print(json.dumps({"kernels": rows, "card": card, "rates": rates}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
