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
            buckets; chain_commit on a healed partition where the gc filter
            provably bites; msm_accumulate in the group-lane shape, 20
            compact proofs of 50 signers as 2000 doubled rows plus 48 zero
            rows, and in the item shape with real R and z digits, a torsion
            row and an invalid encoding; reach_many at K = 64 with padding
            slots, W = 64 and 128; the staged kernels of the sharded
            verifier at B = 2048: verify_decompress on the item bucket's A
            and R sets, verify_straus and verify_verdict on its output,
            msm_window on the msm item and group buckets' A (64 lanes) and
            R (32 lanes) sets, msm_shard_reduce over 2 and 4 shards), with
            kernel / plain / library times from CUDA events (median of
            repeats). Verdicts, masks and validity bit-equal;
            verify_decompress's coordinates equal mod p; msm_accumulate's,
            msm_window's and the reduce's window lanes and verify_straus's
            accumulators equal as affine points (canonical x and y), and
            the epilogue verdicts. The compositions against the monoliths:
            decompress -> straus -> verdict bit-equal to verify_batch,
            decompress -> msm_window (A, R) equal to msm_accumulate (lanes
            as points, validity bit-equal), the reduced shards equal to its
            V_a;
  engine    GpuBullshark.process_batch_async on the card over a lossy
            unsigned N = 50 DAG of 200 rounds, built so the window both
            slides and grows and chains of up to 4 leaders commit at once;
            the commit sequence must equal the same engine's on the CPU
            and the port's host Bullshark's;
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
            router's verdict.
Launch counts are set to 0 just before each of the seven paths and read
just after it, and each path must have launched the kernels it names
(PATH_KERNELS). Then one JSON line with every kernel's numbers (launches
summed over the paths and per path), and as the last line
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
    "engine": ("place_batch", "roll_window", "chain_commit"),
    "pipeline": ("verify_batch", "place_batch", "roll_window", "chain_commit"),
    "compact": ("msm_accumulate", "place_batch", "roll_window", "chain_commit"),
    "service": ("verify_batch", "msm_accumulate"),
    "tusk": ("place_batch", "roll_window", "chain_commit"),
    "dag_service": ("reach_many", "place_batch", "roll_window"),
    "sharded": ("verify_decompress", "verify_straus", "verify_verdict", "msm_window",
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


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def require_launches(path: str, launches: dict, device) -> None:
    """Fail unless every kernel the path names launched on it (on the card;
    a CPU rehearsal launches nothing)."""
    for k in PATH_KERNELS[path]:
        if device.type == "cuda" and launches[k] <= 0:
            raise AssertionError(f"{path}: {k} never launched")


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
        if shape == "group":
            row = {"name": "msm_accumulate", "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b, "bound_by": by, "library_ms": None,
                   "shape": f"B={bucket} group lane ({group_rows} doubled rows of "
                            f"{group_rows // (2 * f.committee.size())} proofs, N="
                            f"{f.committee.size()})",
                   "rows_per_s_kernel": bucket / ms * 1e3}
        else:
            row["extra"] = {"ms_item_shape": ms, "plain_ms_item_shape": plain_ms,
                            "bound_ms_item_shape": b}
    row["max_abs_err"] = err
    return row


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


def check_staged(device, f, bucket: int, n_keys: int, plain_reps: int):
    """A3-A6 and the shard reduce against their plain versions on the same
    card tensors at B = `bucket`, and the compositions against the
    monoliths: A3 -> A4 -> A5 against A1 on the item bucket of
    `signature_bucket` (its forged, torsion, zero and random-limb rows), A3
    -> A6 (A and R sets) against A2 on the msm item and group buckets (the
    group lane's R set all zero), the reduce over k = 2 and 4 shards of the
    item bucket's A set. Validity and verdicts bit-equal, A3's coordinates
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

    t = msm_t["item"]
    pa, _ = ed25519.verify_decompress(t[0], t[1])
    whole = ed25519.msm_accumulate(*t)[0]
    for k in (2, 4):
        n = bucket // k
        lanes = torch.stack([
            ed25519.msm_window(pa[..., i * n:(i + 1) * n].contiguous(), t[4][i * n:(i + 1) * n])
            for i in range(k)])
        got = ed25519.msm_shard_reduce(lanes)
        err = _same_points(f"msm_shard_reduce k={k}", got, ed25519.msm_shard_reduce_plain(lanes))
        errs["msm_shard_reduce"] = max(errs["msm_shard_reduce"], err)
        _same_points(f"msm_shard_reduce k={k} against msm_accumulate V_a", got, whole)
        if k == 2:
            lanes2 = lanes
    log(f"msm_shard_reduce: k in (2, 4) shards of the item bucket's A set: equal to plain "
        f"as affine points, and to msm_accumulate's V_a")
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
        lambda: ed25519.msm_shard_reduce(lanes2),
        lambda: ed25519.msm_shard_reduce_plain(lanes2),
        (2 - 1) * 64 * 9 * 100, 3 * 4 * 20 * 64 * 4, "k=2 lane sets of 64 lanes"),
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
    pr, _ = ed25519.verify_decompress(t[2], t[3])
    rows[3]["extra"] = {
        "ms_r_lanes": time_ms(lambda: ed25519.msm_window(pr, t[5]), device, reps=5),
        "bound_ms_r_lanes": bound_ms(pts_bytes + bucket * 32 + 4 * 20 * 32 * 4,
                                     ed25519.msm_window_ops(r_live, 32, bucket) * 100)[0],
    }
    # The staged item path on one card beside A1 (both on the same bucket).
    def staged_item():
        ap, av = ed25519.verify_decompress(a_y, a_sign)
        rp, rv = ed25519.verify_decompress(r_y, r_sign)
        return ed25519.verify_verdict(ed25519.verify_straus(ap, kd, sd), rp, r_y, r_sign, av, rv)

    rows[0]["extra"] = {"staged_item_ms": time_ms(staged_item, device, reps=5),
                        "verify_batch_ms": time_ms(lambda: ed25519.verify_batch(*item_t),
                                                   device, reps=5)}
    log(f"  staged item path (A3 x2, A4, A5) {rows[0]['extra']['staged_item_ms']:.4f} ms "
        f"beside verify_batch {rows[0]['extra']['verify_batch_ms']:.4f} ms at B={bucket}")
    return rows


def _random_window(rng: np.random.Generator, w: int, n: int):
    parent = (rng.random((w, n, n)) < 0.7).astype(np.uint8)
    present = (rng.random((w, n)) < 0.9).astype(np.uint8)
    return parent, present


def check_place_batch(device, n: int, w: int):
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
        kp, kq = dk.place_batch(t["parent"].clone(), t["present"].clone(), t["offs"],
                                t["idxs"], t["rows"], t["valid"])
        pp, pq = dk.place_batch_plain(t["parent"].clone(), t["present"].clone(),
                                      t["offs"], t["idxs"], t["rows"], t["valid"])
        err = max(err, int((kp.int() - pp.int()).abs().max()),
                  int((kq.int() - pq.int()).abs().max()))
        if not (torch.equal(kp, pp) and torch.equal(kq, pq)):
            raise AssertionError(f"place_batch T={T}: kernel != plain")
        if T != 64:
            continue
        wp, wq = t["parent"].clone(), t["present"].clone()
        ms = time_ms(lambda: dk.place_batch(wp, wq, t["offs"], t["idxs"], t["rows"],
                                            t["valid"]), device, reps=50)
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
        # valid[T] read; offs, idxs and the row of each live slot read; each
        # distinct (off, idx) cell written once (row and present byte).
        n_distinct = len(set(zip(offs[:n_live].tolist(), idxs[:n_live].tolist())))
        nbytes = T + n_live * (4 + 4 + n) + n_distinct * (n + 1)
        b, by = bound_ms(nbytes)
        out = {"name": "place_batch", "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b, "bound_by": by, "library_ms": library_ms,
               "shape": f"W={w} N={n} T={T} ({n_live} valid, 4 duplicates)"}
    out["max_abs_err"] = err
    log("place_batch: T in (64, 1), duplicates + padding: kernel == plain")
    return out


def check_roll_window(device, n: int, w: int):
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
    log(f"roll_window: shifts (0, 1, {w - 1}, {w}, {w + 5}): kernel == plain")
    shift = 1
    ms = time_ms(lambda: dk.roll_window(tp, tq, shift), device, reps=50)
    plain_ms = time_ms(lambda: dk.roll_window_plain(tp, tq, shift), device, reps=50)

    def library():
        a = torch.roll(tp, -shift, 0)
        a[w - shift:] = 0
        b = torch.roll(tq, -shift, 0)
        b[w - shift:] = 0

    library_ms = time_ms(library, device, reps=50)
    row = n * n + n
    b, by = bound_ms((w - shift) * row + w * row)
    return {"name": "roll_window", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms,
            "shape": f"W={w} N={n} shift={shift}"}


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
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    rng = np.random.default_rng(13)
    out, err = None, 0
    for K, live in ((1, 1), (2, 2), (4, 3)):
        parent, present, lc, lcr, offs, onehots = healed_partition_chain(
            rng, w, n, gc_depth, K, live)
        t = [torch.from_numpy(a).to(device) for a in (parent, present, lc, offs, onehots)]
        km = dk.chain_commit(t[0], t[1], gc_depth, t[2], lcr, t[3], t[4])
        pm = dk.chain_commit_plain(t[0], t[1], gc_depth, t[2], lcr, t[3], t[4])
        err = max(err, int((km.int() - pm.int()).abs().max()))
        if not torch.equal(km, pm):
            raise AssertionError(f"chain_commit K={K}: kernel != plain")
        if int(km.sum()) == 0:
            raise AssertionError(f"chain_commit K={K}: empty commit masks")
        hp, hq, hlc, ho, hh = (torch.from_numpy(a) for a in (parent, present, lc, offs, onehots))
        counts, masks = gc_filter_effects(hp, hq, gc_depth, hlc, lcr, ho, hh)
        if not torch.equal(masks, pm.cpu()):
            raise AssertionError(f"chain_commit K={K}: the filter walk != plain")
        need = ("dropped", "by_own_round") + (("by_advanced_lcr",) if live > 1 else ())
        if any(counts[c] == 0 for c in need):
            raise AssertionError(f"chain_commit K={K}: the gc filter does not bite: {counts}")
        log(f"chain_commit K={K} ({live} leaders): gc filter drops {counts['dropped']}, "
            f"{counts['by_advanced_lcr']} of them by the advanced lcr; the own-round "
            f"rule would drop {counts['by_own_round']} more")
        if K != 1:
            continue
        args = (t[0], t[1], gc_depth, t[2], lcr, t[3], t[4])
        ms = time_ms(lambda: dk.chain_commit(*args), device, reps=50)
        plain_ms = time_ms(lambda: dk.chain_commit_plain(*args), device, reps=3)
        # Rows above the newest leader are never read: parent rows
        # 1..max(offs), present rows 0..max(offs), lc, offs, one-hots in;
        # the K masks out.
        top = int(offs.max())
        nbytes = top * n * n + (top + 1) * n + 4 * n + 4 * K + K * n + K * w * n
        b, by = bound_ms(nbytes)
        out = {"name": "chain_commit", "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b, "bound_by": by, "library_ms": None,
               "shape": f"W={w} N={n} K={K} leader row {top}"}
    out["max_abs_err"] = err
    log("chain_commit: K in (1, 2, 4 with a padded slot), healed partition: kernel == plain")
    return out


def reach_many_inputs(rng: np.random.Generator, w: int, n: int, k_slots: int, live: int):
    """Inputs of one coalesced read dispatch, as numpy arrays: a sparse
    random window (two parent links a certificate on average, 4 % at
    N = 50, so walks branch and die out instead of saturating),
    `uncommitted` (the service passes `present`) at 90 %, and
    `live` distinct random starts over rows 0..w-1 (one at the top row),
    each present and linking at least one parent, then `k_slots - live`
    padding slots (offset 0, zero one-hot)."""
    parent = (rng.random((w, n, n)) < 2.0 / n).astype(np.uint8)
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


def reach_many_bytes(w: int, n: int, offs) -> int:
    """B6's least traffic: parent rows 1..max(offs) and uncommitted rows
    0..max(offs) read once, offs and the one-hots read, the K masks
    written."""
    k = len(offs)
    top = int(np.max(offs))
    return top * n * n + (top + 1) * n + 4 * k + k * n + k * w * n


def check_reach_many(device, n: int, w: int):
    import torch
    from narwhal_tpu_torch.gpu import dag_kernels as dk

    rng = np.random.default_rng(14)
    out, err = None, 0
    for ww, K, live in ((w, 64, 56), (2 * w, 64, 61), (w, 1, 1)):
        host = reach_many_inputs(rng, ww, n, K, live)
        t = [torch.from_numpy(a).to(device) for a in host]
        km = dk.reach_many(*t)
        pm = dk.reach_many_plain(*t)
        err = max(err, int((km.int() - pm.int()).abs().max()))
        if not torch.equal(km, pm):
            raise AssertionError(f"reach_many W={ww} K={K}: kernel != plain")
        hits = pm.flatten(1).sum(1)
        if int(hits[live:].sum()) != 0 or int((hits[:live] > 1).sum()) < live // 2:
            raise AssertionError(f"reach_many W={ww} K={K}: walks {hits.tolist()}")
        log(f"reach_many W={ww} N={n} K={K} ({live} starts, {K - live} padding): "
            f"kernel == plain, {int(hits.sum())} certificates reached, padding rows empty")
        if (ww, K) != (w, 64):
            continue
        ms = time_ms(lambda: dk.reach_many(*t), device, reps=50)
        plain_ms = time_ms(lambda: dk.reach_many_plain(*t), device, reps=1, groups=3)
        b, by = bound_ms(reach_many_bytes(ww, n, host[2]))
        out = {"name": "reach_many", "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b, "bound_by": by, "library_ms": None,
               "shape": f"W={ww} N={n} K={K} ({live} starts, top row {int(host[2].max())})"}
    out["max_abs_err"] = err
    return out


def phase_kernels(device, f, w=W, bucket=BUCKET, n_keys=300, n_ref=300, plain_reps=3):
    n = f.committee.size()
    rows = [
        check_verify_batch(device, bucket, n_keys, n_ref, plain_reps),
        check_msm_accumulate(device, f, bucket, n_keys, plain_reps),
        *check_staged(device, f, bucket, n_keys, plain_reps),
        check_place_batch(device, n, w),
        check_roll_window(device, n, w),
        check_chain_commit(device, n, w),
        check_reach_many(device, n, w),
    ]
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {r['name']:13s} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")
    return {r["name"]: r for r in rows}


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


def host_sequence(engine_cls, f, certs, gc=GC_DEPTH):
    """(digest, consensus_index) of every commit of the port's host engine
    (`consensus.Bullshark` or `consensus.Tusk`, the pure-Python commit
    rules) over `certs`, one certificate at a time."""
    from narwhal_tpu_torch.consensus import ConsensusState
    from narwhal_tpu_torch.stores import NodeStorage
    from narwhal_tpu_torch.types import Certificate

    state = ConsensusState(Certificate.genesis(f.committee))
    eng = engine_cls(f.committee, NodeStorage(None).consensus_store, gc)
    seq, i = [], 0
    for c in certs:
        outs = eng.process_certificate(state, i, c)
        i += len(outs)
        seq.extend((o.certificate.digest, o.consensus_index) for o in outs)
    return seq


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


def engine_path(path, device, f, engine_cls, host_cls, certs, gc, ref_out, ref_state):
    """Drive `engine_cls` (GpuBullshark or GpuTusk) on `device` over
    `certs`, one round per process_batch_async call, with the launch counts
    set to 0 just before and read just after. Its commit sequence must
    equal the CPU engine's (`ref_out`, `ref_state`) and the host engine's
    (`host_cls`); the window must grow and slide, and a chain of 3+ leaders
    commit in one event. Returns the engine, its state and outputs, the
    launch counts and the certificates per second."""
    import torch
    from narwhal_tpu_torch.consensus import ConsensusState
    from narwhal_tpu_torch.gpu import kernel_registry
    from narwhal_tpu_torch.stores import NodeStorage
    from narwhal_tpu_torch.types import Certificate

    n = f.committee.size()
    state = ConsensusState(Certificate.genesis(f.committee))
    eng = engine_cls(f.committee, NodeStorage(None).consensus_store, gc, device=device)
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
        raise AssertionError(f"{path}: commit sequence differs from the CPU engine")
    if seq != host_sequence(host_cls, f, certs, gc):
        raise AssertionError(f"{path}: commit sequence differs from the host {host_cls.__name__}")
    if state.last_committed != ref_state.last_committed:
        raise AssertionError(f"{path}: last_committed differs from the CPU engine")
    if max_w <= w0 or eng.win.round_base == 0:
        raise AssertionError(f"{path}: the window must grow and slide (W {max_w}, "
                             f"base {eng.win.round_base})")
    if max(chains) < 3:
        raise AssertionError(f"{path}: no chain of 3+ leaders (max K {max(chains)})")
    require_launches(path, launches, device)
    log(f"{path}: N={n}, {certs[-1].round} rounds, {len(certs)} certificates, {len(out)} "
        f"committed (== CPU engine == host {host_cls.__name__}), window grew to W={max_w} "
        f"and slid to base {eng.win.round_base}; {len(chains)} commit events, chain "
        f"lengths {sorted(set(chains))}; {wall:.3f} s host wall, {len(certs) / wall:.1f} "
        f"certificates/s; launches {launches}")
    return eng, state, out, launches, len(certs) / wall


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
    eng, state, out, launches, rate = engine_path(
        "engine", device, f, GpuBullshark, Bullshark, certs, gc, ref_out, ref_state)
    return {"certs": certs, "eng": eng, "state": state, "index": len(out),
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
    _eng, _state, _out, launches, rate = engine_path(
        "tusk", device, f, GpuTusk, Tusk, certs, gc, ref_out, ref_state)
    return {"launches": launches, "certificates_per_s": rate}


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
    pctx = phase_pipeline(device, f, ctx)
    cctx = phase_compact(device, f, ctx, pctx)
    sctx = phase_service(device, f, pctx, cctx)
    shctx = phase_sharded(device, sctx)
    tctx = phase_tusk(device, f)
    dctx = phase_dag_service(device, f)
    by_path = {"engine": ctx["launches"], "pipeline": pctx["launches"],
               "compact": cctx["launches"], "service": sctx["launches"],
               "sharded": shctx["launches"],
               "tusk": tctx["launches"], "dag_service": dctx["launches"]}
    rates = {"engine_certificates_per_s": ctx["certificates_per_s"],
             "pipeline": pctx["rates"], "compact": cctx["rates"],
             "service": sctx["rates"],
             "sharded": {"devices": shctx["devices"], **shctx["rates"]},
             "tusk_certificates_per_s": tctx["certificates_per_s"],
             "dag_service": {"per_k": dctx["per_k"], "wall_s": dctx["wall_s"],
                             "adaptive_routing": dctx["routing_adaptive"]}}

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
