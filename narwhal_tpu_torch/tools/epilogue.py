"""Device-plane epilogue attributor for the PyTorch port: where the host
work around a device batch goes.

Port copy of the repo's `tools/perf/epilogue.py`: `attribute` and
`render_table` are the JAX package's, extended by the port's verdict
epilogue. The port's `gpu/pipeline.py` records one span tree per sampled
batch, keyed by the batch's first certificate digest:

  device_pack            host pack: verify_items/aggregate_group staging
    pack_items             - full-format per-vote signature item staging
    pack_groups            - compact-format aggregate-group decompress
  device_dispatch        async submit of the verify kernels
  device_mask_readback   blocking device->host verdict copies
  item_epilogue          the item lane's verdicts: the msm epilogue check
                         and a failed bucket's fallback
  group_epilogue         the group lane's msm epilogue, solo bisect and
                         host re-checks
  host_epilogue          everything after the verdicts are in
    epilogue_unpack        - verdict unpack + accept/reject routing
    epilogue_commit        - engine.process_batch: DAG insert + commit walk

The JAX package's pipeline has no item_epilogue or group_epilogue spans,
so its attributor's books cover host_epilogue alone.

`attribute(dumps)` folds the flight-recorder dumps into per-batch rows
and checks two sets of books:

- the epilogue's: the epilogue sub-spans must sum to within 10% of the
  measured host_epilogue span (the JAX package's acceptance gate), with
  the remainder reported as `epilogue_unattributed_s`. In both pipelines
  the two sub-spans share host_epilogue's endpoints, so this error is 0
  unless a stage is recorded without them;
- the resolve's: readback, the two verdict spans and host_epilogue must
  sum to within 10% of the window from the readback's start to
  host_epilogue's end (`resolve_rel_err`), so host work added to a
  batch's resolve without a span of its own shows up as drift here.

`host_after_readback_share` is the host's share of a batch's timeline
after its readback: the verdict epilogue and host_epilogue together.

It reads dumps only, so it needs no card:

    python -m narwhal_tpu_torch.tools.epilogue DUMP.json [DUMP.json ...]

reads flight dumps (`tracing.Tracer.dump()` output, one dump or a list of
dumps a file, as the Telemetry flight-dump RPC returns them) and prints the
table and the totals. `chip_smoke.py`'s `profile` path runs it over a
traced `FusedCertificatePipeline` on the card.
"""

from __future__ import annotations

# The epilogue constituents: sub-spans recorded INSIDE host_epilogue.
EPILOGUE_PARTS = ("epilogue_unpack", "epilogue_commit")
# The pack constituents: sub-spans recorded inside device_pack.
PACK_PARTS = ("pack_items", "pack_groups")
# The verdict epilogue: each lane's host work after its readback lands,
# recorded between device_mask_readback and host_epilogue (the port's own).
VERDICT_PARTS = ("item_epilogue", "group_epilogue")
STAGES = (
    "device_pack",
    "device_dispatch",
    "device_mask_readback",
    "host_epilogue",
) + EPILOGUE_PARTS + PACK_PARTS + VERDICT_PARTS
# The spans that tile a batch's resolve, from the readback to the commit.
RESOLVE_PARTS = ("device_mask_readback",) + VERDICT_PARTS + ("host_epilogue",)


def _rel_err(parts: float, whole: float) -> float:
    return round(abs(parts - whole) / whole, 4) if whole > 0 else 0.0


def attribute(dumps: list[dict]) -> dict:
    """Fold flight dumps into the per-batch epilogue breakdown.

    Returns {"batches": [row...], "totals": {...}} where each row carries
    the batch key, n (certificates in the batch), every stage width, the
    epilogue sub-span sum and its relative error vs the measured
    host_epilogue span, and the verdict epilogue, the resolve window and
    the resolve spans' relative error vs that window.
    """
    # key -> stage -> [width_s, ...] (a key can only host one batch, but
    # stay defensive: sum repeated spans).
    per_key: dict[str, dict[str, float]] = {}
    n_by_key: dict[str, int] = {}
    # key -> [readback start, host_epilogue end]: the resolve's window.
    window: dict[str, list] = {}
    for dump in dumps:
        for event in dump.get("events", ()):
            if not event or event[0] != "span":
                continue
            _, stage, key, t0, t1 = event[:5]
            if stage not in STAGES:
                continue
            attrs = event[5] if len(event) > 5 and isinstance(event[5], dict) else {}
            row = per_key.setdefault(key, {})
            row[stage] = row.get(stage, 0.0) + (t1 - t0)
            if "n" in attrs:
                n_by_key[key] = attrs["n"]
            ends = window.setdefault(key, [None, None])
            if stage == "device_mask_readback":
                ends[0] = t0 if ends[0] is None else min(ends[0], t0)
            elif stage == "host_epilogue":
                ends[1] = t1 if ends[1] is None else max(ends[1], t1)

    def resolve(key: str) -> float:
        t0, t1 = window.get(key, (None, None))
        return t1 - t0 if t0 is not None and t1 is not None else 0.0

    def resolve_parts(key: str) -> float:
        return sum(per_key[key].get(p, 0.0) for p in RESOLVE_PARTS) if resolve(key) else 0.0

    batches = []
    for key, stages in sorted(per_key.items()):
        epilogue = stages.get("host_epilogue", 0.0)
        parts = {p: stages.get(p, 0.0) for p in EPILOGUE_PARTS}
        part_sum = sum(parts.values())
        row = {
            "batch_key": key,
            "n": n_by_key.get(key, 0),
            **{s: round(stages.get(s, 0.0), 6) for s in STAGES if s in stages},
            "epilogue_parts_s": round(part_sum, 6),
            "epilogue_unattributed_s": round(epilogue - part_sum, 6),
            "epilogue_rel_err": _rel_err(part_sum, epilogue),
            "verdict_epilogue_s": round(sum(stages.get(p, 0.0) for p in VERDICT_PARTS), 6),
            "resolve_s": round(resolve(key), 6),
            "resolve_rel_err": _rel_err(resolve_parts(key), resolve(key)),
        }
        batches.append(row)

    def total(stage: str) -> float:
        return sum(per_key[k].get(stage, 0.0) for k in per_key)

    epilogue_total = total("host_epilogue")
    parts_total = sum(total(p) for p in EPILOGUE_PARTS)
    verdict_total = sum(total(p) for p in VERDICT_PARTS)
    device_total = total("device_pack") + total("device_dispatch") + total("device_mask_readback")
    resolve_total = sum(resolve(k) for k in per_key)
    totals = {
        "batches": len(batches),
        **{s: round(total(s), 6) for s in STAGES},
        "epilogue_parts_s": round(parts_total, 6),
        "epilogue_rel_err": _rel_err(parts_total, epilogue_total),
        "epilogue_share_of_batch": round(
            epilogue_total / max(1e-12, device_total + epilogue_total), 4
        ),
        "verdict_epilogue_s": round(verdict_total, 6),
        "resolve_s": round(resolve_total, 6),
        "resolve_rel_err": _rel_err(sum(resolve_parts(k) for k in per_key), resolve_total),
        "host_after_readback_share": round(
            (verdict_total + epilogue_total)
            / max(1e-12, device_total + verdict_total + epilogue_total),
            4,
        ),
    }
    return {"batches": batches, "totals": totals}


def render_table(report: dict) -> str:
    """The JAX package's table, each line extended by the port's verdict
    epilogue and resolve books."""
    totals = report["totals"]
    lines = [
        f"device epilogue attribution — {totals['batches']} batch(es), "
        f"epilogue {totals.get('host_epilogue', 0.0):.4f}s "
        f"({totals['epilogue_share_of_batch']:.0%} of the device-plane "
        f"timeline), sub-span books balance to "
        f"{totals['epilogue_rel_err']:.1%}; verdict epilogue "
        f"{totals['verdict_epilogue_s']:.4f}s, host after the readback "
        f"{totals['host_after_readback_share']:.0%} of the timeline, resolve "
        f"books balance to {totals['resolve_rel_err']:.1%}",
        f"{'batch':<18} {'n':>4} {'pack':>9} {'dispatch':>9} "
        f"{'readback':>9} {'epilogue':>9} {'unpack':>9} {'commit':>9} {'err':>6} "
        f"{'verdict':>9} {'resolve':>9} {'err':>6}",
    ]
    for row in report["batches"]:
        lines.append(
            f"{row['batch_key'][:16]:<18} {row['n']:>4} "
            f"{row.get('device_pack', 0.0):>9.4f} "
            f"{row.get('device_dispatch', 0.0):>9.4f} "
            f"{row.get('device_mask_readback', 0.0):>9.4f} "
            f"{row.get('host_epilogue', 0.0):>9.4f} "
            f"{row.get('epilogue_unpack', 0.0):>9.4f} "
            f"{row.get('epilogue_commit', 0.0):>9.4f} "
            f"{row['epilogue_rel_err']:>6.1%} "
            f"{row['verdict_epilogue_s']:>9.4f} "
            f"{row['resolve_s']:>9.4f} "
            f"{row['resolve_rel_err']:>6.1%}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dumps", nargs="+", help="flight dump JSON files")
    args = parser.parse_args(argv)
    dumps: list[dict] = []
    for path in args.dumps:
        with open(path) as fh:
            loaded = json.load(fh)
        dumps.extend(loaded if isinstance(loaded, list) else [loaded])
    report = attribute(dumps)
    print(render_table(report))
    print(json.dumps(report["totals"], sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
