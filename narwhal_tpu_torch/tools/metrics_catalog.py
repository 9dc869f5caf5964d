"""Metrics catalog extractor for the PyTorch port: the checked-in contract
for the port's scrape surface.

Port copy of the repo's `tools/metrics_catalog.py`. Constructs one port
PrimaryNode and one WorkerNode from the deterministic CommitteeFixture
WITHOUT spawning them: every metric is registered at assembly time
(constructors create channels, role metrics objects, and the backpressure
gauge), so construction alone materialises the full per-role registry. The
extracted {name, type, labels, help} rows are diffed against this
directory's metrics_catalog.json by tests/test_torch_tools.py, which also
holds it to the JAX package's `tools/metrics_catalog.json` row for row.

`extract_catalog()` assembles on the host backends (`cpu`, passed
explicitly: the port node's defaults are the card's); `extract_catalog(
crypto_backend="cuda", dag_backend="cuda")` assembles the card's node
(`device=None` the card, raising without one; `device="cpu"` the plain
versions), whose surface must be the same.

Check, or regenerate after an intentional change:

    python -m narwhal_tpu_torch.tools.metrics_catalog [--write]
"""

from __future__ import annotations

import json
import os

CATALOG_PATH = os.path.join(os.path.dirname(__file__), "metrics_catalog.json")

# Span stages are catalog rows too: the flight-recorder stage vocabulary
# is a scrape-surface contract exactly like metric names — waterfall
# stitching, the stage-percentile tables, and the perf attributors
# (tools/epilogue.py) all key on these strings, so a renamed or
# drive-by stage must show up in review as catalog drift. Rows are
# `span:<stage>` with type "span_stage"; `roles` names the recording
# component.
SPAN_STAGES: tuple[tuple[str, str, str], ...] = (
    ("seal", "worker", "batch sealed by a worker's BatchMaker"),
    ("propose", "primary", "header proposed for the batch digests"),
    ("certify", "primary", "votes aggregated into a certificate"),
    ("commit", "consensus", "certificate committed by the commit rule"),
    ("execute", "executor", "committed payload applied to execution state"),
    ("device_pack", "device", "host staging of one verify batch "
     "(verify_items / aggregate_group)"),
    ("pack_items", "device", "device_pack sub-span: full-format per-vote "
     "signature item staging"),
    ("pack_groups", "device", "device_pack sub-span: compact-format "
     "aggregate-group decompress staging"),
    ("device_dispatch", "device", "async submit of the verify kernels"),
    ("device_mask_readback", "device", "blocking device->host verdict copies"),
    ("host_epilogue", "device", "post-readback host work for one batch"),
    ("epilogue_unpack", "device", "host_epilogue sub-span: verdict unpack "
     "+ accept/reject routing"),
    ("epilogue_commit", "device", "host_epilogue sub-span: process_batch "
     "DAG insert + commit walk + output bookkeeping"),
)


def span_stage_rows() -> list[dict]:
    return [
        {
            "name": f"span:{stage}",
            "type": "span_stage",
            "labels": [],
            "help": help_,
            "roles": [role],
        }
        for stage, role, help_ in SPAN_STAGES
    ]


def extract_catalog(
    crypto_backend: str = "cpu", dag_backend: str = "cpu", device=None
) -> list[dict]:
    """Build both role registries and return sorted catalog rows. The
    backends and device go to the PrimaryNode: registration is identical
    across backends (backends change metric VALUES, never the surface)."""
    # full cert format keeps the host assembly free of the async verifier
    # pool: the cpu backend verifies inline.
    from narwhal_tpu_torch.config import Parameters
    from narwhal_tpu_torch.fixtures import CommitteeFixture
    from narwhal_tpu_torch.node import PrimaryNode, WorkerNode
    from narwhal_tpu_torch.stores import NodeStorage

    fixture = CommitteeFixture(size=4, workers=1, seed=0)
    parameters = Parameters()
    parameters.cert_format = "full"
    auth = fixture.authority(0)

    primary = PrimaryNode(
        auth.keypair,
        fixture.committee,
        fixture.worker_cache,
        parameters,
        NodeStorage(None),
        network_keypair=auth.network_keypair,
        crypto_backend=crypto_backend,
        dag_backend=dag_backend,
        device=device,
    )
    worker = WorkerNode(
        auth.public,
        0,
        fixture.committee,
        fixture.worker_cache,
        parameters,
        NodeStorage(None),
        network_keypair=auth.worker_keypairs[0],
    )

    rows: dict[str, dict] = {}
    for role, registry in (("primary", primary.registry), ("worker", worker.registry)):
        for name, metric in registry._metrics.items():
            row = rows.get(name)
            if row is None:
                rows[name] = {
                    "name": name,
                    "type": metric.kind,
                    "labels": list(metric.label_names),
                    "help": metric.help,
                    "roles": [role],
                }
            elif role not in row["roles"]:
                row["roles"].append(role)
    primary.storage.close()
    worker.storage.close()
    return sorted(
        list(rows.values()) + span_stage_rows(), key=lambda r: r["name"]
    )


def load_catalog() -> list[dict]:
    with open(CATALOG_PATH) as f:
        return json.load(f)


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--write", action="store_true",
        help="regenerate this directory's metrics_catalog.json from the live registries",
    )
    args = parser.parse_args()
    catalog = extract_catalog()
    if args.write:
        with open(CATALOG_PATH, "w") as f:
            json.dump(catalog, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {len(catalog)} metrics to {CATALOG_PATH}")
        return 0
    checked = {r["name"]: r for r in load_catalog()}
    live = {r["name"]: r for r in catalog}
    missing = sorted(set(live) - set(checked))
    stale = sorted(set(checked) - set(live))
    changed = sorted(
        n for n in set(live) & set(checked) if live[n] != checked[n]
    )
    for kind, names in (("undocumented", missing), ("stale", stale), ("changed", changed)):
        for n in names:
            print(f"{kind}: {n}")
    if missing or stale or changed:
        print("catalog drift — rerun with --write and review the diff")
        return 1
    print(f"catalog clean ({len(catalog)} metrics)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
