"""The port's user surface beside the package, against the JAX package's.

- The metrics catalog (`narwhal_tpu_torch/tools/metrics_catalog.py` and its
  `metrics_catalog.json`): the port's live registries equal its checked-in
  catalog (the renamed `test_metrics_catalog_matches_registries` of
  `tests/test_telemetry.py`), that catalog equals the JAX package's
  `tools/metrics_catalog.json` row for row, and both packages' nodes built
  on their device backends (the JAX `"tpu"` on CPU JAX, the port's `"cuda"`
  with `device="cpu"`) register those same rows.
- The simnet profiler (`narwhal_tpu_torch/tools/simnet_profile.py`): the
  renamed classification cases of `tests/test_perf_observatory.py` plus
  the port's `device_pack` and `device_wait` components, one seeded
  scenario on host backends
  whose figures equal the JAX profiler's, and the reference's 0.8
  attribution gate (`slow`, as in the JAX package).
- The epilogue attributor (`narwhal_tpu_torch/tools/epilogue.py`): every
  figure and column of the JAX package's `attribute` and `render_table`,
  equal, on flight dumps of the port's `FusedCertificatePipeline` (the stub
  verifier and engine of `tests/test_perf_observatory.py`) and on its
  synthetic dumps; the port's verdict epilogue and resolve books beside
  them, which see host work that no span records.
- The demo clients (`narwhal_tpu_torch/examples/`): each client's
  `standalone()` on the host (its 4-node port `Cluster` on the defaults
  `host_backends` sets) prints what the JAX client's `demo()` prints
  against a JAX `Cluster`: the same labels, every answer non-empty.
"""

import asyncio
import importlib
import json
import re
from pathlib import Path

import pytest

from test_torch_network import host_backends, port_scenarios, set_defaults  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parent.parent

# --------------------------------------------------------------- catalog

_CATALOG_GATE = port_scenarios(
    "test_telemetry.py",
    subs=((r"\btools\.metrics_catalog\b", "narwhal_tpu_torch.tools.metrics_catalog"),),
)["test_metrics_catalog_matches_registries"]
test_metrics_catalog_matches_registries = _CATALOG_GATE


def test_port_catalog_equals_the_jax_catalog_row_for_row():
    from narwhal_tpu_torch.tools import metrics_catalog

    port = metrics_catalog.load_catalog()
    jax = json.loads((REPO / "tools" / "metrics_catalog.json").read_text())
    assert len(port) == 98
    assert port == jax
    assert {r["name"] for r in port if r["type"] == "span_stage"} == {
        f"span:{stage}" for stage, _role, _help in metrics_catalog.SPAN_STAGES
    }


def test_device_backend_assemblies_register_the_same_rows(monkeypatch):
    from narwhal_tpu import node as jax_node
    from narwhal_tpu_torch.tools import metrics_catalog
    from tools.metrics_catalog import extract_catalog as jax_extract

    # The JAX extractor passes no backend: its node's defaults, set to "tpu".
    set_defaults(monkeypatch, (jax_node.PrimaryNode,), crypto_backend="tpu",
                 dag_backend="tpu")
    jax_rows = jax_extract()
    port_rows = metrics_catalog.extract_catalog(
        crypto_backend="cuda", dag_backend="cuda", device="cpu")
    assert port_rows == jax_rows == metrics_catalog.load_catalog()


def test_catalog_cli_reports_clean(monkeypatch, capsys):
    from narwhal_tpu_torch.tools import metrics_catalog

    monkeypatch.setattr("sys.argv", ["metrics_catalog"])
    assert metrics_catalog.main() == 0
    assert "catalog clean (98 metrics)" in capsys.readouterr().out


# -------------------------------------------------------- simnet profiler

CLASSIFY_CASES = {
    ("narwhal_tpu_torch/simnet/fabric.py", "_deliver"): "fabric_deliver",
    ("narwhal_tpu_torch/simnet/fabric.py", "append"): "event_log",
    ("narwhal_tpu_torch/simnet/clock.py", "run_until"): "sim_clock",
    ("narwhal_tpu_torch/network/auth.py", "seal"): "auth_aead",
    ("narwhal_tpu_torch/crypto.py", "verify"): "signing",
    ("narwhal_tpu_torch/network/rpc.py", "send"): "wire_rpc",
    ("narwhal_tpu_torch/codec.py", "encode"): "codec",
    ("narwhal_tpu_torch/primary/core.py", "process"): "protocol",
    ("/usr/lib/python3.11/asyncio/events.py", "run"): "asyncio_loop",
    ("/some/random/lib.py", "f"): "other",
    # The port's card plane: its host Python, then the C calls that copy
    # to the card and wait on it.
    ("/checkout/narwhal_tpu_torch/gpu/verifier.py", "_dispatch"): "device_pack",
    ("/checkout/narwhal_tpu_torch/gpu/ed25519.py", "bytes_to_limbs"): "device_pack",
    ("/usr/lib/python3/site-packages/torch/cuda/__init__.py", "synchronize"): "device_pack",
    ("~", "<built-in method torch._C._cuda_synchronize>"): "device_wait",
    ("~", "<method 'copy_' of 'torch._C.TensorBase' objects>"): "device_wait",
    ("~", "<method 'to' of 'torch._C.TensorBase' objects>"): "device_wait",
    ("~", "<function Event.synchronize at 0x7f78e0ffc5e0>"): "device_wait",
    # The selector's poll on Linux, which the reference's pattern misses.
    ("~", "<method 'poll' of 'select.epoll' objects>"): "asyncio_loop",
}


@pytest.mark.parametrize("where, want", sorted(CLASSIFY_CASES.items()),
                         ids=[f"{f}:{fn}" for f, fn in sorted(CLASSIFY_CASES)])
def test_simnet_profile_classify_table(where, want):
    from narwhal_tpu_torch.tools import simnet_profile

    assert simnet_profile.classify(*where) == want


def test_classify_table_is_the_references_renamed_plus_device_and_epoll():
    from narwhal_tpu_torch.tools import simnet_profile as port
    from tools.perf import simnet_profile as jax

    device = ["device_pack", "device_wait"]
    assert [c for c, _ in port._COMPONENTS] == [
        c for c, _ in jax._COMPONENTS[:5]] + device + [c for c, _ in jax._COMPONENTS[5:]]
    renamed = {
        c: p.pattern.replace("narwhal_tpu/tpu/", "narwhal_tpu_torch/gpu/")
        .replace("narwhal_tpu/", "narwhal_tpu_torch/")
        for c, p in jax._COMPONENTS
    }
    epoll = r"~:<method 'poll' of 'select\.epoll' objects>|"
    renamed["asyncio_loop"] = renamed["asyncio_loop"].replace(
        r"~:<built-in method select|", r"~:<built-in method select|" + epoll)
    assert {c: p.pattern for c, p in port._COMPONENTS if c not in device} == renamed


def test_profile_scenario_matches_the_jax_profilers_scenario():
    """The same seeded scenario on the port's host backends and in the JAX
    package: the same event log length, committed rounds and fabric
    counters (the self-time split is each process's own)."""
    from narwhal_tpu_torch.tools import simnet_profile as port
    from tools.perf import simnet_profile as jax

    kw = dict(nodes=4, duration=1.5, load_rate=60, seed=11)
    got = port.profile_scenario(**kw, crypto_backend="cpu", dag_backend="cpu")
    want = jax.profile_scenario(**kw)
    for key in ("event_log_len", "committed_rounds", "fabric_counters"):
        assert got["scenario"][key] == want["scenario"][key], key
    assert got["scenario"]["backend_drops"] == 0
    assert got["total_self_s"] > 0


@pytest.mark.slow
def test_simnet_profile_attributes_hot_path():
    from narwhal_tpu_torch.tools import simnet_profile

    report = simnet_profile.profile_scenario(
        nodes=4, duration=1.5, load_rate=60, seed=11,
        crypto_backend="cpu", dag_backend="cpu",
    )
    assert report["total_self_s"] > 0
    # The acceptance floor: the component table must name >=80% of the
    # self time, or it has drifted from the code.
    assert report["attributed_share"] >= 0.8, report["components"]
    components = report["components"]
    # Ranked by share, descending; shares decompose (sum to ~1 with other).
    shares = [c["share"] for c in components]
    assert shares == sorted(shares, reverse=True)
    assert sum(shares) == pytest.approx(1.0, abs=0.01)
    counters = report["scenario"]["fabric_counters"]
    assert counters["delivers"] > 0 and counters["bytes_delivered"] > 0
    assert counters["transmits"] >= counters["delivers"]
    table = simnet_profile.render_table(report)
    assert "fabric" in table


def test_profiler_cli_writes_only_its_out_file(tmp_path, monkeypatch, capsys):
    from narwhal_tpu_torch.tools import simnet_profile

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "profile.json"
    assert simnet_profile.main([
        "--nodes", "4", "--duration", "0.5", "--load-rate", "20", "--seed", "3",
        "--crypto-backend", "cpu", "--dag-backend", "cpu", "--out", str(out),
    ]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["profile.json"]
    report = json.loads(out.read_text())
    assert report["scenario"]["nodes"] == 4 and report["components"]
    assert "simnet fabric profile" in capsys.readouterr().out


# ------------------------------------------------------ epilogue attributor

class _StubCert:
    def __init__(self, tag: int, compact: bool = False):
        self.digest = bytes([tag]) * 32
        self.is_compact = compact

    def verify_items(self, committee):
        return [(self.digest, b"sig", b"pk")] * 3


class _StubVerifier:
    """The JAX test's stub, plus `wait` (the port's pipeline waits for each
    lane's launch before it collects)."""

    def submit(self, items):
        return list(items)

    def wait(self, handle):
        pass

    def collect(self, handle):
        return [True] * len(handle)

    def submit_groups(self, groups):
        return list(groups)

    def collect_groups(self, handle):
        return [True] * len(handle)


class _StubEngine:
    committee = None

    def process_batch(self, state, index, accepted):
        return [("out", c.digest) for c in accepted]


def _port_pipeline_dumps() -> list[dict]:
    from narwhal_tpu_torch import tracing
    from narwhal_tpu_torch.gpu.pipeline import FusedCertificatePipeline

    tracer = tracing.Tracer(node="test", enabled=True, sample=1.0, ring=256)
    pipe = FusedCertificatePipeline(
        _StubVerifier(), _StubEngine(), state=None, depth=1, tracer=tracer)
    pipe.feed([_StubCert(1), _StubCert(2)], committee=object())
    pipe.feed([_StubCert(3)], committee=object())
    outs = pipe.drain()
    assert len(outs) == 3 and not pipe.rejected
    return [tracer.dump()]


_SYNTHETIC = [
    {"node": "n", "events": [
        ("span", "device_pack", "aa", 0.0, 0.1, {"n": 8}),
        ("span", "device_dispatch", "aa", 0.1, 0.12, {"n": 8}),
        ("span", "device_mask_readback", "aa", 0.5, 0.7, {"n": 8}),
        ("span", "host_epilogue", "aa", 0.7, 1.7, {"n": 8}),
        ("span", "epilogue_unpack", "aa", 0.7, 0.9, {"n": 8}),
        ("span", "epilogue_commit", "aa", 0.9, 1.7, {"n_accepted": 8}),
        ("instant", "seal", "zz", 0.0),
    ]},
    {"node": "n", "events": [
        ("span", "host_epilogue", "bb", 0.0, 1.0, {"n": 4}),
        ("span", "epilogue_unpack", "bb", 0.0, 0.2, {"n": 4}),
        ("span", "epilogue_commit", "bb", 0.2, 0.6, {"n_accepted": 4}),
    ]},
]


@pytest.mark.parametrize("source", ["port_pipeline", "synthetic"])
def test_epilogue_attribute_equals_the_jax_attributor(source):
    """The JAX attributor's every figure and table column, equal; the
    port's own verdict epilogue and resolve books beside them."""
    from narwhal_tpu_torch.tools import epilogue as port
    from tools.perf import epilogue as jax

    dumps = _port_pipeline_dumps() if source == "port_pipeline" else _SYNTHETIC
    got, want = port.attribute(dumps), jax.attribute(dumps)
    assert len(got["batches"]) == len(want["batches"])
    for row, ref in zip(got["batches"], want["batches"]):
        assert {k: row[k] for k in ref} == ref
    assert {k: got["totals"][k] for k in want["totals"]} == want["totals"]
    lines, ref_lines = port.render_table(got).splitlines(), jax.render_table(want).splitlines()
    assert len(lines) == len(ref_lines)
    assert all(line.startswith(ref) for line, ref in zip(lines, ref_lines))
    assert port.STAGES == jax.STAGES + port.VERDICT_PARTS
    if source == "port_pipeline":
        assert got["totals"]["batches"] == 2
        for row in got["batches"]:
            assert set(port.STAGES) <= set(row), row
            assert row["epilogue_rel_err"] <= 0.10
            # The stubs' resolve takes microseconds, of which the tracer's
            # own calls between the spans are a sizeable part: the spans
            # tile the window without overlap, and no more is asked here.
            parts = sum(row[p] for p in port.RESOLVE_PARTS)
            assert 0 < parts <= row["resolve_s"] + 4e-6
        assert got["totals"]["epilogue_rel_err"] <= 0.10
        assert got["totals"]["verdict_epilogue_s"] == pytest.approx(
            got["totals"]["item_epilogue"] + got["totals"]["group_epilogue"], abs=2e-6)


def test_epilogue_resolve_books_see_unspanned_verdict_work():
    """Host work between the readback and host_epilogue that no span
    records: the epilogue's books stay balanced, the resolve's do not;
    the verdict spans count in the host's share after the readback."""
    from narwhal_tpu_torch.tools import epilogue

    def dump(verdict_end):
        return {"node": "n", "events": [
            ("span", "device_pack", "aa", 0.0, 0.1, {"n": 8}),
            ("span", "device_dispatch", "aa", 0.1, 0.2, {"n": 8}),
            ("span", "device_mask_readback", "aa", 0.2, 0.3, {"n": 8}),
            ("span", "item_epilogue", "aa", 0.3, verdict_end, {"n": 8}),
            ("span", "group_epilogue", "aa", verdict_end, verdict_end, {"n": 8}),
            ("span", "host_epilogue", "aa", 0.7, 1.0, {"n": 8}),
            ("span", "epilogue_unpack", "aa", 0.7, 0.8, {"n": 8}),
            ("span", "epilogue_commit", "aa", 0.8, 1.0, {"n_accepted": 8}),
        ]}

    whole = epilogue.attribute([dump(0.7)])["totals"]
    assert whole["resolve_rel_err"] == 0.0 and whole["epilogue_rel_err"] == 0.0
    assert whole["verdict_epilogue_s"] == pytest.approx(0.4)
    assert whole["resolve_s"] == pytest.approx(0.8)
    assert whole["host_after_readback_share"] == pytest.approx(0.7)
    assert whole["epilogue_share_of_batch"] == pytest.approx(0.5)
    gap = epilogue.attribute([dump(0.4)])["totals"]  # 0.3 s unspanned
    assert gap["epilogue_rel_err"] == 0.0
    assert gap["resolve_rel_err"] == pytest.approx(0.375)


def test_epilogue_cli_reads_dump_files(tmp_path, capsys):
    from narwhal_tpu_torch.tools import epilogue

    one, both = tmp_path / "one.json", tmp_path / "both.json"
    one.write_text(json.dumps(_SYNTHETIC[0]))
    both.write_text(json.dumps(_SYNTHETIC))
    assert epilogue.main([str(one), str(both)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device epilogue attribution")
    assert json.loads(lines[-1]) == epilogue.attribute([_SYNTHETIC[0]] + _SYNTHETIC)["totals"]


# ------------------------------------------------------------ demo clients

def _labels(out: str) -> list[str]:
    """Each printed line's label: the words before its first figure."""
    return [re.split(r"[:(]| \d", line, maxsplit=1)[0] for line in out.strip().splitlines()]


def _figures(out: str) -> dict[str, list[int]]:
    return {label: [int(x) for x in re.findall(r"\b\d+\b", line.split(":", 1)[-1])]
            for label, line in zip(_labels(out), out.strip().splitlines())}


async def _walk(cluster, demo, grpc: bool) -> None:
    await cluster.start()
    try:
        node = cluster.authorities[0]
        if grpc:
            await demo(node.primary.grpc_api_address, node.name,
                       node.workers[0].worker.grpc_transactions_address)
        else:
            await demo(node.primary.api_address, node.name,
                       node.worker_transactions_address(0))
    finally:
        await cluster.shutdown()


@pytest.mark.parametrize("client", ["demo_client", "grpc_demo_client"])
def test_demo_prints_what_the_jax_demo_prints(client, run, capsys, host_backends):
    """The port client's whole standalone flow (`standalone()`, as `python
    -m` runs it, on the host through the Cluster defaults that
    `host_backends` sets) against the JAX client's `demo()` on a JAX
    `Cluster` of the same shape."""
    import sys

    from narwhal_tpu.cluster import Cluster as JaxCluster

    port = importlib.import_module(f"narwhal_tpu_torch.examples.{client}")
    sys.path.insert(0, str(REPO / "examples"))
    try:
        jax = importlib.import_module(client)
    finally:
        sys.path.remove(str(REPO / "examples"))
    grpc = client.startswith("grpc")
    outs = {}
    for name, flow in (
        ("jax", lambda: _walk(JaxCluster(size=4, workers=1, internal_consensus=False),
                              jax.demo, grpc)),
        ("port", port.standalone),
    ):
        capsys.readouterr()
        run(flow(), timeout=90.0)
        outs[name] = capsys.readouterr().out
    assert _labels(outs["port"]) == _labels(outs["jax"]) == [
        "submitted", "Rounds", "NodeReadCausal", "GetCollections", "RemoveCollections"]
    for name, out in outs.items():
        figures = _figures(out)
        assert figures["Rounds"][1] >= 2, (name, out)
        collections = figures["NodeReadCausal"][-1]
        assert collections >= 1, (name, out)
        asked = min(4, collections) if grpc else collections
        assert figures["GetCollections"][0] == asked, (name, out)
        assert figures["RemoveCollections"][0] == asked, (name, out)


def test_demo_is_the_references_with_the_package_renamed():
    for client in ("demo_client", "grpc_demo_client"):
        ref = (REPO / "examples" / f"{client}.py").read_text()
        port = (REPO / "narwhal_tpu_torch" / "examples" / f"{client}.py").read_text()
        start = "async def demo(" if client == "demo_client" else "def _unary("

        def body(src, end):
            return src[src.index(start):src.index(end)]

        assert body(port, "async def standalone(") == body(
            ref, "async def main(" if client == "demo_client" else "async def standalone(")
        module = importlib.import_module(f"narwhal_tpu_torch.examples.{client}")
        assert asyncio.iscoroutinefunction(module.standalone)
