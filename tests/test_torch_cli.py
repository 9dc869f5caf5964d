"""The port's command line against the JAX package's.

- Every subcommand's options (their flags, choices and defaults) equal the
  JAX CLI's, with the device backend `tpu` named `cuda`, but for the
  primary's two backend defaults: `cuda` in the port, `cpu` in the JAX CLI.
- The real entry point as OS processes on the host backends: four
  primaries (one with --consensus-disabled), four workers and a
  benchmark_client, through `chip_smoke.cli_committee`, the card's `cli`
  path rehearsed on the CPU: every primary but the external one commits,
  ReadCausal and GetCollections answer over gRPC, every child exits after
  SIGTERM.
- On a machine without a card, a primary asked for a `cuda` backend, or
  given no backend flag, exits non-zero with the error that names the
  missing card (no host fallback).
- `metrics.serve_metrics` serves a registry over HTTP as the JAX one does.
"""

import argparse
import asyncio
import os
import subprocess
import sys

import pytest

import chip_smoke
import narwhal_tpu.__main__ as j_main
import narwhal_tpu.metrics as j_metrics
import narwhal_tpu_torch.__main__ as t_main
import narwhal_tpu_torch.config as t_config
import narwhal_tpu_torch.metrics as t_metrics


class _Parsed(Exception):
    pass


def cli_surface(main, monkeypatch) -> dict:
    """{subcommand path: {option strings: (choices, default, nargs, required)}}
    of the parser `main` builds, read before it parses anything."""

    def capture(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as exc:
        main([])
    monkeypatch.undo()
    out = {}

    def walk(parser, path):
        opts = {}
        for action in parser._actions:
            if isinstance(action, argparse._SubParsersAction):
                for name, sub in action.choices.items():
                    walk(sub, path + (name,))
                continue
            choices = tuple("cuda" if c == "tpu" else c for c in action.choices or ())
            default = "cuda" if action.default == "tpu" else action.default
            opts[tuple(action.option_strings) or (action.dest,)] = (
                choices, default, action.nargs, action.required)
        out[path] = opts

    walk(exc.value.args[0], ())
    return out


# The port's primary takes the card unless told otherwise; the JAX one's
# backends default to the host.
CARD_DEFAULTS = {("run", "primary"): {("--crypto-backend",), ("--dag-backend",)}}


def test_cli_options_equal_the_jax_cli(monkeypatch):
    port = cli_surface(t_main.main, monkeypatch)
    jax = cli_surface(j_main.main, monkeypatch)
    assert set(port) == {(), ("generate_keys",), ("run",), ("run", "primary"),
                         ("run", "worker"), ("benchmark_client",)}
    for path, flags in CARD_DEFAULTS.items():
        for flag in flags:
            choices, default, nargs, required = jax[path][flag]
            assert default == "cpu" and port[path][flag][1] == "cuda"
            jax[path][flag] = (choices, "cuda", nargs, required)
    assert port == jax
    primary = port[("run", "primary")]
    assert primary[("--crypto-backend",)][0] == ("cpu", "pool", "cuda")
    assert primary[("--dag-backend",)][0] == ("cpu", "cuda")


def test_cli_committee_on_the_host_commits(tmp_path):
    out = chip_smoke.cli_committee(str(tmp_path), crypto="cpu", dag="cpu", duration=4.0)
    assert all(v > 0 for v in out["committed"].values()) and len(out["committed"]) == 3
    assert out["read_digests"] >= 1
    assert out["collections"] == min(out["read_digests"], chip_smoke.CLI_COLLECTIONS)
    assert out["collection_errors"] == 0
    assert set(out["exits"]) == {*(f"primary-{i}" for i in range(4)),
                                 *(f"worker-{i}" for i in range(4)), "benchmark_client"}
    assert out["compute_apps"] is None


def _files(tmp_path):
    """A one-authority committee: its key file from `generate_keys`, and its
    committee, workers and parameters files from the port's exports."""
    env = dict(os.environ, PYTHONPATH=chip_smoke.ROOT)
    key = tmp_path / "key.json"
    subprocess.run([sys.executable, "-m", "narwhal_tpu_torch", "generate_keys", "--filename",
                    str(key), "--workers", "1"], check=True, env=env, capture_output=True,
                   cwd=chip_smoke.ROOT, timeout=120)
    import json

    doc = json.loads(key.read_text())
    name = bytes.fromhex(doc["name"])
    t_config.Committee({name: t_config.Authority(
        1, "127.0.0.1:0", bytes.fromhex(doc["network_key"]))}).export(str(tmp_path / "c.json"))
    t_config.WorkerCache({name: {0: t_config.WorkerInfo(
        bytes.fromhex(doc["worker_network_keys"]["0"]), "127.0.0.1:0", "127.0.0.1:0")}}).export(
        str(tmp_path / "w.json"))
    return env, ["run", "--keys", str(key), "--committee", str(tmp_path / "c.json"),
                 "--workers", str(tmp_path / "w.json")]


def test_cuda_primary_without_a_card_exits_naming_it(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the primary would boot on it")
    env, run_args = _files(tmp_path)
    for backend in ([], ["--crypto-backend", "cuda", "--dag-backend", "cpu"],
                    ["--crypto-backend", "cpu", "--dag-backend", "cuda"]):
        proc = subprocess.run(
            [sys.executable, "-m", "narwhal_tpu_torch", *run_args, "primary", *backend],
            env=env, capture_output=True, text=True, cwd=chip_smoke.ROOT, timeout=120)
        assert proc.returncode != 0
        assert "CUDA device requested but torch.cuda is not available" in proc.stderr
        assert "TELEMETRY_ADDR=" not in proc.stdout


@pytest.mark.parametrize("m", [t_metrics, j_metrics], ids=["port", "jax"])
def test_serve_metrics_serves_the_registry(run, m):
    async def scrape():
        registry = m.Registry()
        registry.counter("node_things_total", "Things").inc(7)
        server = await m.serve_metrics(registry, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
            await writer.drain()
            body = await reader.read()
            writer.close()
            return body
        finally:
            server.close()
            await server.wait_closed()

    body = run(scrape())
    head, _, text = body.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200 OK")
    assert m.parse_exposition(text.decode())["node_things_total"]["samples"][""] == 7.0
