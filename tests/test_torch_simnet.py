"""The port's `simnet/` against the JAX package's.

- The scenarios of `tests/test_simnet.py` and `tests/test_fuzz.py` run
  against the port (each module's source with the package renamed), on
  the host backends the JAX node defaults to.
- Cross-package parity: the three scenarios below, at N = 4 with one worker
  and 200 transactions of 64 bytes a second, give the same fabric event
  log (digest and length), commit sequences and committed rounds in both
  packages; the partition run also on `dag_backend="cuda", device="cpu"`
  (`GpuBullshark` on its plain versions).
- The card's crypto seam (`SimCluster._crypto_pool`) on the CPU, with a
  recording wrapper of the host library in place of `GpuVerifier`: every
  node verifies through it, no `VerifyService` is built, and two runs give
  the host run's event log. A backend that raises shows up as a
  `"backend"` drop in `ScenarioResult.stage_drops`. `GpuVerifier`'s own
  plain versions are not run inside a scenario here (a 2048-row bucket a
  flush is minutes on the CPU); the card holds the real verifier under the
  simulation (`chip_smoke.py`'s `simnet` path).
"""

import re
from pathlib import Path

import pytest
import torch

import narwhal_tpu.simnet as j_simnet
import narwhal_tpu_torch.simnet as t_simnet
from narwhal_tpu_torch import crypto as t_crypto
from narwhal_tpu_torch import types as t_types
from narwhal_tpu_torch.gpu import verifier as t_verifier
from narwhal_tpu_torch.network import transport as t_transport

from test_torch_network import host_backends, port_scenarios  # noqa: F401 (a fixture)

TESTS = Path(__file__).resolve().parent
FILES = ("test_simnet.py", "test_fuzz.py")

_SCENARIOS = {}
for _file in FILES:
    for _name, _fn in port_scenarios(_file).items():
        assert _name not in _SCENARIOS and _name not in globals(), _name
        # The renamed scenarios name no backend: the JAX node's host defaults.
        _SCENARIOS[_name] = pytest.mark.usefixtures("host_backends")(_fn)
globals().update(_SCENARIOS)


def test_all_reference_simnet_scenarios_collected():
    ref = set()
    for file in FILES:
        ref |= set(re.findall(r"^def (test_\w+)", (TESTS / file).read_text(), re.M))
    assert set(_SCENARIOS) == ref and len(_SCENARIOS) == 19


HOST = dict(crypto_backend="cpu", dag_backend="cpu")


def scenario(m, seed: int, **kwargs):
    """The parity scenarios, in package `m`'s simnet: seed 3 fault-free
    for 3.0 virtual s, seed 5 a 2|2 partition from 1.0 to 2.5 in 4.0 s,
    seed 7 with node 3 equivocating for 3.0 s."""
    events, duration = {
        3: ((), 3.0),
        5: ((m.Partition(at=1.0, heal=2.5, groups=((0, 1), (2, 3))),), 4.0),
        7: ((m.Equivocate(node=3),), 3.0),
    }[seed]
    return m.run_scenario(
        nodes=4, workers=1, duration=duration, load_rate=200, tx_size=64,
        plan=m.FaultPlan(seed=seed, events=events), **kwargs,
    )


def same_run(a, b) -> None:
    assert a.event_log_len == b.event_log_len
    assert a.event_log_digest == b.event_log_digest
    assert a.commits == b.commits
    assert a.rounds == b.rounds


@pytest.mark.parametrize("seed", [3, 5, 7])
def test_port_scenario_equals_the_jax_scenario(seed):
    jax = scenario(j_simnet, seed)
    port = scenario(t_simnet, seed, **HOST)
    same_run(port, jax)
    assert min(port.rounds) >= 2 and port.backend_drops() == 0
    t_simnet.oracles.assert_safety(port.commits, honest=port.honest())
    if seed == 5:
        # GpuBullshark on its plain versions awaits its readbacks through
        # run_in_executor, which SimLoop runs inline: the same events.
        same_run(scenario(t_simnet, seed, crypto_backend="cpu", dag_backend="cuda",
                          device="cpu"), jax)
        t_simnet.oracles.assert_liveness(port.rounds, port.round_marks["heal@2.5"],
                                         min_rounds=2)
    if seed == 7:
        assert port.equivocation == jax.equivocation and port.equivocation[3]["twins_sent"] > 0


class RecordingVerifier:
    """Stands in for `GpuVerifier` in `SimCluster._crypto_pool`: the host
    library's verdicts, and a record of which node called the item lane."""

    built: list = []

    def __init__(self, max_bucket, msm_min_bucket, mode, device):
        self.mode, self.device = mode, device
        self.items: list = []  # (node, rows)
        RecordingVerifier.built.append(self)

    def __call__(self, items):
        self.items.append((t_simnet.CURRENT_NODE.get(), len(items)))
        return t_crypto.batch_verify(items)

    def submit_groups(self, groups):
        return groups

    def collect_groups(self, groups):
        return t_types.host_batch_verify_aggregates(groups)


class FailingVerifier(RecordingVerifier):
    def __call__(self, items):
        super().__call__(items)
        raise RuntimeError("launch failed")


@pytest.fixture
def card_seam(monkeypatch):
    """`GpuVerifier` replaced by a recorder, and `VerifyService` made to
    count its constructions."""
    built_services = []
    init = t_verifier.VerifyService.__init__

    def counting_init(self, *args, **kwargs):
        built_services.append(self)
        init(self, *args, **kwargs)

    monkeypatch.setattr(t_verifier.VerifyService, "__init__", counting_init)
    monkeypatch.setattr(RecordingVerifier, "built", [])
    return built_services


def short(seed=3, **kwargs):
    return t_simnet.run_scenario(nodes=4, duration=1.0, load_rate=100,
                                 plan=t_simnet.FaultPlan(seed=seed), **kwargs)


def test_card_pool_replays_the_host_run_and_builds_no_service(card_seam, monkeypatch):
    monkeypatch.setattr(t_verifier, "GpuVerifier", RecordingVerifier)
    shared = set(t_verifier.VerifyService._shared)
    card = [short(crypto_backend="cuda", dag_backend="cpu", device="cpu") for _ in range(2)]
    host = short(**HOST)
    assert card_seam == [] and set(t_verifier.VerifyService._shared) == shared
    # One verifier a cluster, in the committee's mode (the cuda default's
    # cofactored rule: "msm"), on the device the cluster was given.
    assert [(v.mode, v.device) for v in RecordingVerifier.built] == [("msm", "cpu")] * 2
    # Every node's headers and votes go through the item lane. (Honest
    # compact proofs are decided by the verdict cache their co-hosted
    # assembler seeds, so the group lane is not asked for here.)
    for v in RecordingVerifier.built:
        assert {node for node, _ in v.items} == {f"node{i}" for i in range(4)}
    same_run(card[0], card[1])
    same_run(card[0], host)
    assert min(host.rounds) >= 2
    assert card[0].backend_drops() == 0 and card[0].stage_drops == host.stage_drops


def test_card_pool_failure_is_a_backend_drop(card_seam, monkeypatch):
    monkeypatch.setattr(t_verifier, "GpuVerifier", FailingVerifier)
    r = t_simnet.run_scenario(nodes=4, duration=0.5, plan=t_simnet.FaultPlan(seed=1),
                              crypto_backend="cuda", dag_backend="cpu", device="cpu")
    assert card_seam == []
    assert r.backend_drops() > 0
    assert {reason for drops in r.stage_drops for _, reason in drops} == {"backend"}
    assert all(drops for drops in r.stage_drops)  # every node dropped
    assert max(r.rounds) == 0  # nothing verified, nothing committed


def test_run_scenario_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is there: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_simnet.run_scenario(nodes=4, duration=0.1)
    # The scenario's seams are undone: the next one runs.
    assert t_transport._fabric is None
    assert short(seed=2, **HOST).rounds[0] >= 1


def test_fuzz_cli_writes_only_its_out_file(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "campaign.json"
    rc = t_simnet.fuzz.main(["--count", "1", "--seed", "3", "--duration", "1.5",
                             "--crypto-backend", "cpu", "--dag-backend", "cpu",
                             "--out", str(out)])
    assert rc == 0 and "fuzz: 1 scenarios, 0 failure(s)" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["campaign.json"]
    import json

    campaign = json.loads(out.read_text())
    assert campaign["ok"] and campaign["scenarios"][0]["seed"] == 3
