"""The port's deterministic-schedule model checker (pinot_tpu_torch.analysis
scheduler, model_check and models) over the port's protocol classes.

* CLEAN: every model explores its seeded budget without a failure, inside
  a wall-clock budget.
* MUTATION COVERAGE: every broken twin is caught within the same budget.
* REPLAY: a caught trace re-runs bit-identically, also through JSON.
* PARITY: both packages' check_all(seed=0, max_schedules=25,
  mutations=True) catch each mutation with the same failure kind, at the
  same step of the same schedule: the port's protocol classes take their
  primitives in the JAX classes' order."""
import json
import time

import pytest

from pinot_tpu.analysis import model_check as jax_mc
from pinot_tpu.analysis.models import PROTOCOLS as JAX_PROTOCOLS
from pinot_tpu_torch.analysis import model_check
from pinot_tpu_torch.analysis.models import PROTOCOLS
from pinot_tpu_torch.utils import threads

ALL_MUTATIONS = [
    (name, mut)
    for name, cls in sorted(PROTOCOLS.items())
    for mut in getattr(cls, "MUTATIONS", ())
]


def test_same_protocols_and_mutations_as_jax():
    assert set(PROTOCOLS) == set(JAX_PROTOCOLS) == {"admission", "batcher", "knobs", "lease", "residency"}
    for name, cls in PROTOCOLS.items():
        assert cls.MUTATIONS == JAX_PROTOCOLS[name].MUTATIONS


def test_models_drive_the_port_classes():
    from pinot_tpu_torch.cluster.admission import ResourceBudget
    from pinot_tpu_torch.segment.residency import ResidencyManager

    m = PROTOCOLS["residency"]()
    m.setup()
    try:
        assert type(m.rm) is ResidencyManager and type(m.budget) is ResourceBudget
    finally:
        m.teardown()


def test_clean_models_pass_within_budget():
    t0 = time.monotonic()
    report = model_check.check_all(seed=0, max_schedules=25, mutations=True)
    elapsed = time.monotonic() - t0
    assert report["ok"] is True, json.dumps(report, indent=2)
    assert set(report["protocols"]) == set(PROTOCOLS)
    for name, entry in report["protocols"].items():
        assert entry["failure"] is None, f"{name}: {entry['failure']}"
        assert entry["invariants"], f"{name} registered no invariants"
    # ~3 s alone on the CPU; the budget leaves room for a loaded test run
    assert elapsed < 60.0, f"mc gate took {elapsed:.1f}s (budget 60s)"


@pytest.mark.parametrize("protocol,mutation", ALL_MUTATIONS)
def test_every_mutation_is_caught(protocol, mutation):
    res = model_check.explore(PROTOCOLS[protocol], max_schedules=25, seed=0, mutation=mutation)
    assert res["failure"] is not None, f"broken twin {protocol}[{mutation}] survived the schedule budget"


@pytest.mark.parametrize("protocol,mutation", ALL_MUTATIONS)
def test_mutation_caught_as_in_jax(protocol, mutation):
    got = model_check.explore(PROTOCOLS[protocol], max_schedules=25, seed=0, mutation=mutation)
    want = jax_mc.explore(JAX_PROTOCOLS[protocol], max_schedules=25, seed=0, mutation=mutation)
    assert got["failure"]["kind"] == want["failure"]["kind"]
    assert got["schedulesExplored"] == want["schedulesExplored"]
    assert got["failure"]["step"] == want["failure"]["step"]
    assert got["failure"]["schedule"] == want["failure"]["schedule"]


@pytest.mark.parametrize("protocol,mutation", ALL_MUTATIONS)
def test_failing_trace_replays_bit_identically(protocol, mutation):
    trace = model_check.explore(PROTOCOLS[protocol], max_schedules=25, seed=0, mutation=mutation)
    want = trace["failure"]
    for _ in range(2):
        got = model_check.replay(trace)
        assert got is not None, "forced replay lost the failure"
        for key in ("kind", "detail", "step", "schedule"):
            assert got[key] == want[key], f"replay diverged on {key}"


def test_trace_survives_json_round_trip(tmp_path):
    trace = model_check.explore(PROTOCOLS["lease"], max_schedules=25, seed=0, mutation="skip_fence")
    path = str(tmp_path / "trace.json")
    model_check.save_trace(trace, path)
    loaded = model_check.load_trace(path)
    assert loaded == json.loads(json.dumps(trace))
    got = model_check.replay(loaded)
    assert got["detail"] == trace["failure"]["detail"]
    assert got["schedule"] == trace["failure"]["schedule"]


def test_same_seed_same_exploration():
    a = model_check.explore(PROTOCOLS["admission"], max_schedules=6, seed=3, mutation="if_not_while")
    b = model_check.explore(PROTOCOLS["admission"], max_schedules=6, seed=3, mutation="if_not_while")
    assert a == b
    c = model_check.explore(PROTOCOLS["admission"], max_schedules=6, seed=4, mutation="if_not_while")
    assert c["failure"] is not None


def test_cli_mc_gate(capsys):
    import pinot_tpu_torch.tools.cli as cli

    rc = cli.main(["mc", "--mutations"])
    out = capsys.readouterr()
    assert rc == 0, out.out + out.err
    assert "all gates green" in out.err
    assert "MISSED" not in out.out and "FAIL " not in out.out


def test_cli_mc_json_and_capture_then_replay(tmp_path, capsys):
    import pinot_tpu_torch.tools.cli as cli

    path = str(tmp_path / "trace.json")
    rc = cli.main(["mc", "--mutations", "--protocols", "lease", "--save-trace", path, "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["ok"] is True
    assert report["protocols"]["lease"]["mutations"]["skip_fence"]["caught"] is True
    rc = cli.main(["mc", "--replay", path])
    out = capsys.readouterr()
    assert rc == 0, out.out + out.err
    assert "reproduced lease[skip_fence]" in out.out
    rc = cli.main(["mc", "--replay", path, "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and payload["identical"] is True


def test_provider_restored_after_schedules():
    model_check.run_schedule(PROTOCOLS["batcher"], seed=1)
    assert threads.provider() is threads._DEFAULT
    ev = threads.Event()
    ev.set()
    assert ev.wait(timeout=0.1)
