"""The port's tools/cli.py and bench-regression gate against the JAX package's.

Each scenario calls the package's `cli.main([...])` with the same arguments
(the port's `query`, `serve` and `quickstart` with `--device cpu`) and
returns the exit code and what it printed to stdout; the two packages'
outputs must be equal.  The endpoint commands (`slow-queries`,
`admission`, `election`, `autopilot`, `perf`) read a QueryServer of the
same package.  `perf --check` and the gate's functions
(utils/perf.py: bench_record, append/load_bench_history,
regression_allowance, check_regression) run over the same synthetic
records.  The port's own differences are tested on the port alone: `perf
--check` without `--history` / `--baseline` is a usage error, and `query`
without `--device` means the card and fails where there is none.

Mirrored: tests/test_tools.py's CLI case, test_observability.py's
`slow-queries`, test_autopilot.py's `autopilot`, test_leader_election.py's
`election`, test_perf_observatory.py's gate and `perf --check` cases.
Added: `admission`, `perf` without `--check`, `create-segment` with a
table config, `quickstart`, and `serve` as a process of its own.
"""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from test_torch_coordinator import (  # noqa: F401  (fixtures)
    _jax_kill_points, make_cluster, port_state,
)
from test_torch_rest import ELECTION_SNAPSHOT, PKGS, Served, _LeaderlessEngine, both, engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(P, capsys, argv):
    """(exit code, stdout) of one `cli.main(argv)` call."""
    capsys.readouterr()
    rc = P.cli.main(argv)
    return rc, capsys.readouterr().out


def write_inputs(P, d, rows=300, with_config=False):
    """schema.json, data.csv and (optionally) a table config with a range
    index on v under `d`; returns (schema path, csv path, config path, data)."""
    S, C = P.S, P.C
    schema = S.Schema("t", [S.FieldSpec("city", S.DataType.STRING),
                            S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
                            S.FieldSpec("q", S.DataType.INT)])
    d.mkdir(parents=True, exist_ok=True)
    sp = d / "schema.json"
    sp.write_text(json.dumps(schema.to_dict()))
    rng = np.random.default_rng(11)
    q = rng.integers(1, 51, rows)
    csv = d / "data.csv"
    csv.write_text("city,v,q\n" + "\n".join(f"c{i % 3},{i},{q[i]}" for i in range(rows)))
    cp = None
    if with_config:
        cfg = C.TableConfig(name="t", indexing=C.IndexingConfig(range_index_columns=["q"]))
        cp = d / "table.json"
        cp.write_text(json.dumps(cfg.to_dict()))
    data = {"city": np.array([f"c{i % 3}" for i in range(rows)], dtype=object),
            "v": np.arange(rows, dtype=np.int64), "q": q.astype(np.int32)}
    return sp, csv, cp, data


# ---------------------------------------------------------------------------
# create-segment, query, quickstart
# ---------------------------------------------------------------------------
def test_create_segment_and_query(tmp_path, capsys):
    def scenario(P):
        sp, csv, _, _ = write_inputs(P, tmp_path / P.name)
        out = tmp_path / P.name / "seg"
        made = run_cli(P, capsys, ["create-segment", "--schema", str(sp), "--csv", str(csv), "--out", str(out)])
        queried = run_cli(P, capsys, ["query", "--segments", str(out), "--sql",
                                      "SELECT COUNT(*), SUM(v) FROM t"] + P.device_args)
        return made[0], made[1].replace(str(tmp_path / P.name), ""), queried

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][2][0] == 0 and "300" in out["port"][2][1] and str(sum(range(300))) in out["port"][2][1]


def test_create_segment_with_table_config(tmp_path, capsys):
    """The segment built from the CSV has the columns build_segment gives
    the same arrays, and the JAX package's CLI-built columns; the range
    index the config asks for answers a filter."""

    def scenario(P):
        sp, csv, cp, data = write_inputs(P, tmp_path / P.name, rows=500, with_config=True)
        out = tmp_path / P.name / "seg"
        rc, _ = run_cli(P, capsys, ["create-segment", "--schema", str(sp), "--csv", str(csv), "--out", str(out),
                                    "--table-config", str(cp), "--name", "s0"])
        seg = P.Seg.load(str(out))
        direct = P.B.build_segment(seg.schema, data, "s0", table_config=P.C.TableConfig.from_dict(
            json.loads(cp.read_text())))
        cols = {f.name: np.asarray(seg.column(f.name).decoded()).tolist() for f in seg.schema.fields}
        want = {f.name: np.asarray(direct.column(f.name).decoded()).tolist() for f in seg.schema.fields}
        assert cols == want
        q = run_cli(P, capsys, ["query", "--segments", str(out), "--sql",
                                "SELECT city, COUNT(*), SUM(v) FROM t WHERE q < 25 GROUP BY city ORDER BY city"]
                    + P.device_args)
        return rc, seg.num_docs, cols, sorted(seg.indexes.get("range", {})), q

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][3] == ["q"]


def test_query_over_two_segments(tmp_path, capsys):
    def scenario(P):
        sp, csv, _, _ = write_inputs(P, tmp_path / P.name)
        segs = []
        for name in ("a", "b"):
            segs.append(str(tmp_path / P.name / name))
            run_cli(P, capsys, ["create-segment", "--schema", str(sp), "--csv", str(csv), "--out", segs[-1],
                                "--name", name])
        return run_cli(P, capsys, ["query", "--segments", *segs, "--sql",
                                   "SELECT city, COUNT(*), MAX(v) FROM t GROUP BY city ORDER BY city"]
                       + P.device_args)

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][1].splitlines()[1:] == ["c0\t200\t297.0", "c1\t200\t298.0", "c2\t200\t299.0"]


def test_quickstart(capsys):
    out = both(lambda P: run_cli(P, capsys, ["quickstart"] + P.device_args))
    assert out["port"][0] == 0
    # the demo's tables equal; EXPLAIN's plan text is each engine's own
    assert out["port"][1].split("> EXPLAIN")[0] == out["jax"][1].split("> EXPLAIN")[0]
    assert "> EXPLAIN PLAN FOR" in out["port"][1]


# ---------------------------------------------------------------------------
# the endpoint views
# ---------------------------------------------------------------------------
def test_slow_queries(capsys):
    def scenario(P):
        with Served(P, engine(P)) as s:
            s.post({"sql": "SELECT city, COUNT(*) FROM t GROUP BY city"})
            rc, text = run_cli(P, capsys, ["slow-queries", "--url", s.base, "--limit", "3"])
            rcj, js = run_cli(P, capsys, ["slow-queries", "--url", s.base, "--json"])
        assert "GROUP BY city" in text and "qid=engine_" in text
        entry = json.loads(js)[0]
        return rc, rcj, text.split("ms  ")[1].split("qid=")[0], text.split("fp=")[1].split(" ")[1:], sorted(entry)

    out = both(scenario)
    assert out["port"] == out["jax"]


def test_admission(capsys):
    def scenario(P):
        broker = P.cl.Broker(make_cluster(P, n_servers=2, replication=2, n_segments=2)[0])
        with Served(P, broker) as s:
            rc, text = run_cli(P, capsys, ["admission", "--url", s.base])
            rcj, js = run_cli(P, capsys, ["admission", "--url", s.base, "--json"])
        # the host budget's peak is the process's (earlier tests in a worker
        # raise it), not this broker's
        return rc, re.sub(r"peak [0-9.]+ MB", "peak - MB", text), rcj, sorted(json.loads(js))

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert "pressure level : 0" in out["port"][1] and "host budget" in out["port"][1]


def test_election(capsys):
    def scenario(P):
        with Served(P, _LeaderlessEngine(P, ELECTION_SNAPSHOT)) as s:
            return run_cli(P, capsys, ["election", "--url", s.base]), run_cli(
                P, capsys, ["election", "--url", s.base, "--json"])

    out = both(scenario)
    assert out["port"] == out["jax"]
    (rc, text), (rcj, js) = out["port"]
    assert rc == rcj == 0 and "leader  : coord-a" in text and "role=leader" in text and "epoch=1" in text
    assert json.loads(js) == ELECTION_SNAPSHOT


def test_autopilot(capsys):
    def scenario(P):
        broker = P.cl.Broker(make_cluster(P, n_servers=2, replication=2, n_segments=2)[0])
        broker.attach_autopilot()
        broker.autopilot.tick()
        P.autopilot.knobs().set("batch_wait_ms", 4.0)
        with Served(P, broker) as s:
            rc, text = run_cli(P, capsys, ["autopilot", "--url", s.base])
            rcj, js = run_cli(P, capsys, ["autopilot", "--url", s.base, "--json"])
        broker.attach_autopilot(controller=None)
        return rc, [line for line in text.splitlines() if "p99=" not in line], rcj, json.loads(js)["knobs"]

    out = both(scenario)
    assert out["port"] == out["jax"]
    rc, lines, _, knobs = out["port"]
    assert rc == 0 and lines[0].startswith("autopilot : ON") and any("*batch_wait_ms" in x for x in lines)
    assert knobs["batch_wait_ms"]["value"] == 4.0


def test_perf_view(capsys):
    def scenario(P):
        with Served(P, engine(P)) as s:
            s.post({"sql": "SELECT COUNT(*) FROM t"})
            rc, text = run_cli(P, capsys, ["perf", "--url", s.base])
            rcj, js = run_cli(P, capsys, ["perf", "--url", s.base, "--json"])
        payload = json.loads(js)
        return rc, text.splitlines()[0], rcj, sorted(payload), sorted(payload["tables"])

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][1] == "table t: 1 quer(y/ies), qps=0"


# ---------------------------------------------------------------------------
# the bench-regression gate
# ---------------------------------------------------------------------------
def rec(scale=1.0, rv=0.02, backend="xla"):
    return {"schema": 1, "bench": "ssb_groupby", "backend": backend, "rows": 1 << 20,
            "metrics": {"kernel_rows_per_sec": 1e6 * scale, "e2e_rows_per_sec": 5e5 * scale,
                        "warm_p50_rows_per_sec": 8e5 * scale, "effective_bytes_per_sec": 9e6 * scale,
                        "hedged_p99_ms": 20.0 / scale},
            "noise": {"run_variance": rv}}


@pytest.mark.parametrize("case", [
    (rec(), rec(), None), (rec(scale=0.80), rec(), None), (rec(scale=0.80, rv=10.0), rec(rv=10.0), None),
    (rec(scale=0.90), rec(), None), (rec(backend="interpret"), rec(), None), ({"metrics": {}}, {"metrics": {}}, None),
    (rec(scale=0.95), rec(), 0.01),
], ids=["identical", "drop20", "drop20_noisy", "drop10", "incomparable", "empty", "threshold"])
def test_check_regression(case):
    latest, baseline, threshold = case
    out = both(lambda P: P.perf.check_regression(latest, baseline, threshold=threshold))
    assert out["port"] == out["jax"]


def test_allowance_history_and_record(tmp_path):
    report = {"value": 123.0, "value_e2e": 45.0, "run_variance": 0.07, "rows": 10, "backend": "xla",
              "effective_bytes_per_sec": 999.0, "distinct_literal_sweep": {"warm_p50_rows_per_sec": 77.0},
              "plan_cache": {"hit_rate": 0.9},
              "roofline": {"device_kind": "cpu", "kernel_roofline_pct": 1.5, "cost_bytes_per_sec": 1000.0}}

    def scenario(P):
        p = tmp_path / f"{P.name}.jsonl"
        P.perf.append_bench_history(str(p), rec())
        p.write_text(p.read_text() + "{torn line\n")
        P.perf.append_bench_history(str(p), rec(scale=1.1))
        return ([P.perf.regression_allowance(rec(rv=v)) for v in (0.0, 0.13, 1.0, float("nan"))],
                P.perf.load_bench_history(str(p)), p.read_text(), P.perf.bench_record(report),
                P.perf.load_bench_history(str(tmp_path / "none.jsonl")))

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == pytest.approx(0.15) and len(out["port"][1]) == 2


@pytest.mark.parametrize("scale,rc", [(0.75, 1), (1.02, 0)], ids=["regression", "healthy"])
def test_perf_check(tmp_path, capsys, scale, rc):
    def scenario(P):
        hist, base = tmp_path / f"{P.name}_hist.jsonl", tmp_path / f"{P.name}_base.json"
        base.write_text(json.dumps(rec()))
        P.perf.append_bench_history(str(hist), rec(scale=scale))
        return (run_cli(P, capsys, ["perf", "--check", "--history", str(hist), "--baseline", str(base)]),
                run_cli(P, capsys, ["perf", "--check", "--json", "--history", str(hist), "--baseline", str(base)]))

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == rc and ("FAIL" in out["port"][0][1]) == (rc == 1)


def test_perf_check_missing_history_or_baseline(tmp_path, capsys):
    def scenario(P):
        base = tmp_path / "base.json"
        base.write_text(json.dumps(rec()))
        hist = tmp_path / "hist.jsonl"
        P.perf.append_bench_history(str(hist), rec())
        return (run_cli(P, capsys, ["perf", "--check", "--history", str(tmp_path / "nope.jsonl"),
                                    "--baseline", str(base)]),
                run_cli(P, capsys, ["perf", "--check", "--history", str(hist),
                                    "--baseline", str(tmp_path / "nope.json")]))

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert [r[0] for r in out["port"]] == [1, 1]


def test_port_perf_check_needs_both_files(capsys):
    """The port reads no default history or baseline: `--check` without
    either is a usage error (argparse's exit 2)."""
    from pinot_tpu_torch.tools import cli

    for argv in (["perf", "--check"], ["perf", "--check", "--history", "h.jsonl"],
                 ["perf", "--check", "--baseline", "b.json"]):
        with pytest.raises(SystemExit) as ei:
            cli.main(argv)
        assert ei.value.code == 2
    assert "needs --history and --baseline" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# processes of their own: the default device, and serve
# ---------------------------------------------------------------------------
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _segment(tmp_path, capsys):
    from test_torch_rest import spkg

    P = spkg("port")
    sp, csv, _, _ = write_inputs(P, tmp_path)
    out = tmp_path / "seg"
    assert run_cli(P, capsys, ["create-segment", "--schema", str(sp), "--csv", str(csv), "--out", str(out)])[0] == 0
    return str(out)


def test_query_without_device_means_the_card(tmp_path, capsys):
    """`query` with no --device asks for CUDA; on a machine without it the
    command fails with resolve_device's error and prints no rows."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    seg = _segment(tmp_path, capsys)
    proc = subprocess.run([sys.executable, "-m", "pinot_tpu_torch.tools.cli", "query", "--segments", seg,
                           "--sql", "SELECT COUNT(*) FROM t"], capture_output=True, text=True, env=_env(),
                          timeout=120, cwd=str(tmp_path))
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert proc.stdout == ""


def test_serve_in_its_own_process(tmp_path, capsys):
    """`serve --port 0 --device cpu` in a child process: it prints its URL,
    answers a query over HTTP, and stops on SIGINT with exit code 0."""
    seg = _segment(tmp_path, capsys)
    proc = subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.cli", "serve", "--segments", seg,
                             "--port", "0", "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=str(tmp_path))
    try:
        first = []
        reader = threading.Thread(target=lambda: first.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout=120)
        line = first[0] if first else ""
        assert line.startswith("query server listening on http://127.0.0.1:"), (line, proc.poll())
        url = line.split()[-1]
        req = urllib.request.Request(url, data=json.dumps({"sql": "SELECT COUNT(*), SUM(v) FROM t"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            payload = json.loads(r.read().decode())
        assert payload["resultTable"]["rows"] == [[300, sum(range(300))]]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
