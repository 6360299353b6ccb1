"""The port's lint gate: `python -m pinot_tpu_torch.tools.cli lint` exits
clean on the pinot_tpu_torch tree — per-file rules, the interprocedural
race, sync and lifecycle passes, and the port's baseline, which is live
(it matches findings) and has no stale entry.

The analysis takes ~15 s alone on this image's CPU; the wall-time guard
is 60 s (more than 3x that) so a loaded `-n 6` run stays inside it: the
gate is against pathological blowup, not linear growth."""
import json
import time

import pinot_tpu_torch.tools.cli as cli

BUDGET_S = 60.0


def test_cli_lint_exits_zero(capsys):
    rc = cli.main(["lint"])
    out = capsys.readouterr()
    assert rc == 0, out.out + out.err
    assert "0 finding(s)" in out.err and "baselined" in out.err


def test_interprocedural_gate_clean_and_under_budget():
    from pinot_tpu_torch.analysis.engine import run_project

    t0 = time.monotonic()
    report = run_project()
    elapsed = time.monotonic() - t0
    assert report.findings == [], "\n".join(str(f) for f in report.findings)
    assert report.stale_baseline == [], report.stale_baseline
    assert report.baselined > 0  # the port's baseline is live, not decorative
    assert elapsed < BUDGET_S, f"analysis gate took {elapsed:.1f}s (budget {BUDGET_S:.0f}s)"


def test_cli_lint_json_report(capsys):
    rc = cli.main(["lint", "--json"])
    out = capsys.readouterr()
    assert rc == 0
    payload = json.loads(out.out)
    assert payload["count"] == 0 and payload["findings"] == []
    assert payload["staleBaseline"] == []
    assert payload["baselined"] > 0
    mc = payload["modelCheck"]
    assert mc["ok"] is True and mc["maxSchedules"] == 8
    assert set(mc["protocols"]) == {"admission", "batcher", "knobs", "lease", "residency"}
    for entry in mc["protocols"].values():
        assert entry["failure"] is None


def test_cli_lint_flags_bad_path(tmp_path, capsys):
    bad = tmp_path / "cluster" / "racy.py"
    bad.parent.mkdir()
    bad.write_text(
        "class C:\n"
        "    def bump(self):\n"
        "        self._n += 1\n"
    )
    rc = cli.main(["lint", str(bad), "--explain"])
    out = capsys.readouterr()
    assert rc == 1
    assert "W004" in out.out and "1 finding(s)" in out.err
    assert "W004: unlocked read-modify-write" in out.err
