"""CLI: the PinotAdministrator command tree, python-m style.

Reference parity: pinot-tools/.../tools/admin/command/ (CreateSegment,
PostQuery, StartServiceManager/quickstart commands).

  python -m pinot_tpu_torch.tools.cli create-segment --schema s.json --csv d.csv --out dir
  python -m pinot_tpu_torch.tools.cli query --segments dir1 dir2 --sql "SELECT ..."
  python -m pinot_tpu_torch.tools.cli serve --segments dir1 --port 8099
  python -m pinot_tpu_torch.tools.cli quickstart
  python -m pinot_tpu_torch.tools.cli perf --check --history h.jsonl --baseline b.json
  python -m pinot_tpu_torch.tools.cli slow-queries --url http://127.0.0.1:8099
  python -m pinot_tpu_torch.tools.cli admission --url http://127.0.0.1:8099
  python -m pinot_tpu_torch.tools.cli lint [paths] [--json] [--explain]
  python -m pinot_tpu_torch.tools.cli mc --mutations [--replay trace.json] [--save-trace t.json]

Port of pinot_tpu/tools/cli.py: the same subcommands, flags and output.
`lint` and `mc` run the port's analysis tools (analysis/) over the
pinot_tpu_torch tree and its protocol classes; neither takes a device.  Two
differences: `query`, `serve` and `quickstart` take `--device`, whose
default is the card (`resolve_device(None)`, which raises without CUDA;
`--device cpu` runs the plain PyTorch path), and `perf --check` needs
`--history` and `--baseline` named (no default file is read).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List


def _load_schema(path: str):
    from pinot_tpu_torch.spi.schema import Schema

    with open(path, "r", encoding="utf-8") as f:
        return Schema.from_dict(json.load(f))


def _load_config(path, name):
    from pinot_tpu_torch.spi.config import TableConfig

    if path:
        with open(path, "r", encoding="utf-8") as f:
            return TableConfig.from_dict(json.load(f))
    return TableConfig(name=name)


def cmd_create_segment(args) -> int:
    from pinot_tpu_torch.ingest import read_csv_columns
    from pinot_tpu_torch.segment.builder import build_segment

    schema = _load_schema(args.schema)
    cfg = _load_config(args.table_config, schema.name)
    cols = read_csv_columns(args.csv, schema=schema, delimiter=args.delimiter)
    name = args.name or os.path.splitext(os.path.basename(args.csv))[0]
    seg = build_segment(schema, cols, name, table_config=cfg, output_dir=args.out)
    print(f"built segment {name}: {seg.num_docs} docs -> {args.out}")
    return 0


def _engine_for_segments(segment_dirs: List[str], device=None):
    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.segment.segment import ImmutableSegment

    eng = QueryEngine(device=device)
    for d in segment_dirs:
        seg = ImmutableSegment.load(d)
        if seg.table_name not in eng.tables:
            eng.register_table(seg.schema)
        eng.add_segment(seg.table_name, seg)
    return eng


def cmd_query(args) -> int:
    eng = _engine_for_segments(args.segments, args.device)
    res = eng.sql(args.sql)
    print("\t".join(res.columns))
    for row in res.rows:
        print("\t".join(str(v) for v in row))
    print(
        f"-- {len(res.rows)} rows, {res.stats.num_docs_scanned} docs scanned, "
        f"{res.stats.time_ms:.1f} ms",
        file=sys.stderr,
    )
    return 0


def cmd_serve(args) -> int:
    from pinot_tpu_torch.cluster.rest import QueryServer

    eng = _engine_for_segments(args.segments, args.device)
    server = QueryServer(eng, port=args.port).start()
    print(f"query server listening on http://127.0.0.1:{server.port}/query/sql", flush=True)
    try:
        import time

        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


def cmd_quickstart(args) -> int:
    """In-memory demo: build a table, run example queries (quickstart analog)."""
    import numpy as np

    from pinot_tpu_torch.query.engine import QueryEngine

    eng = QueryEngine(device=args.device)
    eng.sql(
        "CREATE TABLE demo (city STRING, product STRING, amount DOUBLE METRIC, ts TIMESTAMP) "
        "WITH (invertedIndexColumns = 'city', timeColumnName = 'ts')"
    )
    rng = np.random.default_rng(7)
    n = 100_000
    from pinot_tpu_torch.segment.builder import build_segment

    state = eng.table("demo")
    data = {
        "city": rng.choice(["sf", "nyc", "tokyo", "berlin"], n).astype(object),
        "product": rng.choice(["a", "b", "c"], n).astype(object),
        "amount": np.round(rng.random(n) * 100, 2),
        "ts": 1_700_000_000_000 + rng.integers(0, 30 * 86_400_000, n),
    }
    eng.add_segment("demo", build_segment(state.schema, data, "demo_0", table_config=state.config))
    for sql in [
        "SELECT COUNT(*) FROM demo",
        "SELECT city, SUM(amount) FROM demo GROUP BY city ORDER BY SUM(amount) DESC",
        "SELECT product, COUNT(*) FROM demo WHERE city = 'sf' GROUP BY product",
        "EXPLAIN PLAN FOR SELECT COUNT(*) FROM demo WHERE city = 'sf'",
    ]:
        print(f"\n> {sql}")
        res = eng.sql(sql)
        print("\t".join(res.columns))
        for row in res.rows:
            print("\t".join(str(v) for v in row))
    return 0


def cmd_slow_queries(args) -> int:
    """Print a serving broker/engine's recent-query ring (GET /debug/queries):
    newest first, one line per query, trace presence flagged."""
    import urllib.request

    url = args.url.rstrip("/") + f"/debug/queries?limit={args.limit}"
    with urllib.request.urlopen(url) as resp:
        payload = json.loads(resp.read().decode("utf-8"))
    entries = payload.get("queries", [])
    if args.json:
        print(json.dumps(entries, indent=2, default=str))
        return 0
    for e in entries:
        flags = []
        if e.get("error"):
            flags.append("ERROR")
        if e.get("partialResult"):
            flags.append("PARTIAL")
        if e.get("trace") is not None:
            flags.append("TRACED")
        print(
            f"{e.get('timeMs', 0):>10.3f} ms  rows={e.get('rows', 0):<8} "
            f"docs={e.get('numDocsScanned', 0):<10} qid={e.get('queryId')} "
            f"fp={e.get('planFingerprint')} {' '.join(flags)}  {e.get('sql', '')}"
        )
    print(f"-- {len(entries)} entr(y/ies)", file=sys.stderr)
    return 0


def cmd_admission(args) -> int:
    """Print a serving endpoint's overload-protection state (GET
    /debug/admission): pressure level, admission bucket, host-budget ledger,
    active queries, and the recent kill ring."""
    import urllib.request

    url = args.url.rstrip("/") + "/debug/admission"
    with urllib.request.urlopen(url) as resp:
        payload = json.loads(resp.read().decode("utf-8"))
    if args.json:
        print(json.dumps(payload, indent=2))
        return 0
    adm = payload.get("admission", {})
    host = payload.get("hostBudget", {})
    dog = payload.get("watchdog", {})
    print(f"pressure level : {payload.get('pressureLevel', 0)}")
    print(
        f"admission      : rate={adm.get('rate', 0):g} units/s "
        f"tokens={adm.get('tokens', 0):g}/{adm.get('burst', 0):g} "
        f"waiting={adm.get('waiting', 0)}/{adm.get('maxQueue', 0)}"
    )
    print(
        f"host budget    : {host.get('inUseBytes', 0) / 1e6:.1f} / "
        f"{host.get('budgetBytes', 0) / 1e6:.1f} MB in use "
        f"(peak {host.get('peakBytes', 0) / 1e6:.1f} MB, "
        f"{host.get('reservations', 0)} reservation(s))"
    )
    print(f"active queries : {dog.get('activeQueries', 0)}")
    kills = dog.get("kills", [])
    for k in kills:
        print(
            f"  killed {k.get('queryId')} after {k.get('elapsedMs', 0):.1f} ms "
            f"({k.get('reservedBytes', 0) / 1e6:.1f} MB reserved): {k.get('reason')}"
        )
    print(f"-- {len(kills)} kill record(s)", file=sys.stderr)
    return 0


def cmd_election(args) -> int:
    """Print a serving endpoint's coordinator-HA view (GET /debug/election):
    current leader plus per-candidate lease/epoch/role state."""
    import urllib.request

    url = args.url.rstrip("/") + "/debug/election"
    with urllib.request.urlopen(url) as resp:
        payload = json.loads(resp.read().decode("utf-8"))
    if args.json:
        print(json.dumps(payload, indent=2))
        return 0
    print(f"leader  : {payload.get('leader') or '(none)'}")
    for c in payload.get("candidates", []):
        lease = c.get("lease")
        if lease is None:
            held = "no lease on disk"
        else:
            held = (
                f"lease holder={lease.get('holder')} epoch={lease.get('epoch')} "
                f"expires in {lease.get('expiresIn_s', 0):g} s"
            )
        flags = " PAUSED" if c.get("paused") else ""
        print(
            f"  {c.get('node')}: role={c.get('role')} epoch={c.get('epoch')} "
            f"journalSeq={c.get('journalSeq', '-')} ttl={c.get('ttl_s', 0):g}s "
            f"[{held}]{flags}"
        )
    print(f"-- {len(payload.get('candidates', []))} candidate(s)", file=sys.stderr)
    return 0


def cmd_autopilot(args) -> int:
    """Print a serving endpoint's SLO-autopilot view (GET /debug/autopilot):
    knob values vs clamp bounds, last N controller decisions with the
    triggering signal, per-table SLO state, and the knobChanges/ladderWalks
    counters."""
    import urllib.request

    url = args.url.rstrip("/") + "/debug/autopilot"
    with urllib.request.urlopen(url) as resp:
        payload = json.loads(resp.read().decode("utf-8"))
    if args.json:
        print(json.dumps(payload, indent=2))
        return 0
    if payload.get("enabled"):
        print(
            f"autopilot : ON  slo={payload.get('sloMs', 0):g} ms "
            f"tick={payload.get('tickS', 0):g} s ticks={payload.get('ticks', 0)} "
            f"cooldown={payload.get('cooldown', 0)} "
            f"running={payload.get('running', False)}"
        )
        bound = payload.get("changeBound", {})
        print(
            f"changes   : {payload.get('knobChanges', 0)} knob change(s), "
            f"{payload.get('ladderWalks', 0)} ladder walk(s) "
            f"(bound {bound.get('maxChanges', '-')}/{bound.get('windowTicks', '-')} ticks)"
        )
    else:
        print("autopilot : OFF (registry view only)")
    for name, k in sorted(payload.get("knobs", {}).items()):
        mark = "*" if k.get("overridden") else " "
        print(
            f"  {mark}{name:<18} = {k.get('value', 0):g}  "
            f"[{k.get('lo', 0):g} .. {k.get('hi', 0):g}]  "
            f"initial={k.get('initial', 0):g} degrade={k.get('degrade')}"
        )
    splits = payload.get("splits", {})
    if splits:
        shares = " ".join(f"{t}={f:.2f}" for t, f in sorted(splits.items()))
        print(f"  residency splits: {shares}")
    for t, st in sorted(payload.get("tables", {}).items()):
        p99 = st.get("p99_ms")
        p99s = f"{p99:.1f} ms" if p99 is not None else "-"
        print(f"  table {t}: {st.get('state', '?')} p99={p99s} qps={st.get('qps', 0):g}")
    decisions = payload.get("decisions", [])
    n = max(0, int(getattr(args, "last", 0) or 0)) or 10
    for d in decisions[-n:]:
        knob = f" {d.get('knob')}: {d.get('from')} -> {d.get('to')}" if d.get("knob") else ""
        sig = d.get("signal", {})
        p99 = sig.get("p99_ms")
        p99s = f"{p99:.1f}" if p99 is not None else "-"
        print(
            f"  tick {d.get('tick'):>4} {d.get('action', ''):<16}{knob}  "
            f"(p99={p99s} ms qps={sig.get('qps', 0):g})"
        )
    print(f"-- {len(decisions)} decision(s) recorded", file=sys.stderr)
    return 0


def cmd_perf(args) -> int:
    """Perf observatory view + bench-regression gate.

    Without --check: print a serving endpoint's per-table/per-shape perf
    ledger (GET /debug/perf) — rows/s, bytes/s, roofline %, compile ms,
    plan-cache hit rate, QPS.

    With --check: compare the newest record of --history against the
    pinned --baseline (utils/perf.check_regression) with a noise-aware
    threshold, exiting nonzero on a regression — the CI gate that turns
    BENCH files from write-only artifacts into enforcement."""
    from pinot_tpu_torch.utils import perf as perf_mod

    if args.check:
        history = perf_mod.load_bench_history(args.history)
        if not history:
            print(f"perf gate: no usable records in {args.history}", file=sys.stderr)
            return 1
        latest = history[-1]
        try:
            with open(args.baseline, "r", encoding="utf-8") as f:
                baseline = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"perf gate: cannot read baseline {args.baseline}: {e}", file=sys.stderr)
            return 1
        verdict = perf_mod.check_regression(latest, baseline, threshold=args.threshold)
        if args.json:
            print(json.dumps(verdict, indent=2))
        else:
            for c in verdict["checks"]:
                mark = "ok  " if c["ok"] else "FAIL"
                print(
                    f"{mark} {c['metric']:<28} baseline={c['baseline']:<14g} "
                    f"latest={c['latest']:<14g} drop={c['drop_pct']:+.2f}%"
                )
            for r in verdict["reasons"]:
                print(f"FAIL {r}")
            status = "PASS" if verdict["ok"] else "REGRESSION"
            print(
                f"perf gate: {status} (allowed drop {verdict['allowed_drop'] * 100:.1f}%)",
                file=sys.stderr,
            )
        return 0 if verdict["ok"] else 1

    import urllib.request

    url = args.url.rstrip("/") + "/debug/perf"
    with urllib.request.urlopen(url) as resp:
        payload = json.loads(resp.read().decode("utf-8"))
    if args.json:
        print(json.dumps(payload, indent=2))
        return 0
    tables = payload.get("tables", {})
    for table, t in sorted(tables.items()):
        print(f"table {table}: {t.get('queries', 0)} quer(y/ies), qps={t.get('qps', 0):g}")
        for fp, sh in sorted(t.get("shapes", {}).items()):
            rps = sh.get("rowsPerSec", {})
            roof = sh.get("rooflinePct", {})
            hit = sh.get("planCacheHitRate")
            print(
                f"  shape {fp}: n={sh.get('queries', 0)} "
                f"rows/s last={rps.get('last', 0):g} mean={rps.get('mean', 0):g} "
                f"roofline last={roof.get('last', 0):g}% "
                f"compileMs={sh.get('compileMsTotal', 0):g} "
                f"cacheHit={'n/a' if hit is None else f'{hit:.0%}'} "
                f"qps={sh.get('qps', 0):g}"
            )
    for name, cs in sorted(payload.get("caches", {}).items()):
        print(f"cache {name}: {cs.get('entries', 0)} entries, {cs.get('bytes', 0)} bytes")
    print(f"-- {len(tables)} table(s)", file=sys.stderr)
    return 0


def cmd_lint(args) -> int:
    """Static lint: per-file rules (analysis/repo_lint.py) plus the
    interprocedural passes (analysis/engine.py — race detector, sync
    auditor and lifecycle passes with baseline.json) over the
    pinot_tpu_torch tree; explicit paths run the per-file rules only.
    Exit 1 when findings exist so CI gates on it."""
    from pinot_tpu_torch.analysis.repo_lint import RULES, lint_paths

    stale = []
    baselined = 0
    if args.paths:
        findings = lint_paths(args.paths)
    else:
        from pinot_tpu_torch.analysis.engine import run_project

        report = run_project()
        findings = report.findings
        stale = report.stale_baseline
        baselined = report.baselined
    if args.json:
        payload = {
            "findings": [f.to_dict() for f in findings],
            "count": len(findings),
            "baselined": baselined,
            "staleBaseline": stale,
            "rules": {r: RULES[r] for r in sorted({f.rule for f in findings})},
        }
        mc_ok = True
        if not args.paths:
            # one machine-readable gate: fold a small-budget model-check
            # sweep (clean models only — the mutation matrix lives under
            # `cli mc`) into the lint report
            from pinot_tpu_torch.analysis.model_check import check_all

            mc = check_all(seed=0, max_schedules=8, mutations=False)
            mc_ok = mc["ok"]
            payload["modelCheck"] = mc
        print(json.dumps(payload, indent=2))
        return 1 if findings or stale or not mc_ok else 0
    for f in findings:
        print(f)
    for e in stale:
        print(f"stale baseline entry (fixed? delete it): {json.dumps(e)}")
    if findings and args.explain:
        print("\nrules:", file=sys.stderr)
        hit = {f.rule for f in findings}
        for rule in sorted(hit):
            print(f"  {rule}: {RULES.get(rule, '?')}", file=sys.stderr)
    suffix = f" ({baselined} baselined)" if baselined else ""
    print(f"{len(findings)} finding(s){suffix}", file=sys.stderr)
    return 1 if findings or stale else 0


def cmd_mc(args) -> int:
    """Deterministic-schedule concurrency model checker (analysis/
    model_check.py) over the registered protocol models.  Default run
    explores a seeded schedule budget per protocol; `--mutations` also
    requires every broken twin to be CAUGHT within the budget; `--replay
    trace.json` re-runs a captured failing schedule and verifies the
    failure reproduces bit-identically.  Exit 1 on any gate miss."""
    from pinot_tpu_torch.analysis.model_check import check_all, load_trace, replay, save_trace

    if args.replay:
        trace = load_trace(args.replay)
        want = trace["failure"]
        got = replay(trace)
        identical = got is not None and all(
            got[k] == want[k] for k in ("kind", "detail", "step", "schedule")
        )
        if args.json:
            print(json.dumps({"trace": trace, "reproduced": got, "identical": identical}, indent=2))
        elif identical:
            print(
                f"reproduced {trace['protocol']}"
                + (f"[{trace['mutation']}]" if trace.get("mutation") else "")
                + f": {got['kind']} at step {got['step']} — {got['detail']}"
            )
        else:
            print(f"trace did NOT reproduce: wanted {want!r}, got {got!r}", file=sys.stderr)
        return 0 if identical else 1

    protocols = args.protocols.split(",") if args.protocols else None
    report = check_all(
        seed=args.seed,
        max_schedules=args.schedules,
        mutations=args.mutations,
        protocols=protocols,
    )
    failing = []  # (protocol, mutation, failure) — clean failures first
    for name, entry in sorted(report["protocols"].items()):
        if entry["failure"] is not None:
            failing.insert(0, (name, None, entry["failure"]))
        for mut, res in sorted(entry.get("mutations", {}).items()):
            if res["failure"] is not None:
                failing.append((name, mut, res["failure"]))
    if args.save_trace and failing:
        name, mut, failure = failing[0]
        save_trace({"protocol": name, "mutation": mut, "failure": failure}, args.save_trace)
        print(f"trace saved: {args.save_trace} ({name}{f'[{mut}]' if mut else ''})", file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1
    for name, entry in sorted(report["protocols"].items()):
        status = "FAIL" if entry["failure"] else "ok"
        line = f"{name:10s} {status:4s} {entry['schedulesExplored']} schedule(s)"
        if entry["failure"]:
            f = entry["failure"]
            line += f" — {f['kind']} at step {f['step']}: {f['detail']}"
        print(line)
        for mut, res in sorted(entry.get("mutations", {}).items()):
            verdict = "caught" if res["caught"] else "MISSED"
            line = f"  twin {mut}: {verdict} ({res['schedulesExplored']} schedule(s))"
            if res["failure"]:
                f = res["failure"]
                line += f" — {f['kind']}: {f['detail']}"
            print(line)
    print(("all gates green" if report["ok"] else "GATE FAILED"), file=sys.stderr)
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pinot_tpu_torch", description="pinot_tpu_torch admin CLI")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("create-segment", help="CSV -> immutable segment directory")
    c.add_argument("--schema", required=True)
    c.add_argument("--csv", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--table-config")
    c.add_argument("--name")
    c.add_argument("--delimiter", default=",")
    c.set_defaults(fn=cmd_create_segment)

    q = sub.add_parser("query", help="run SQL over segment directories")
    q.add_argument("--segments", nargs="+", required=True)
    q.add_argument("--sql", required=True)
    q.add_argument("--device", help="torch device (default: the card)")
    q.set_defaults(fn=cmd_query)

    s = sub.add_parser("serve", help="HTTP query endpoint over segment directories")
    s.add_argument("--segments", nargs="+", required=True)
    s.add_argument("--port", type=int, default=8099)
    s.add_argument("--device", help="torch device (default: the card)")
    s.set_defaults(fn=cmd_serve)

    qs = sub.add_parser("quickstart", help="in-memory demo table + example queries")
    qs.add_argument("--device", help="torch device (default: the card)")
    qs.set_defaults(fn=cmd_quickstart)

    sq = sub.add_parser("slow-queries", help="print a serving endpoint's recent/slow query log")
    sq.add_argument("--url", default="http://127.0.0.1:8099", help="query server base URL")
    sq.add_argument("--limit", type=int, default=20)
    sq.add_argument("--json", action="store_true", help="dump raw entries as JSON")
    sq.set_defaults(fn=cmd_slow_queries)

    ad = sub.add_parser("admission", help="print a serving endpoint's overload-protection state")
    ad.add_argument("--url", default="http://127.0.0.1:8099", help="query server base URL")
    ad.add_argument("--json", action="store_true", help="dump the raw snapshot as JSON")
    ad.set_defaults(fn=cmd_admission)

    el = sub.add_parser("election", help="print a serving endpoint's coordinator-HA leadership view")
    el.add_argument("--url", default="http://127.0.0.1:8099", help="query server base URL")
    el.add_argument("--json", action="store_true", help="dump the raw snapshot as JSON")
    el.set_defaults(fn=cmd_election)

    ap = sub.add_parser("autopilot", help="print a serving endpoint's SLO-autopilot state")
    ap.add_argument("--url", default="http://127.0.0.1:8099", help="query server base URL")
    ap.add_argument("--last", type=int, default=10, help="controller decisions to print")
    ap.add_argument("--json", action="store_true", help="dump the raw snapshot as JSON")
    ap.set_defaults(fn=cmd_autopilot)

    pf = sub.add_parser("perf", help="perf ledger view + bench-regression gate")
    pf.add_argument("--url", default="http://127.0.0.1:8099", help="query server base URL")
    pf.add_argument("--json", action="store_true", help="dump the raw snapshot/verdict as JSON")
    pf.add_argument("--check", action="store_true", help="gate mode: compare bench history vs baseline")
    pf.add_argument("--history", help="bench history file (required with --check)")
    pf.add_argument("--baseline", help="pinned baseline record (required with --check)")
    pf.add_argument("--threshold", type=float, default=None, help="override allowed fractional drop (--check)")
    pf.set_defaults(fn=cmd_perf)

    lt = sub.add_parser("lint", help="torch-aware static lint over the pinot_tpu_torch tree")
    lt.add_argument("paths", nargs="*", help="python files to lint (default: the installed package)")
    lt.add_argument("--explain", action="store_true", help="print rule descriptions for findings")
    lt.add_argument("--json", action="store_true", help="machine-readable findings report")
    lt.set_defaults(fn=cmd_lint)

    mc = sub.add_parser("mc", help="deterministic-schedule concurrency model checker over the serving protocols")
    mc.add_argument("--seed", type=int, default=0, help="base RNG seed (schedule i uses seed+i)")
    mc.add_argument("--schedules", type=int, default=25, help="schedules explored per protocol/twin")
    mc.add_argument("--mutations", action="store_true", help="also require every broken twin to be caught")
    mc.add_argument("--protocols", default="", help="comma-separated protocol subset (default: all)")
    mc.add_argument("--replay", default="", metavar="TRACE_JSON", help="replay a captured failing trace; exit 0 iff it reproduces bit-identically")
    mc.add_argument("--save-trace", default="", metavar="PATH", help="write the first failing clean-model trace as replayable JSON")
    mc.add_argument("--json", action="store_true", help="machine-readable report")
    mc.set_defaults(fn=cmd_mc)

    args = p.parse_args(argv)
    if args.command == "perf" and args.check and not (args.history and args.baseline):
        p.error("perf --check needs --history and --baseline")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
