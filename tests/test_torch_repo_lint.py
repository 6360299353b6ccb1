"""The port's per-file lint (pinot_tpu_torch.analysis.repo_lint) against the
JAX package's.

* Every fixture of tests/test_repo_lint.py (read from its AST by
  tests/torch_analysis_parity.py) goes through both packages'
  `lint_source`: the (rule, line) pairs of the status-(a) rules — same
  meaning, same code — must be equal.
* Each status-(b) rule, retargeted to torch, has a torch true positive
  and a clean negative.
* Each status-(c) rule (no torch object) stays silent, on the JAX
  fixtures that fire it and on torch code.
* The rule table: the same IDs as the JAX package, each with a status in
  the module docstring, copied into README.md; the live port tree is
  clean."""
import re
import textwrap
from pathlib import Path

import pytest

from torch_analysis_parity import (
    STATUS_A,
    STATUS_B,
    STATUS_C,
    lint_fixtures,
    port_source,
    status_a_pairs,
)

import pinot_tpu.analysis.repo_lint as jax_lint
import pinot_tpu_torch.analysis.repo_lint as port_lint

FIXTURES = lint_fixtures("test_repo_lint.py")
ROOT = Path(__file__).resolve().parents[1]


def _rules(src, threaded=False, path="fixture.py"):
    return [f.rule for f in port_lint.lint_source(textwrap.dedent(src), path=path, threaded=threaded)]


@pytest.mark.parametrize("src,path,threaded", [f[1:] for f in FIXTURES], ids=[f[0] for f in FIXTURES])
def test_status_a_rules_match_jax(src, path, threaded):
    want = status_a_pairs(jax_lint.lint_source(src, path=path, threaded=threaded))
    got = status_a_pairs(port_lint.lint_source(port_source(src), path=path, threaded=threaded))
    assert got == want


def test_fixtures_cover_every_status_a_rule():
    fired = {f.rule for _id, src, path, threaded in FIXTURES
             for f in jax_lint.lint_source(src, path=path, threaded=threaded)}
    assert STATUS_A <= fired


# -- status (c): no torch object ----------------------------------------------

C_FIXTURES = [f for f in FIXTURES
              if {x.rule for x in jax_lint.lint_source(f[1], path=f[2], threaded=f[3])} & set(STATUS_C)]


@pytest.mark.parametrize("src,path,threaded", [f[1:] for f in C_FIXTURES], ids=[f[0] for f in C_FIXTURES])
def test_status_c_rules_silent_on_the_jax_fixtures_that_fire_them(src, path, threaded):
    got = {f.rule for f in port_lint.lint_source(src, path=path, threaded=threaded)}
    assert not got & set(STATUS_C)


def test_status_c_rules_silent_on_torch_code():
    src = """
    import torch

    def run(fn, batches):
        outs = []
        for x in batches:
            f = torch.compile(fn)
            outs.append(f(x).to(torch.int64))
        return outs

    def unpack(packed_words, bits):
        return (packed_words.to(torch.int32) >> bits) & 255
    """
    assert _rules(src) == []


def test_c_rules_keep_their_ids():
    for rule in STATUS_C:
        assert rule in port_lint.RULES and "reports nothing on the port" in port_lint.RULES[rule]


# -- status (b): retargeted to torch ------------------------------------------

B_CASES = {
    "W001": [
        ("""
        import torch

        def body(x):
            return x * 0.5

        fb = torch.func.vmap(body)
        """, ["W001"]),
        ("""
        def fused_group_tables_reference(codes, n):
            return codes > 1.5
        """, ["W001"]),
        ("""
        import torch

        def helper(x):
            return x * 0.5  # not vmapped, not a plain version

        def body(x):
            return x * 2

        fb = torch.func.vmap(body)
        """, []),
    ],
    "W002": [
        ("""
        import torch
        from torch.func import vmap

        @vmap
        def body(x):
            n = x.sum().item()
            return x + n
        """, ["W002"]),
        ("""
        import torch

        def run(fn, batches):
            outs = []
            for b in batches:
                outs.append(fn(b))
                torch.cuda.synchronize()
            return outs
        """, ["W002"]),
        ("""
        import torch

        def run(fn, batches):
            outs = [fn(b) for b in batches]
            torch.cuda.synchronize()  # one fence after the loop
            return [o.cpu() for o in outs]

        def scan_runs_reference(x):
            return int(x.sum().item())  # a plain version runs eagerly
        """, []),
    ],
    "W017": [
        ("""
        import time
        from pinot_tpu_torch.ops.fused_scan import fused_group_tables

        def bench(entries, codes, g):
            t0 = time.perf_counter()
            out = fused_group_tables(entries, codes, g)
            return out, time.perf_counter() - t0
        """, ["W017"]),
        ("""
        import time
        import torch
        from pinot_tpu_torch.ops import funnel_scan

        def bench(args):
            t0 = time.monotonic()
            funnel_scan.funnel_reach(*args)
            dt = time.monotonic() - t0
            return dt
        """, ["W017"]),
        ("""
        import time
        import torch
        from pinot_tpu_torch.ops import funnel_scan

        def bench(args, plan, x):
            t0 = time.perf_counter()
            funnel_scan.funnel_reach(*args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t1 = time.perf_counter()
            host = funnel_scan.scan_runs(*args).cpu()
            dt1 = time.perf_counter() - t1
            t2 = time.perf_counter()
            plan.fn(x)  # host dispatch cost: out of scope
            dt2 = time.perf_counter() - t2
            return dt, host, dt1, dt2
        """, []),
    ],
    "W018": [
        ("""
        class MicroBatcher:
            def _flush(self, group):
                out = self.runner(group)
                return out.sum().item()
        """, ["W018"]),
        ("""
        import torch

        def dispatch_loop(q):
            while q:
                q.pop()()
                torch.cuda.synchronize()
        """, ["W018"]),
        ("""
        class MicroBatcher:
            def _worker(self):
                with self._cv:
                    self._cv.wait(timeout=0.01)

        def collect(out):
            return out.cpu()  # outside the dispatch path
        """, []),
    ],
    "W021": [
        ("""
        def run(seg, dev):
            codes = seg.column("x").codes
            return codes.to(dev)
        """, ["W021"]),
        ("""
        import torch

        def run(values, device):
            return torch.as_tensor(values, device=device)
        """, ["W021"]),
        ("""
        import torch

        def to_device(seg, dev):
            return seg.packed.to(dev)  # the staging path itself

        def run(codes, literals, dev):
            c = codes.to(torch.int32)  # a dtype cast, not a copy
            return c, torch.as_tensor(literals, device=dev)
        """, []),
    ],
    "W025": [
        ("""
        from pinot_tpu_torch.parallel import mesh as mesh_mod

        def build(devs):
            return mesh_mod.Mesh(devs, ("seg",))
        """, ["W025"]),
        ("""
        from pinot_tpu_torch.parallel.mesh import default_mesh

        def build():
            return default_mesh(axis="replica")
        """, ["W025"]),
        ("""
        from pinot_tpu_torch.parallel import mesh as mesh_mod

        def build(devs, axes):
            a = mesh_mod.Mesh(devs, (mesh_mod.SEG_AXIS,))
            b = mesh_mod.Mesh(devs, axes)
            return a, b, mesh_mod.normalize_axes(mesh_mod.DATA_AXES)
        """, []),
    ],
}
B_PARAMS = [(rule, i, src, want) for rule, cases in B_CASES.items() for i, (src, want) in enumerate(cases)]


@pytest.mark.parametrize("rule,i,src,want", B_PARAMS, ids=[f"{p[0]}[{p[1]}]" for p in B_PARAMS])
def test_status_b_rule_on_torch(rule, i, src, want):
    threaded = rule == "W018"
    got = [r for r in _rules(src, threaded=threaded) if r == rule]
    assert got == want


@pytest.mark.parametrize("rule", STATUS_B)
def test_every_b_rule_has_a_true_positive_and_a_clean_negative(rule):
    wants = [want for _src, want in B_CASES[rule]]
    assert [rule] in wants and [] in wants


def test_w025_exempt_inside_parallel_mesh():
    src = """
    def default_mesh(devs):
        return Mesh(devs, ("seg",))
    """
    assert _rules(src, path="pinot_tpu_torch/parallel/mesh.py") == []


def test_w021_exempt_inside_the_staging_files():
    src = """
    def copy(codes, dev):
        return codes.to(dev)
    """
    assert _rules(src, path="pinot_tpu_torch/parallel/staging.py") == []
    assert _rules(src, path="pinot_tpu_torch/segment/residency.py") == []
    assert _rules(src, path="pinot_tpu_torch/query/executor.py") == ["W021"]


def test_w018_is_threaded_scope_only():
    src = """
    class MicroBatcher:
        def _flush(self, out):
            return out.item()
    """
    assert _rules(src, threaded=False) == []


# -- the rule table -----------------------------------------------------------

TABLE_ROW = re.compile(r"^\s*\| (W\d{3}) \| \(([abc])\) \| (.+) \|$")


def _table(text):
    return {m.group(1): (m.group(2), m.group(3)) for m in map(TABLE_ROW.match, text.splitlines()) if m}


def test_rule_ids_are_the_jax_packages():
    assert set(port_lint.RULES) == set(jax_lint.RULES)


def test_docstring_table_gives_each_per_file_rule_a_status():
    table = _table(port_lint.__doc__)
    per_file = {r for r in port_lint.RULES if r not in ("W010", "W011", "W012", "W013", "W014", "W023", "W024")}
    assert set(table) == per_file
    assert {r for r, (s, _) in table.items() if s == "a"} == STATUS_A - {"E000"}
    assert {r for r, (s, _) in table.items() if s == "b"} == set(STATUS_B)
    assert {r for r, (s, _) in table.items() if s == "c"} == set(STATUS_C)


def test_readme_copies_the_table():
    assert _table((ROOT / "README.md").read_text()) == _table(port_lint.__doc__)


def test_live_port_tree_is_clean():
    findings = port_lint.lint_tree()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_finding_format_matches_jax():
    args = ("a/b.py", 12, "W010", "msg")
    assert str(port_lint.Finding(*args, hint="h")) == str(jax_lint.Finding(*args, hint="h"))
    assert port_lint.Finding(*args).to_dict() == jax_lint.Finding(*args).to_dict()
    assert port_lint.lint_source("def broken(:\n", path="x.py")[0].rule == "E000"
