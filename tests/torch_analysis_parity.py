"""Shared helpers for the analysis parity tests (test_torch_repo_lint.py,
test_torch_analysis_engine.py, test_torch_analysis_races.py,
test_torch_analysis_lifecycle.py): the JAX package's own analysis tests
are the fixtures, and every fixture goes through both packages.

Two ways in:

* `lint_fixtures(file)` reads a JAX lint test file's AST and returns every
  `_rules(src)` / `_lint(src)` / `lint_source(...)` call's source, path and
  `threaded` flag (the value of `src` assigned last before the call), so a
  test can parametrise over the fixtures without running the JAX tests.
* `run_with_parity(module, test_id, request)` runs one JAX test with the
  names it imported from pinot_tpu.analysis swapped for shims.  Each shim
  calls the JAX object, builds the port's counterpart from the same
  sources (`pinot_tpu.` spelled `pinot_tpu_torch.`), and records the pair
  of results; the JAX test's own assertions run on the JAX results.
"""
import ast
import importlib
import inspect
import textwrap
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import pinot_tpu.analysis.callgraph as jcg
import pinot_tpu.analysis.engine as jeng
import pinot_tpu.analysis.lifecycle as jlife
import pinot_tpu.analysis.races as jraces
import pinot_tpu.analysis.repo_lint as jlint
import pinot_tpu_torch.analysis.callgraph as pcg
import pinot_tpu_torch.analysis.engine as peng
import pinot_tpu_torch.analysis.lifecycle as plife
import pinot_tpu_torch.analysis.races as praces
import pinot_tpu_torch.analysis.repo_lint as plint

TESTS = Path(__file__).resolve().parent

# the per-file rules whose meaning and code are the JAX package's (status
# (a) of the port's repo_lint table), plus the syntax-error finding
STATUS_A = frozenset(
    {"W004", "W005", "W006", "W007", "W008", "W015", "W016", "W019", "W022", "W026", "E000"}
)
STATUS_B = ("W001", "W002", "W017", "W018", "W021", "W025")
STATUS_C = ("W003", "W020")


def port_source(src: str) -> str:
    """The fixture as the port reads it: imports of the JAX package name the
    port's modules (the seam `pinot_tpu.utils.threads`, say)."""
    return src.replace("pinot_tpu.", "pinot_tpu_torch.")


def port_name(name: Optional[str]) -> Optional[str]:
    return None if name is None else name.replace("pinot_tpu.", "pinot_tpu_torch.")


# -- per-file fixtures read from a test file's AST ------------------------


def _const_str(node: ast.AST, env: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "dedent"
        and node.args
    ):
        inner = _const_str(node.args[0], env)
        return None if inner is None else textwrap.dedent(inner)
    return None


def _kw(call: ast.Call, name: str, default: Any) -> Any:
    for k in call.keywords:
        if k.arg == name and isinstance(k.value, ast.Constant):
            return k.value.value
    return default


def _calls_in_order(fn: ast.FunctionDef):
    """(call, env) for every lint call in the body, env holding each name's
    last string assignment before the call."""
    env: Dict[str, str] = {}
    for stmt in fn.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                yield node, dict(env)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Name):
            val = _const_str(stmt.value, env)
            if val is not None:
                env[stmt.targets[0].id] = val


def lint_fixtures(filename: str) -> List[Tuple[str, str, str, bool]]:
    """[(id, source, path, threaded)] for each per-file lint call of the
    JAX test file `filename` (under tests/)."""
    tree = ast.parse((TESTS / filename).read_text())
    out: List[Tuple[str, str, str, bool]] = []
    fns: List[Tuple[str, ast.FunctionDef]] = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            fns += [(f"{node.name}::{f.name}", f) for f in node.body
                    if isinstance(f, ast.FunctionDef) and f.name.startswith("test")]
        elif isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
            fns.append((node.name, node))
    for name, fn in fns:
        n = 0
        for call, env in _calls_in_order(fn):
            f = call.func
            fname = f.id if isinstance(f, ast.Name) else None
            if fname in ("_rules", "_lint") and call.args:
                src = _const_str(call.args[0], env)
                if src is None:
                    continue
                out.append((f"{name}[{n}]", textwrap.dedent(src), "fixture.py", bool(_kw(call, "threaded", False))))
            elif fname == "lint_source" and call.args:
                src = _const_str(call.args[0], env)
                if src is None:
                    continue
                path = _kw(call, "path", call.args[1].value if len(call.args) > 1 and isinstance(
                    call.args[1], ast.Constant) else "<string>")
                out.append((f"{name}[{n}]", src, path, bool(_kw(call, "threaded", False))))
            else:
                continue
            n += 1
    return out


def jax_test_ids(filename: str) -> List[str]:
    """"Class::method" or "function" of each test in a JAX test file."""
    tree = ast.parse((TESTS / filename).read_text())
    names: List[str] = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            names += [f"{node.name}::{f.name}" for f in node.body
                      if isinstance(f, ast.FunctionDef) and f.name.startswith("test")]
        elif isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
            names.append(node.name)
    return names


def pairs(findings) -> List[Tuple[str, int]]:
    return sorted((f.rule, f.line) for f in findings)


def status_a_pairs(findings) -> List[Tuple[str, int]]:
    return [p for p in pairs(findings) if p[0] in STATUS_A]


# -- shims: run a JAX test, compare each analysis result with the port's ----


class Recorder:
    """The compared pairs of one JAX test run."""

    def __init__(self, drop_rules=()):
        self.drop_rules = set(drop_rules)  # JAX-only findings (a blocker torch has not)
        self.compared: List[str] = []
        self.mismatches: List[str] = []

    def check(self, what: str, jax_value, port_value) -> None:
        self.compared.append(what)
        if jax_value != port_value:
            self.mismatches.append(f"{what}: jax {jax_value!r} != port {port_value!r}")


def _findings_key(findings, drop=()) -> List[Tuple[str, str, int, str]]:
    return sorted(
        (port_name(f.path) or "", f.rule, f.line, f.symbol) for f in findings if f.rule not in drop
    )


def _port_pass(p):
    cls = {
        jraces.RacePass: praces.RacePass,
        jlife.LifecyclePass: plife.LifecyclePass,
        jlife.ConditionDisciplinePass: plife.ConditionDisciplinePass,
    }[type(p)]
    q = cls.__new__(cls)
    q.__dict__.update(p.__dict__)
    return q


def _same_node(tree: ast.AST, node: ast.AST) -> ast.AST:
    """The node of `tree` at `node`'s position and of its type."""
    for n in ast.walk(tree):
        if (
            type(n) is type(node)
            and getattr(n, "lineno", None) == node.lineno
            and getattr(n, "col_offset", None) == node.col_offset
        ):
            return n
    raise LookupError(f"no {type(node).__name__} at {node.lineno}:{node.col_offset}")


def make_shims(rec: Recorder) -> Dict[str, Any]:
    """Drop-in replacements for the names a JAX analysis test imports."""

    class ProjectShim:
        @classmethod
        def from_sources(cls, sources):
            jp = jeng.Project.from_sources(sources)
            pp = peng.Project.from_sources({k: port_source(v) for k, v in sources.items()})
            rec.check("modules", sorted(jp.modules), sorted(pp.modules))
            rec.check("functions", sorted(jp.functions), sorted(pp.functions))
            rec.check("classes", sorted(jp.classes), sorted(pp.classes))
            rec.check("threaded", sorted(n for n, m in jp.modules.items() if m.threaded),
                      sorted(n for n, m in pp.modules.items() if m.threaded))
            return _ProjectProxy(jp, pp, rec)

    class CallGraphShim:
        @classmethod
        def build(cls, project):
            jp, pp = project._jp, project._pp
            jg, pg = jcg.CallGraph.build(jp), pcg.CallGraph.build(pp)
            rec.check("edges", {k: {c: v for c, v in e.items()} for k, e in jg.edges.items()},
                      {k: {c: v for c, v in e.items()} for k, e in pg.edges.items()})
            rec.check("external", {k: {port_name(c): v for c, v in e.items()} for k, e in jg.external.items()},
                      {k: dict(e) for k, e in pg.external.items()})
            return jg

    def run_passes(project, passes=None):
        jp, pp = project._jp, project._pp
        passes = list(passes) if passes is not None else None
        jout = jeng.run_passes(jp, passes)
        pout = peng.run_passes(pp, [_port_pass(p) for p in passes] if passes is not None else None)
        rec.check("run_passes", _findings_key(jout, rec.drop_rules), _findings_key(pout))
        return jout

    def lint_source(src, path="<string>", threaded=False):
        jout = jlint.lint_source(src, path=path, threaded=threaded)
        pout = plint.lint_source(port_source(src), path=path, threaded=threaded)
        rec.check("lint_source", status_a_pairs(jout), status_a_pairs(pout))
        return jout

    def apply_baseline(findings, baseline):
        kept, n, stale = jeng.apply_baseline(findings, baseline)
        pk, pn, pstale = peng.apply_baseline([plint.Finding(**f.to_dict()) for f in findings], baseline)
        rec.check("apply_baseline", ([f.to_dict() for f in kept], n, stale), ([f.to_dict() for f in pk], pn, pstale))
        return kept, n, stale

    def Finding(*args, **kwargs):
        jf, pf = jlint.Finding(*args, **kwargs), plint.Finding(*args, **kwargs)
        rec.check("Finding", (str(jf), jf.to_dict()), (str(pf), pf.to_dict()))
        return jf

    return {
        "Project": ProjectShim,
        "CallGraph": CallGraphShim,
        "run_passes": run_passes,
        "lint_source": lint_source,
        "apply_baseline": apply_baseline,
        "Finding": Finding,
    }


class _ProjectProxy:
    """The JAX Project as the test sees it; resolve_call also asks the
    port's project about the same call."""

    def __init__(self, jp, pp, rec: Recorder):
        self._jp, self._pp, self._rec = jp, pp, rec

    def __getattr__(self, name):
        return getattr(self._jp, name)

    def resolve_call(self, fi, call):
        got = self._jp.resolve_call(fi, call)
        pfi = self._pp.functions[fi.qname]
        self._rec.check(f"resolve_call@{call.lineno}", port_name(got),
                        self._pp.resolve_call(pfi, _same_node(pfi.node, call)))
        return got


def run_with_parity(module: str, test_id: str, request, drop_rules=()) -> Recorder:
    """Run the JAX test `test_id` of tests/`module`.py with the shims in
    place; returns the recorder (the JAX test's assertions have passed)."""
    mod = importlib.import_module(module)
    rec = Recorder(drop_rules)
    mp = request.getfixturevalue("monkeypatch")
    for name, shim in make_shims(rec).items():
        if hasattr(mod, name):
            mp.setattr(mod, name, shim)
    cls_name, _, meth = test_id.partition("::")
    fn = getattr(getattr(mod, cls_name)(), meth) if meth else getattr(mod, cls_name)
    kwargs = {p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters}
    fn(**kwargs)
    return rec
