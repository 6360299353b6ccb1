"""Interprocedural analysis engine: whole-package project model + pass API.

Port of pinot_tpu/analysis/engine.py, aimed at the pinot_tpu_torch tree:
`Project.from_tree()` and `run_project()` default to this package, relative
paths are under `pinot_tpu_torch/`, and the baseline is this package's
`analysis/baseline.json`.

The per-file lint (repo_lint.py) sees one module at a time; the race
detector (races.py) and the host-device sync auditor (device_sync.py)
need the whole package — which class a method belongs to, what a call
resolves to, what a function returns.  This module builds that model:

  Project
    .modules    {dotted module name -> ModuleInfo (ast, imports, suppressions)}
    .functions  {qualified name -> FunctionInfo (top-level defs + methods)}
    .classes    {qualified name -> ClassInfo (methods, bases, lock attrs live
                 in races.py — the engine stays policy-free)}
    .resolve_call(fn_info, call_node) -> dotted target ("pinot_tpu_torch.x.C.m",
                 "time.sleep", "torch.nonzero") or None when unresolvable

Passes subclass `Pass` and implement run(project) -> [Finding].  The
runner (run_project) applies three filters before findings count:

  * inline `# pinot-lint: disable=W0xx` suppressions (same syntax the
    per-file rules honor),
  * the committed baseline (analysis/baseline.json): triaged pre-existing
    findings matched by (rule, path, symbol-or-line) with a one-line
    justification each — stale entries (matching nothing) are reported so
    the baseline can only shrink,
  * nothing else: anything left is a hard `cli lint` failure.
"""
from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pinot_tpu_torch.analysis.repo_lint import (
    Finding,
    is_suppressed,
    lint_source,
    parse_suppressions,
)

_THREADED_HINT_DIRS = ("cluster",)  # per-file threaded scope, as lint_paths


@dataclass
class ModuleInfo:
    relpath: str            # e.g. "pinot_tpu_torch/cluster/broker.py"
    name: str               # e.g. "pinot_tpu_torch.cluster.broker"
    tree: ast.Module
    source: str
    imports: Dict[str, str] = field(default_factory=dict)   # alias -> dotted
    suppressions: Dict[int, Optional[Set[str]]] = field(default_factory=dict)
    threaded: bool = False  # imports threading (directly)


@dataclass
class ClassInfo:
    qname: str              # "pinot_tpu_torch.cluster.broker.Broker"
    name: str
    module: ModuleInfo
    node: ast.ClassDef
    methods: Dict[str, "FunctionInfo"] = field(default_factory=dict)
    base_names: List[str] = field(default_factory=list)     # raw source names


@dataclass
class FunctionInfo:
    qname: str              # "...broker.Broker.route" or "...engine.run"
    name: str
    module: ModuleInfo
    node: ast.FunctionDef
    cls: Optional[ClassInfo] = None


def _module_imports(tree: ast.Module) -> Dict[str, str]:
    """Flat alias->dotted-name map, including function-local imports (the
    repo routinely imports inside functions to keep cold paths
    import-light)."""
    imports: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    imports[a.asname] = a.name
                else:
                    # `import torch.nn` binds `torch`; map the root name
                    root = a.name.split(".", 1)[0]
                    imports.setdefault(root, root)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                imports[a.asname or a.name] = f"{node.module}.{a.name}"
    return imports


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


class Project:
    """Symbol tables + call resolution over one package tree (or an
    in-memory fixture package — see from_sources, used by the tests)."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}

    # -- construction -----------------------------------------------------

    @classmethod
    def from_tree(cls, root: Optional[str] = None) -> "Project":
        """Build from a package directory (default: the installed pinot_tpu
        package, like repo_lint.lint_tree)."""
        if root is None:
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        pkg_parent = os.path.dirname(root)
        sources: Dict[str, str] = {}
        for dirpath, _dirnames, filenames in os.walk(root):
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fname)
                rel = os.path.relpath(full, pkg_parent)
                with open(full, "r", encoding="utf-8") as f:
                    sources[rel] = f.read()
        return cls.from_sources(sources)

    @classmethod
    def from_sources(cls, sources: Dict[str, str]) -> "Project":
        """Build from {relpath: source}.  relpaths use '/' separators and
        include the package directory ("pkg/cluster/broker.py")."""
        proj = cls()
        for relpath in sorted(sources):
            src = sources[relpath]
            norm = relpath.replace(os.sep, "/")
            try:
                tree = ast.parse(src)
            except SyntaxError:
                continue  # per-file lint reports E000; the model skips it
            modname = norm[:-3].replace("/", ".")
            if modname.endswith(".__init__"):
                modname = modname[: -len(".__init__")]
            mi = ModuleInfo(
                relpath=norm,
                name=modname,
                tree=tree,
                source=src,
                imports=_module_imports(tree),
                suppressions=parse_suppressions(src),
                threaded=any(
                    v == "threading"
                    or v.startswith("threading.")
                    or v == "pinot_tpu_torch.utils.threads"
                    or v.startswith("pinot_tpu_torch.utils.threads.")
                    for v in _module_imports(tree).values()
                ),
            )
            proj.modules[modname] = mi
            proj._index_module(mi)
        return proj

    def _index_module(self, mi: ModuleInfo) -> None:
        for node in mi.tree.body:
            if isinstance(node, _FUNC_NODES):
                qn = f"{mi.name}.{node.name}"
                self.functions[qn] = FunctionInfo(qn, node.name, mi, node)
            elif isinstance(node, ast.ClassDef):
                cq = f"{mi.name}.{node.name}"
                ci = ClassInfo(cq, node.name, mi, node)
                for base in node.bases:
                    if isinstance(base, ast.Name):
                        ci.base_names.append(base.id)
                    elif isinstance(base, ast.Attribute):
                        ci.base_names.append(base.attr)
                for sub in node.body:
                    if isinstance(sub, _FUNC_NODES):
                        fq = f"{cq}.{sub.name}"
                        fi = FunctionInfo(fq, sub.name, mi, sub, cls=ci)
                        ci.methods[sub.name] = fi
                        self.functions[fq] = fi
                self.classes[cq] = ci

    # -- resolution -------------------------------------------------------

    def resolve_name(self, mi: ModuleInfo, name: str) -> Optional[str]:
        """A bare Name in module `mi` -> dotted target (project symbol,
        project module, or external dotted name via imports)."""
        local = f"{mi.name}.{name}"
        if local in self.functions or local in self.classes:
            return local
        return mi.imports.get(name)

    def _base_method(self, ci: ClassInfo, attr: str) -> Optional[str]:
        """Look up `attr` on ci's bases (single level, by source name —
        enough for the repo's shallow hierarchies)."""
        for bname in ci.base_names:
            target = self.resolve_name(ci.module, bname)
            base = self.classes.get(target or "")
            if base is None:
                continue
            if attr in base.methods:
                return base.methods[attr].qname
            deeper = self._base_method(base, attr)
            if deeper:
                return deeper
        return None

    def resolve_call(self, fi: FunctionInfo, call: ast.Call) -> Optional[str]:
        """Resolve a Call node to a dotted name.  Project symbols resolve
        to their qualified name ("pkg.mod.Class.method"); known imports
        resolve to external dotted names ("time.sleep", "torch.nonzero");
        everything else (locals, unknown object attributes) returns None."""
        return self.resolve_expr(fi, call.func)

    def resolve_expr(self, fi: FunctionInfo, f: ast.AST) -> Optional[str]:
        mi = fi.module
        if isinstance(f, ast.Name):
            return self.resolve_name(mi, f.id)
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name):
                if base.id == "self" and fi.cls is not None:
                    if f.attr in fi.cls.methods:
                        return fi.cls.methods[f.attr].qname
                    inherited = self._base_method(fi.cls, f.attr)
                    if inherited:
                        return inherited
                    return None  # self.<data attr>(...) — not a method
                root = self.resolve_name(mi, base.id)
                if root is not None:
                    return f"{root}.{f.attr}"
                return None
            if isinstance(base, ast.Attribute):
                inner = self.resolve_expr(fi, base)
                if inner is not None:
                    return f"{inner}.{f.attr}"
        return None

    def class_of(self, qname: str) -> Optional[ClassInfo]:
        fi = self.functions.get(qname)
        return fi.cls if fi else None


# -- pass API -------------------------------------------------------------


class Pass:
    """One interprocedural rule family.  Subclasses set `name` and
    implement run()."""

    name = "pass"

    def run(self, project: Project) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


def default_passes() -> List[Pass]:
    from pinot_tpu_torch.analysis.device_sync import DeviceSyncPass
    from pinot_tpu_torch.analysis.lifecycle import ConditionDisciplinePass, LifecyclePass
    from pinot_tpu_torch.analysis.races import RacePass

    return [RacePass(), DeviceSyncPass(), LifecyclePass(), ConditionDisciplinePass()]


# -- baseline -------------------------------------------------------------

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def load_baseline(path: Optional[str] = None) -> List[Dict[str, object]]:
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return list(data.get("suppressions", []))


def _baseline_matches(entry: Dict[str, object], f: Finding) -> bool:
    if entry.get("rule") != f.rule:
        return False
    if not str(f.path).endswith(str(entry.get("path", ""))):
        return False
    # symbol match is preferred (robust to line drift); line is the fallback
    sym = entry.get("symbol")
    if sym:
        return sym == f.symbol
    return entry.get("line") == f.line


def apply_baseline(
    findings: List[Finding], baseline: List[Dict[str, object]]
) -> Tuple[List[Finding], int, List[Dict[str, object]]]:
    """Returns (kept findings, #baselined, stale entries that matched
    nothing — a stale baseline means the bug was fixed: delete the entry)."""
    used = [False] * len(baseline)
    kept: List[Finding] = []
    baselined = 0
    for f in findings:
        hit = False
        for i, entry in enumerate(baseline):
            if _baseline_matches(entry, f):
                used[i] = True
                hit = True
        if hit:
            baselined += 1
        else:
            kept.append(f)
    stale = [e for i, e in enumerate(baseline) if not used[i]]
    return kept, baselined, stale


# -- runner ---------------------------------------------------------------


@dataclass
class AnalysisReport:
    findings: List[Finding]
    baselined: int = 0
    stale_baseline: List[Dict[str, object]] = field(default_factory=list)
    per_file_count: int = 0
    interprocedural_count: int = 0


def run_passes(project: Project, passes: Optional[Iterable[Pass]] = None) -> List[Finding]:
    """Run interprocedural passes only (no per-file lint, no baseline) —
    the raw-findings entry point the fixture tests use."""
    out: List[Finding] = []
    for p in passes if passes is not None else default_passes():
        out.extend(p.run(project))
    # inline suppressions are honored even on the raw path
    by_rel = {mi.relpath: mi for mi in project.modules.values()}
    kept = []
    for f in out:
        mi = by_rel.get(f.path)
        if mi is not None and is_suppressed(f, mi.suppressions):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept


def run_project(
    root: Optional[str] = None,
    passes: Optional[Iterable[Pass]] = None,
    baseline_path: Optional[str] = None,
) -> AnalysisReport:
    """Full `cli lint` pipeline: per-file rules + interprocedural passes,
    inline suppressions, then the committed baseline."""
    project = Project.from_tree(root)
    per_file: List[Finding] = []
    for mi in project.modules.values():
        threaded = any(f"/{d}/" in f"/{mi.relpath}" for d in _THREADED_HINT_DIRS)
        per_file.extend(lint_source(mi.source, path=mi.relpath, threaded=threaded))
    inter = run_passes(project, passes)
    findings = sorted(per_file + inter, key=lambda f: (f.path, f.line, f.rule))
    baseline = load_baseline(baseline_path)
    findings, baselined, stale = apply_baseline(findings, baseline)
    return AnalysisReport(
        findings=findings,
        baselined=baselined,
        stale_baseline=stale,
        per_file_count=len(per_file),
        interprocedural_count=len(inter),
    )
