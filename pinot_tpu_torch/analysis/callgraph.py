"""Call graph over a Project (analysis/engine.py).

Port of pinot_tpu/analysis/callgraph.py (the same graph).

Edges connect project functions ("pkg.mod.Class.method" -> callee qname);
calls that resolve to names outside the project (time.sleep,
torch.nonzero, urllib.request.urlopen) are kept separately in
`external` — the race and sync passes classify those by dotted name.
Instantiating a project class adds an edge to its __init__ (so
"reachable from a threaded module" follows construction).

Each edge remembers its call-site lines: the deadlock and
blocking-under-lock rules report the line the cycle/block enters at,
not just the pair of functions.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pinot_tpu_torch.analysis.engine import FunctionInfo, Project


@dataclass
class CallGraph:
    project: Project
    # caller qname -> {callee qname -> [call-site lines]}
    edges: Dict[str, Dict[str, List[int]]] = field(default_factory=dict)
    # caller qname -> {external dotted name -> [call-site lines]}
    external: Dict[str, Dict[str, List[int]]] = field(default_factory=dict)

    @classmethod
    def build(cls, project: Project) -> "CallGraph":
        g = cls(project)
        for fi in project.functions.values():
            g.edges[fi.qname] = {}
            g.external[fi.qname] = {}
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                target = project.resolve_call(fi, node)
                if target is None:
                    continue
                target = g._normalize(target)
                if target in project.functions:
                    g.edges[fi.qname].setdefault(target, []).append(node.lineno)
                else:
                    g.external[fi.qname].setdefault(target, []).append(node.lineno)
        return g

    def _normalize(self, target: str) -> str:
        """Class instantiation -> its __init__ when the project defines one."""
        if target in self.project.classes:
            init = f"{target}.__init__"
            if init in self.project.functions:
                return init
        return target

    # -- queries ----------------------------------------------------------

    def callees(self, qname: str) -> Iterable[str]:
        return self.edges.get(qname, {})

    def call_sites(self, caller: str, callee: str) -> List[int]:
        return self.edges.get(caller, {}).get(callee, [])

    def reachable_from(self, roots: Iterable[str]) -> Set[str]:
        """Transitive closure of project functions reachable from roots."""
        seen: Set[str] = set()
        stack = [r for r in roots if r in self.edges]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(c for c in self.edges.get(cur, {}) if c not in seen)
        return seen

    def transitive_external(self, qname: str, _seen: Optional[Set[str]] = None) -> Set[str]:
        """External dotted names reachable from qname (through project
        calls) — used to decide whether a call chain ends in a blocker."""
        seen = _seen if _seen is not None else set()
        if qname in seen:
            return set()
        seen.add(qname)
        out = set(self.external.get(qname, {}))
        for callee in self.edges.get(qname, {}):
            out |= self.transitive_external(callee, seen)
        return out


def function_lines(fi: FunctionInfo) -> Tuple[int, int]:
    """(start, end) line span of a function body."""
    end = getattr(fi.node, "end_lineno", None) or fi.node.lineno
    return fi.node.lineno, end
