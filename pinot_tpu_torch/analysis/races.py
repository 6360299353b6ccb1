"""Lock-discipline race detector (W010/W011/W012) over a Project.

Port of pinot_tpu/analysis/races.py.  The lock constructors are
`threading.*` and the port's seam `pinot_tpu_torch.utils.threads.*`; W012's
blockers are the torch ones (below) in place of jax.device_put /
device_get / block_until_ready.

Guard inference is per class: an attribute written under `with
self.<lock>:` in any method is lock-guarded, and every other read or
write of it must hold the same lock (W010).  Three refinements keep the
repo's real conventions from flooding the report:

  * `__init__` is construction context — single-threaded by contract —
    and so are private helpers whose only call sites are `__init__`
    (e.g. realtime manager `_recover_partition`).
  * a method whose every project-wide call site sits inside a locked
    region of the same class is a "locked method" (`*_locked`
    convention: `_evict_locked`, `_publish_size_locked`); its whole body
    counts as holding that lock.
  * only classes reachable from threaded contexts are checked: classes
    in the modules that import `threading`, plus anything their
    functions (REST/scatter handlers included) transitively call.

W011 builds a lock-order graph — node (class, lock attr), edge when a
locked region transitively reaches another acquisition — and reports
strongly-connected components (ABBA deadlocks) plus same-lock
re-acquisition through a call chain when the lock is a non-reentrant
`threading.Lock` (self-deadlock).

W012 flags calls that can block the lock holder: `time.sleep`,
`torch.cuda.synchronize()` and an event's or stream's `.synchronize()`,
a host read of a tensor (`.item()` / `.tolist()` / `.cpu()`), a
`.to(device)` copy, socket/HTTP — directly in a locked region or through
a project call chain.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from pinot_tpu_torch.analysis.callgraph import CallGraph
from pinot_tpu_torch.analysis.engine import ClassInfo, FunctionInfo, Pass, Project
from pinot_tpu_torch.analysis.repo_lint import Finding, _w021_device_arg

BLOCKING_EXTERNAL = {
    "time.sleep",
    "torch.cuda.synchronize",
    "urllib.request.urlopen",
    "socket.create_connection",
    "socket.socket",
}
# `.synchronize()` is torch.cuda.Event / torch.cuda.Stream's; `.item()`,
# `.tolist()` and `.cpu()` of a CUDA tensor wait for the card (W013's
# sinks); `.to(...)` counts only with a device target (_is_device_copy)
BLOCKING_ATTRS = {
    "synchronize", "item", "tolist", "cpu",
    "urlopen", "recv", "sendall", "connect", "getresponse",
}

_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "add", "discard", "update", "setdefault", "move_to_end", "appendleft",
}

_NON_REENTRANT_CTORS = {"threading.Lock", "pinot_tpu_torch.utils.threads.Lock"}
_REENTRANT_CTORS = {
    "threading.RLock",
    "threading.Condition",
    "pinot_tpu_torch.utils.threads.RLock",
    "pinot_tpu_torch.utils.threads.Condition",
}


def _is_device_copy(call: ast.Call) -> bool:
    """`x.to(device)` — a host<->device copy, not a dtype cast."""
    return (
        isinstance(call.func, ast.Attribute)
        and call.func.attr == "to"
        and _w021_device_arg(call)
    )


def _attr_blocker(call: ast.Call) -> Optional[str]:
    """`.<blocker>()` for a blocking method call on a non-literal receiver."""
    if not isinstance(call.func, ast.Attribute) or isinstance(call.func.value, ast.Constant):
        return None
    if call.func.attr in BLOCKING_ATTRS or _is_device_copy(call):
        return f".{call.func.attr}()"
    return None


def _self_attr_name(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


@dataclass
class LockRegion:
    lock: str
    start: int
    end: int

    def covers(self, line: int) -> bool:
        return self.start <= line <= self.end


@dataclass
class ClassLockModel:
    """Everything the three rules need to know about one class."""

    info: ClassInfo
    lock_attrs: Dict[str, Optional[bool]] = field(default_factory=dict)  # name -> reentrant?
    regions: Dict[str, List[LockRegion]] = field(default_factory=dict)   # method -> regions
    locked_methods: Dict[str, Set[str]] = field(default_factory=dict)    # method -> held locks
    init_only: Set[str] = field(default_factory=set)
    guards: Dict[str, Set[str]] = field(default_factory=dict)            # attr -> guarding locks

    def locks_at(self, method: str, line: int) -> Set[str]:
        held = set(self.locked_methods.get(method, ()))
        for r in self.regions.get(method, ()):
            if r.covers(line):
                held.add(r.lock)
        return held


def _ctor_reentrancy(project: Project, fi: FunctionInfo, value: ast.AST) -> Optional[bool]:
    if not isinstance(value, ast.Call):
        return None
    target = project.resolve_expr(fi, value.func)
    if target in _NON_REENTRANT_CTORS:
        return False
    if target in _REENTRANT_CTORS:
        return True
    return None


def build_class_model(project: Project, ci: ClassInfo, graph: CallGraph) -> ClassLockModel:
    model = ClassLockModel(ci)

    # lock attrs: `self.X = threading.Lock()/RLock()/Condition()` in __init__,
    # plus anything used as `with self.X:` whose name mentions "lock"/"cond"
    init = ci.methods.get("__init__")
    if init is not None:
        for node in ast.walk(init.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                attr = _self_attr_name(node.targets[0])
                if attr is None:
                    continue
                reentrant = _ctor_reentrancy(project, init, node.value)
                if reentrant is not None:
                    model.lock_attrs[attr] = reentrant

    for mname, mi in ci.methods.items():
        regions: List[LockRegion] = []
        for node in ast.walk(mi.node):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                attr = _self_attr_name(item.context_expr)
                if attr is None:
                    continue
                known = attr in model.lock_attrs
                if known or "lock" in attr.lower() or "cond" in attr.lower():
                    model.lock_attrs.setdefault(attr, None)
                    end = getattr(node, "end_lineno", None) or node.lineno
                    regions.append(LockRegion(attr, node.lineno, end))
        if regions:
            model.regions[mname] = regions

    _infer_calling_contexts(model, graph)
    _infer_guards(model)
    return model


def _intra_call_sites(model: ClassLockModel) -> Dict[str, List[Tuple[str, int]]]:
    """callee method name -> [(caller method name, line)] for self.m() calls."""
    sites: Dict[str, List[Tuple[str, int]]] = {}
    for caller, fi in model.info.methods.items():
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                attr = _self_attr_name(node.func)
                if attr in model.info.methods:
                    sites.setdefault(attr, []).append((caller, node.lineno))
    return sites


def _has_external_callers(model: ClassLockModel, method: str, graph: CallGraph) -> bool:
    qname = model.info.methods[method].qname
    prefix = model.info.qname + "."
    for caller, callees in graph.edges.items():
        if qname in callees and not caller.startswith(prefix):
            return True
    return False


def _infer_calling_contexts(model: ClassLockModel, graph: CallGraph) -> None:
    """Fixpoint over two facts: a method called only from __init__ chains is
    construction context; a method whose every call site holds lock L runs
    under L."""
    sites = _intra_call_sites(model)

    candidates = {
        m for m in model.info.methods
        if m != "__init__"
        and m in sites
        and not _has_external_callers(model, m, graph)
    }

    changed = True
    while changed:
        changed = False
        for m in candidates:
            if m.startswith("_") and m not in model.init_only:
                callers = {c for c, _ in sites[m]}
                if callers and all(
                    c == "__init__" or c in model.init_only for c in callers
                ):
                    model.init_only.add(m)
                    changed = True
            if m not in model.locked_methods:
                held_everywhere: Optional[Set[str]] = None
                for caller, line in sites[m]:
                    held = model.locks_at(caller, line)
                    held_everywhere = held if held_everywhere is None else held_everywhere & held
                if held_everywhere:
                    model.locked_methods[m] = held_everywhere
                    changed = True
    model.init_only -= set(model.locked_methods)


def _attr_writes(fn: ast.AST):
    """Yield (attr, line) for writes/mutations of self.<attr> in fn."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                attr = _self_attr_name(t)
                if attr is not None:
                    yield attr, t.lineno
                if isinstance(t, ast.Subscript):
                    attr = _self_attr_name(t.value)
                    if attr is not None:
                        yield attr, t.lineno
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATING_METHODS:
                attr = _self_attr_name(node.func.value)
                if attr is not None:
                    yield attr, node.lineno
        elif isinstance(node, (ast.Delete,)):
            for t in node.targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                attr = _self_attr_name(base)
                if attr is not None:
                    yield attr, t.lineno


def _infer_guards(model: ClassLockModel) -> None:
    for mname, mi in model.info.methods.items():
        if mname == "__init__" or mname in model.init_only:
            continue
        for attr, line in _attr_writes(mi.node):
            if attr in model.lock_attrs:
                continue
            held = model.locks_at(mname, line)
            if held:
                model.guards.setdefault(attr, set()).update(held)


class RacePass(Pass):
    name = "races"

    def __init__(self, check_all_classes: bool = False) -> None:
        # check_all_classes drops the threaded-reachability restriction —
        # fixture packages that don't import threading can still exercise
        # the rules.
        self.check_all_classes = check_all_classes

    # -- scope -------------------------------------------------------------

    def _threaded_classes(self, project: Project, graph: CallGraph) -> Set[str]:
        if self.check_all_classes:
            return set(project.classes)
        roots = [
            fi.qname
            for fi in project.functions.values()
            if fi.module.threaded
            or fi.module.relpath.endswith(("cluster/rest.py", "cluster/broker.py"))
        ]
        reach = graph.reachable_from(roots)
        out: Set[str] = set()
        for cq, ci in project.classes.items():
            if ci.module.threaded or any(m.qname in reach for m in ci.methods.values()):
                out.add(cq)
        return out

    # -- entry -------------------------------------------------------------

    def run(self, project: Project) -> List[Finding]:
        graph = CallGraph.build(project)
        threaded = self._threaded_classes(project, graph)
        models: Dict[str, ClassLockModel] = {}
        for cq in threaded:
            ci = project.classes[cq]
            model = build_class_model(project, ci, graph)
            if model.lock_attrs:
                models[cq] = model

        findings: List[Finding] = []
        for model in models.values():
            findings.extend(self._check_w010(model))
        findings.extend(self._check_w011(project, graph, models))
        findings.extend(self._check_w012(project, graph, models))
        return findings

    # -- W010: unguarded access to a lock-guarded attribute ----------------

    def _check_w010(self, model: ClassLockModel) -> List[Finding]:
        findings: List[Finding] = []
        ci = model.info
        reported: Set[Tuple[str, str]] = set()
        for mname, mi in ci.methods.items():
            if mname == "__init__" or mname in model.init_only:
                continue
            for node in ast.walk(mi.node):
                attr = _self_attr_name(node)
                if attr is None or attr not in model.guards:
                    continue
                held = model.locks_at(mname, node.lineno)
                if held & model.guards[attr]:
                    continue
                key = (mname, attr)
                if key in reported:
                    continue
                reported.add(key)
                lock = sorted(model.guards[attr])[0]
                kind = "written" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
                findings.append(
                    Finding(
                        ci.module.relpath,
                        node.lineno,
                        "W010",
                        f"self.{attr} is guarded by self.{lock} elsewhere in "
                        f"{ci.name} but {kind} without it in {ci.name}.{mname}",
                        hint=f"acquire self.{lock} (or snapshot the value under it)",
                        symbol=f"{ci.name}.{mname}",
                    )
                )
        return findings

    # -- W011: lock-order cycles -------------------------------------------

    def _acquires_closure(
        self,
        qname: str,
        models: Dict[str, ClassLockModel],
        project: Project,
        graph: CallGraph,
        memo: Dict[str, Set[Tuple[str, str]]],
        stack: Set[str],
    ) -> Set[Tuple[str, str]]:
        if qname in memo:
            return memo[qname]
        if qname in stack:
            return set()
        stack.add(qname)
        out: Set[Tuple[str, str]] = set()
        fi = project.functions.get(qname)
        if fi is not None and fi.cls is not None and fi.cls.qname in models:
            model = models[fi.cls.qname]
            for r in model.regions.get(fi.name, ()):
                out.add((fi.cls.qname, r.lock))
        for callee in graph.callees(qname):
            out |= self._acquires_closure(callee, models, project, graph, memo, stack)
        stack.discard(qname)
        memo[qname] = out
        return out

    def _check_w011(
        self, project: Project, graph: CallGraph, models: Dict[str, ClassLockModel]
    ) -> List[Finding]:
        findings: List[Finding] = []
        memo: Dict[str, Set[Tuple[str, str]]] = {}
        # edges[(C, L1)] -> {(D, L2): (relpath, line, via)}
        edges: Dict[Tuple[str, str], Dict[Tuple[str, str], Tuple[str, int, str]]] = {}

        for cq, model in models.items():
            for mname, regions in model.regions.items():
                fi = model.info.methods[mname]
                for node in ast.walk(fi.node):
                    if not isinstance(node, ast.Call):
                        continue
                    target = project.resolve_call(fi, node)
                    if target is None or target not in project.functions:
                        continue
                    held_here = [r for r in regions if r.covers(node.lineno)]
                    if not held_here:
                        continue
                    acquired = self._acquires_closure(
                        target, models, project, graph, memo, set()
                    )
                    for r in held_here:
                        src = (cq, r.lock)
                        for dst in acquired:
                            if dst == src:
                                if models[cq].lock_attrs.get(r.lock) is False:
                                    findings.append(
                                        Finding(
                                            model.info.module.relpath,
                                            node.lineno,
                                            "W011",
                                            f"{model.info.name}.{mname} holds "
                                            f"self.{r.lock} (non-reentrant Lock) and the "
                                            f"call chain through {_short(target)} "
                                            f"re-acquires it — self-deadlock",
                                            hint="use threading.RLock or hoist the call "
                                            "out of the locked region",
                                            symbol=f"{model.info.name}.{mname}",
                                        )
                                    )
                                continue
                            edges.setdefault(src, {}).setdefault(
                                dst,
                                (model.info.module.relpath, node.lineno, _short(target)),
                            )
                # syntactically nested regions also order locks
                ordered = sorted(regions, key=lambda r: (r.start, -r.end))
                for outer in ordered:
                    for inner in ordered:
                        if inner is outer or not outer.covers(inner.start):
                            continue
                        if inner.lock != outer.lock:
                            edges.setdefault((cq, outer.lock), {}).setdefault(
                                (cq, inner.lock),
                                (model.info.module.relpath, inner.start, "nested with"),
                            )

        findings.extend(self._cycles(edges, models))
        return findings

    def _cycles(self, edges, models) -> List[Finding]:
        findings: List[Finding] = []
        reported: Set[frozenset] = set()

        def reaches(src, dst) -> bool:
            seen, stack = set(), [src]
            while stack:
                cur = stack.pop()
                if cur == dst:
                    return True
                if cur in seen:
                    continue
                seen.add(cur)
                stack.extend(edges.get(cur, {}))
            return False

        for src, dsts in edges.items():
            for dst, (relpath, line, via) in dsts.items():
                if not reaches(dst, src):
                    continue
                cyc = frozenset((src, dst))
                if cyc in reported:
                    continue
                reported.add(cyc)
                a = f"{_short(src[0])}.{src[1]}"
                b = f"{_short(dst[0])}.{dst[1]}"
                findings.append(
                    Finding(
                        relpath,
                        line,
                        "W011",
                        f"lock-order cycle: {a} -> {b} (via {via}) and {b} -> {a} "
                        "elsewhere — two threads can deadlock",
                        hint="pick one global acquisition order or narrow one "
                        "region to drop the nested acquire",
                        symbol=a,
                    )
                )
        return findings

    # -- W012: blocking calls while holding a lock -------------------------

    def _blocking_closure(
        self, qname: str, graph: CallGraph, memo: Dict[str, Optional[str]], stack: Set[str]
    ) -> Optional[str]:
        """Name of a blocker reachable from qname (through project calls)."""
        if qname in memo:
            return memo[qname]
        if qname in stack:
            return None
        stack.add(qname)
        result: Optional[str] = None
        for ext in graph.external.get(qname, {}):
            if ext in BLOCKING_EXTERNAL:
                result = ext
                break
        if result is None:
            fi = graph.project.functions.get(qname)
            if fi is not None:
                blocker = _direct_attr_blocker(fi.node)
                if blocker:
                    result = blocker
        if result is None:
            for callee in graph.callees(qname):
                result = self._blocking_closure(callee, graph, memo, stack)
                if result:
                    result = f"{_short(callee)} -> {result}"
                    break
        stack.discard(qname)
        memo[qname] = result
        return result

    def _check_w012(
        self, project: Project, graph: CallGraph, models: Dict[str, ClassLockModel]
    ) -> List[Finding]:
        findings: List[Finding] = []
        memo: Dict[str, Optional[str]] = {}
        for cq, model in models.items():
            ci = model.info
            for mname, fi in ci.methods.items():
                regions = model.regions.get(mname, [])
                always_held = model.locked_methods.get(mname, set())
                if not regions and not always_held:
                    continue
                reported: Set[Tuple[int, str]] = set()
                for node in ast.walk(fi.node):
                    if not isinstance(node, ast.Call):
                        continue
                    held = set(always_held)
                    held.update(r.lock for r in regions if r.covers(node.lineno))
                    if not held:
                        continue
                    lock = sorted(held)[0]
                    blocker: Optional[str] = None
                    target = project.resolve_call(fi, node)
                    if target is not None and target in BLOCKING_EXTERNAL:
                        blocker = target
                    elif _attr_blocker(node) is not None:
                        blocker = _attr_blocker(node)
                    elif target is not None and target in project.functions:
                        chain = self._blocking_closure(target, graph, memo, set())
                        if chain:
                            blocker = f"{_short(target)} -> {chain}"
                    if blocker is None:
                        continue
                    key = (node.lineno, blocker)
                    if key in reported:
                        continue
                    reported.add(key)
                    findings.append(
                        Finding(
                            ci.module.relpath,
                            node.lineno,
                            "W012",
                            f"{blocker} can block while {ci.name}.{mname} holds "
                            f"self.{lock}",
                            hint="move the blocking call outside the locked region "
                            "(stage under the lock, act after release)",
                            symbol=f"{ci.name}.{mname}",
                        )
                    )
        return findings


def _direct_attr_blocker(fn: ast.AST) -> Optional[str]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            blocker = _attr_blocker(node)
            if blocker is not None:
                return blocker
    return None


def _short(qname: str) -> str:
    parts = qname.split(".")
    return ".".join(parts[-2:]) if len(parts) > 1 else qname
