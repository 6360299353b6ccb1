"""Resource-lifecycle passes: the static companion to the model checker.

Port of pinot_tpu/analysis/lifecycle.py: the same rules; the condition
constructors are `threading.Condition` and the port's seam
`pinot_tpu_torch.utils.threads.Condition`.

W023 — paired-resource escape analysis.  The serving tier's ledgers hand
out resources through OPEN calls that a matching CLOSE must repay on every
path, including exception edges:

    ticket = self.budget.reserve(...)      ->  self.budget.release(ticket)
    ok     = self.budget.try_charge(n)     ->  self.budget.uncharge(n)
    hc.try_fire(opts)                      ->  hc.unfire()
    self.watchdog.register(qid)            ->  self.watchdog.deregister(qid)

A function that opens and does NOT let the handle ESCAPE (returned,
stored on self / into a container, or passed on to another owner) must
close on its exception edges: a matching close in a `finally` or an
`except` handler — lexically or through a project call chain that reaches
one (callgraph.py).  A close that only sits on the straight-line
path leaks the moment anything between open and close raises; no close at
all leaks on every path.  Escape means ownership moved — the pass stays
quiet and the dynamic checker (analysis/model_check.py) owns the proof
that the far end balances.

W024 — condition-variable discipline, the static face of the lost-wakeup
class the checker hunts dynamically:

  * `self.<cond>.wait()` must sit lexically inside a `while` loop — a
    woken waiter re-checks its predicate (spurious wakeups, stolen
    tokens); an `if` re-checks once and proceeds on stale truth.
  * `self.<cond>.notify()/notify_all()` must run while holding the
    condition's lock (ClassLockModel.locks_at) — a notify outside the
    lock races the waiter's predicate-check-then-park window, which is
    precisely a lost wakeup.

Both rules reuse the race-pass class model and the callgraph rather than
re-deriving lock regions.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from pinot_tpu_torch.analysis.callgraph import CallGraph
from pinot_tpu_torch.analysis.engine import FunctionInfo, Pass, Project
from pinot_tpu_torch.analysis.races import build_class_model
from pinot_tpu_torch.analysis.repo_lint import Finding

_COND_CTORS = {"threading.Condition", "pinot_tpu_torch.utils.threads.Condition"}


@dataclass(frozen=True)
class ResourcePair:
    """One open/close family.  `receiver_hint` (substring of the receiver
    expression, lowercased) scopes noisy verb names to the ledger objects
    that actually follow the protocol."""

    openers: Tuple[str, ...]
    closers: Tuple[str, ...]
    receiver_hint: str = ""
    what: str = "resource"


RESOURCE_PAIRS: Tuple[ResourcePair, ...] = (
    ResourcePair(("reserve", "reserve_or_wait"), ("release",), "budget", "reservation"),
    ResourcePair(("try_charge",), ("uncharge",), "budget", "ledger charge"),
    ResourcePair(("try_fire",), ("unfire",), "", "hedge token"),
    ResourcePair(("register",), ("deregister",), "watchdog", "watchdog registration"),
    ResourcePair(("arm",), ("disarm",), "", "armed trigger"),
)


def _production(relpath: str) -> bool:
    """Lifecycle discipline binds production code; tests deliberately probe
    leak and crash paths (arming kill-points, reserving past the cap to
    assert ReservationError) and would drown the signal."""
    base = relpath.rsplit("/", 1)[-1]
    return not (
        relpath.startswith("tests/")
        or "/tests/" in relpath
        or base.startswith("test_")
        or base == "conftest.py"
    )


def _recv_text(node: ast.AST) -> Optional[str]:
    """Dotted receiver text for name/attribute chains ("self.budget",
    "hc"); None for anything fancier (calls, subscripts)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _recv_text(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _parents(fn: ast.AST) -> Dict[ast.AST, ast.AST]:
    out: Dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(fn):
        for child in ast.iter_child_nodes(parent):
            out[child] = parent
    return out


def _cleanup_spans(fn: ast.AST) -> List[Tuple[int, int]]:
    """Line spans of every `finally` block and `except` handler body in fn
    — the regions that run on exception edges."""
    spans: List[Tuple[int, int]] = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.Try,)):
            for blk in (node.finalbody,):
                if blk:
                    end = getattr(blk[-1], "end_lineno", None) or blk[-1].lineno
                    spans.append((blk[0].lineno, end))
            for h in node.handlers:
                if h.body:
                    end = getattr(h.body[-1], "end_lineno", None) or h.body[-1].lineno
                    spans.append((h.body[0].lineno, end))
    return spans


def _in_spans(line: int, spans: List[Tuple[int, int]]) -> bool:
    return any(a <= line <= b for a, b in spans)


class LifecyclePass(Pass):
    """W023: an opened paired resource must escape or close on exception
    edges."""

    name = "lifecycle"

    def run(self, project: Project) -> List[Finding]:
        graph = CallGraph.build(project)
        closer_reach = self._closer_reachability(project, graph)
        findings: List[Finding] = []
        for fi in project.functions.values():
            if not _production(fi.module.relpath):
                continue
            findings.extend(self._check_function(project, graph, fi, closer_reach))
        return findings

    # -- interprocedural closer reachability ------------------------------

    def _closer_reachability(
        self, project: Project, graph: CallGraph
    ) -> Dict[str, Set[str]]:
        """qname -> closer attr names its body (transitively) calls."""
        all_closers = {c for p in RESOURCE_PAIRS for c in p.closers}
        direct: Dict[str, Set[str]] = {}
        for fi in project.functions.values():
            hit: Set[str] = set()
            for node in ast.walk(fi.node):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in all_closers
                ):
                    hit.add(node.func.attr)
            direct[fi.qname] = hit
        # fixpoint over call edges (the graphs are small; a few rounds)
        changed = True
        while changed:
            changed = False
            for caller in direct:
                for callee in graph.callees(caller):
                    extra = direct.get(callee, set()) - direct[caller]
                    if extra:
                        direct[caller] |= extra
                        changed = True
        return direct

    # -- per-function check ------------------------------------------------

    def _check_function(
        self,
        project: Project,
        graph: CallGraph,
        fi: FunctionInfo,
        closer_reach: Dict[str, Set[str]],
    ) -> List[Finding]:
        fn = fi.node
        parents = _parents(fn)
        spans = _cleanup_spans(fn)
        findings: List[Finding] = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            pair = self._pair_for(node.func.attr)
            if pair is None:
                continue
            recv = _recv_text(node.func.value)
            if recv is None:
                continue
            if pair.receiver_hint and pair.receiver_hint not in recv.lower():
                continue
            if self._defines_pair_method(fi, pair):
                continue  # the ledger's own implementation, not a client
            if self._escapes(fn, parents, node, pair):
                continue
            closer_lines = self._closer_lines(fn, pair, recv)
            cleanup_covers = any(_in_spans(ln, spans) for ln in closer_lines)
            if not cleanup_covers:
                cleanup_covers = self._cleanup_reaches_closer(
                    project, fi, pair, spans, closer_reach
                )
            if cleanup_covers:
                continue
            symbol = (
                f"{fi.cls.name}.{fi.name}" if fi.cls is not None else fi.name
            )
            if closer_lines:
                msg = (
                    f"{recv}.{node.func.attr}() opens a {pair.what} that "
                    f"{recv}.{pair.closers[0]}() repays only on the straight-line "
                    "path — an exception between them leaks it"
                )
                hint = f"move the {pair.closers[0]} into a finally: (or an except: unwind)"
            else:
                reach = closer_reach.get(fi.qname, set())
                if set(pair.closers) & reach:
                    continue  # closed somewhere down the call chain
                msg = (
                    f"{recv}.{node.func.attr}() opens a {pair.what} this function "
                    "never repays and never hands off"
                )
                hint = (
                    f"pair it with {recv}.{pair.closers[0]}() in a finally:, or "
                    "return/store the handle so the owner can"
                )
            findings.append(
                Finding(
                    fi.module.relpath,
                    node.lineno,
                    "W023",
                    msg,
                    hint=hint,
                    symbol=symbol,
                )
            )
        return findings

    @staticmethod
    def _pair_for(attr: str) -> Optional[ResourcePair]:
        for pair in RESOURCE_PAIRS:
            if attr in pair.openers:
                return pair
        return None

    @staticmethod
    def _defines_pair_method(fi: FunctionInfo, pair: ResourcePair) -> bool:
        """Calls inside the class that DEFINES the open/close protocol are
        the implementation (reserve_or_wait retrying reserve, release
        notifying) — lifecycle discipline binds the clients."""
        if fi.cls is None:
            return False
        names = set(fi.cls.methods)
        return bool(names & set(pair.openers)) and bool(names & set(pair.closers))

    # -- escape analysis ---------------------------------------------------

    def _escapes(
        self,
        fn: ast.AST,
        parents: Dict[ast.AST, ast.AST],
        call: ast.Call,
        pair: ResourcePair,
    ) -> bool:
        """True when the opened handle's ownership moves: returned, stored
        beyond a local, passed to another call, yielded, or bound into a
        structure.  Conservative toward quiet — W023 reports only handles
        that provably stay local."""
        parent = parents.get(call)
        # direct escape: return reserve(...), f(reserve(...)), yield ...,
        # self.t = reserve(...), d[k] = reserve(...), [reserve(...)], etc.
        if isinstance(parent, (ast.Return, ast.Yield, ast.Call, ast.Starred)):
            return True
        if isinstance(parent, (ast.Tuple, ast.List, ast.Dict, ast.Set)):
            return True
        if isinstance(parent, ast.keyword):
            return True
        binding: Optional[str] = None
        if isinstance(parent, ast.Assign):
            if len(parent.targets) == 1 and isinstance(parent.targets[0], ast.Name):
                binding = parent.targets[0].id
            else:
                return True  # self.attr = open(...) / a, b = ... — ownership moved
        elif isinstance(parent, ast.AnnAssign):
            if isinstance(parent.target, ast.Name):
                binding = parent.target.id
            else:
                return True
        elif isinstance(parent, (ast.Expr, ast.If, ast.While, ast.UnaryOp, ast.Compare, ast.BoolOp)):
            # bare statement / used as a predicate: nothing escaped
            binding = None
        elif parent is not None and not isinstance(parent, ast.stmt):
            # some other expression context (f-string, comparison chain...)
            return True
        if binding is None:
            return False
        # the bound local escapes if it is returned, passed to a call,
        # stored onto self / into a subscript, or re-exported any other way
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and _uses_name(node.value, binding):
                return True
            if isinstance(node, ast.Yield) and _uses_name(node.value, binding):
                return True
            if isinstance(node, ast.Call) and node is not call:
                # handing the handle BACK to its closer is repayment, not
                # an ownership transfer — every other callee is a new owner
                closes = (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in pair.closers
                )
                args = list(node.args) + [kw.value for kw in node.keywords]
                if not closes and any(_uses_name(a, binding) for a in args):
                    return True
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)) and _uses_name(
                        node.value, binding
                    ):
                        return True
        return False

    @staticmethod
    def _closer_lines(fn: ast.AST, pair: ResourcePair, recv: str) -> List[int]:
        lines: List[int] = []
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in pair.closers
                and _recv_text(node.func.value) == recv
            ):
                lines.append(node.lineno)
        return lines

    @staticmethod
    def _cleanup_reaches_closer(
        project: Project,
        fi: FunctionInfo,
        pair: ResourcePair,
        spans: List[Tuple[int, int]],
        closer_reach: Dict[str, Set[str]],
    ) -> bool:
        """A finally/except call into a project function that transitively
        closes the pair also covers the exception edge (grant.close(),
        self._finish(), ...)."""
        if not spans:
            return False
        for node in ast.walk(fi.node):
            if not (isinstance(node, ast.Call) and _in_spans(node.lineno, spans)):
                continue
            target = project.resolve_call(fi, node)
            if target is None and isinstance(node.func, ast.Attribute):
                # unresolvable receiver (grant.close()): match by method name
                # over the whole project — coarse but sound for coverage
                mname = node.func.attr
                for qn, reach in closer_reach.items():
                    if qn.endswith(f".{mname}") and set(pair.closers) & reach:
                        return True
                continue
            if target is not None and set(pair.closers) & closer_reach.get(target, set()):
                return True
        return False


def _uses_name(node: Optional[ast.AST], name: str) -> bool:
    if node is None:
        return False
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == name:
            return True
    return False


class ConditionDisciplinePass(Pass):
    """W024: Condition.wait outside a while-predicate loop; notify without
    the condition's lock held."""

    name = "condition-discipline"

    def run(self, project: Project) -> List[Finding]:
        graph = CallGraph.build(project)
        findings: List[Finding] = []
        for ci in project.classes.values():
            if not _production(ci.module.relpath):
                continue
            cond_attrs = self._condition_attrs(project, ci)
            if not cond_attrs:
                continue
            model = build_class_model(project, ci, graph)
            for mname, mi in ci.methods.items():
                parents = _parents(mi.node)
                for node in ast.walk(mi.node):
                    if not (
                        isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                    ):
                        continue
                    recv = node.func.value
                    attr = (
                        recv.attr
                        if isinstance(recv, ast.Attribute)
                        and isinstance(recv.value, ast.Name)
                        and recv.value.id == "self"
                        else None
                    )
                    if attr not in cond_attrs:
                        continue
                    if node.func.attr == "wait" and not self._inside_while(
                        node, parents, mi.node
                    ):
                        findings.append(
                            Finding(
                                ci.module.relpath,
                                node.lineno,
                                "W024",
                                f"self.{attr}.wait() in {ci.name}.{mname} is not "
                                "inside a while-predicate loop — a spurious or "
                                "stolen wakeup proceeds on a stale predicate",
                                hint="wrap the wait in `while not <predicate>:` "
                                "(re-check after every wake)",
                                symbol=f"{ci.name}.{mname}",
                            )
                        )
                    elif node.func.attr in ("notify", "notify_all"):
                        held = model.locks_at(mname, node.lineno)
                        if attr not in held:
                            findings.append(
                                Finding(
                                    ci.module.relpath,
                                    node.lineno,
                                    "W024",
                                    f"self.{attr}.{node.func.attr}() in "
                                    f"{ci.name}.{mname} without holding "
                                    f"self.{attr} — races the waiter's "
                                    "check-then-park window (lost wakeup)",
                                    hint=f"notify inside `with self.{attr}:`",
                                    symbol=f"{ci.name}.{mname}",
                                )
                            )
        return findings

    @staticmethod
    def _condition_attrs(project: Project, ci) -> Set[str]:
        out: Set[str] = set()
        for mi in ci.methods.values():
            for node in ast.walk(mi.node):
                if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                    continue
                t = node.targets[0]
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                if isinstance(node.value, ast.Call):
                    target = project.resolve_expr(mi, node.value.func)
                    if target in _COND_CTORS:
                        out.add(t.attr)
        return out

    @staticmethod
    def _inside_while(node: ast.AST, parents: Dict[ast.AST, ast.AST], fn: ast.AST) -> bool:
        cur = parents.get(node)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.While):
                return True
            cur = parents.get(cur)
        return False
