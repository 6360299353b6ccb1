"""Torch-aware repo lint: ast pass over the pinot_tpu_torch tree.

Port of pinot_tpu/analysis/repo_lint.py.  Every rule keeps its ID, its
`RULES` entry and the `# pinot-lint: disable=Wxxx` suppression syntax.
Each rule has one of three statuses on the port:

  (a) same meaning, same code as the JAX package
  (b) retargeted to torch, with the meaning stated below
  (c) no torch object: the ID and its RULES entry stay, the rule reports
      nothing on this tree

  | Rule | Status | On the port |
  | ---- | ------ | ----------- |
  | W001 | (b) | float literal in arithmetic or a comparison inside a body `torch.func.vmap` carries (a function passed to `vmap` by name, or decorated with it) or inside a kernel's plain version (a function named `*_reference`): torch promotes an int tensor to the default float dtype, the same hazard as JAX's weak-typed f32 |
  | W002 | (b) | host sync inside a vmapped body (`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `np.asarray`, `.synchronize()`: under vmap `.item()` raises), or a `.synchronize()` inside a for/while body (a per-launch fence serializes the launch pipeline) |
  | W003 | (c) | `jax.jit` built per iteration: torch eager compiles nothing per call, and the port never calls `torch.compile` |
  | W004 | (a) | unlocked read-modify-write of a shared `self.*` attribute in a cluster/ class |
  | W005 | (a) | `time.time()` in elapsed-time math |
  | W006 | (a) | swallowed exception in cluster/ |
  | W007 | (a) | metric/span name interpolating an unbounded value |
  | W008 | (a) | literal-baked `.fingerprint()` as a plan-cache key |
  | W015 | (a) | unbounded container growth on a cluster serving path |
  | W016 | (a) | non-durable write to a durability artifact |
  | W017 | (b) | wall-clock timing around an async CUDA launch (a bare or module-qualified call of a kernel wrapper, `fused_group_tables` / `scan_runs` / `funnel_reach`, or of a name bound to `torch.func.vmap(...)`) with no `torch.cuda.synchronize()`, `Event.synchronize()`, `elapsed_time` or `.cpu()` between the launch and the stop timestamp |
  | W018 | (b) | a blocking call in the batcher's dispatch path: sleep, `.synchronize()`, `.item()` / `.tolist()` / `.cpu()` / `.numpy()` of a tensor, socket waits |
  | W019 | (a) | retry loop re-issuing a server call without backoff or the cancel probe |
  | W020 | (c) | packed words widened in a Pallas kernel body: the port has no Pallas; its CUDA kernels unpack lanes in registers (ops/csrc), out of an ast pass's reach |
  | W021 | (b) | a synchronous `.to(device)`, `.cuda()` or `torch.as_tensor` / `torch.tensor` / `torch.from_numpy(..., device=)` of a segment-sized operand outside parallel/staging.py, segment/residency.py and the staging-named functions (`to_device`, `*stage*`) |
  | W022 | (a) | wall-clock arithmetic in lease/election/fencing code |
  | W025 | (b) | a bare axis literal ("seg" / "replica" / "shard", or a tuple of them) passed to a mesh builder or fold (`Mesh`, `default_mesh`, `normalize_axes`, `combine_hierarchical`, `psum_*`, `pmin_*`, `pmax_*`, `fold_*`, torch.distributed collectives) outside parallel/mesh.py |
  | W026 | (a) | direct write to a registry-managed knob, or a wall clock inside the autopilot |

W004, W006, W015, W018 and W019 run on cluster/ files (`threaded`).  The
interprocedural rules (W010-W014, W023, W024) live in races.py,
device_sync.py and lifecycle.py and run through engine.run_project.

The (a) rules' docstrings below are the JAX package's, word for word where
the rule is.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set

RULES: Dict[str, str] = {
    "W001": "float literal in a vmapped body or a kernel's plain version (an int tensor promotes to the default float dtype)",
    "W002": "host<->device sync inside a vmapped body, or a per-launch synchronize() inside a loop",
    "W003": "jax.jit constructed per-iteration/per-call (recompiles); no torch object: reports nothing on the port",
    "W004": "unlocked read-modify-write of shared state in cluster class",
    "W005": "wall-clock time.time() in elapsed-time math (use monotonic/perf_counter)",
    "W006": "except block in cluster/ swallows the exception without recording it",
    "W007": "metric/span name interpolates an unbounded value (cardinality explosion)",
    "W008": "literal-baked fingerprint() used as a plan-cache key (use shape_fingerprint)",
    "W015": "unbounded container growth on a cluster serving path (no bound/eviction)",
    "W016": "non-durable write to a durability path (no tmp-fsync-replace discipline)",
    "W017": "wall-clock timing around an async CUDA launch without a synchronize()/elapsed_time/.cpu() fence before the stop timestamp",
    "W018": "blocking call (sleep/synchronize/.item()/.cpu()/socket I/O) inside an async batch-dispatch path",
    "W019": "retry/hedge loop re-issues a server call without bounded backoff or without the cancel-probe path",
    "W020": "packed words widened via .astype() in a Pallas kernel body before the lane unpack; no torch object: reports nothing on the port",
    "W021": "synchronous .to(device)/.cuda()/torch.as_tensor(device=) of a segment-sized array outside the staging stream (route through the residency manager's budgeted charge)",
    "W022": "wall-clock time.time() arithmetic in lease/election/fencing code (use the injectable/monotonic clock)",
    "W025": "bare mesh-axis string literal passed to a mesh builder or fold outside parallel/mesh.py (use the engine's mesh or the mesh module's axis constants)",
    "W026": "controller discipline: direct write to a registry-managed serving knob outside a clamped KnobRegistry setter, or wall-clock use inside the autopilot (use the injected clock)",
    # interprocedural passes (analysis/races.py, analysis/device_sync.py —
    # run via analysis/engine.py over the whole package, not per-file):
    "W010": "lock-guarded attribute read/written without holding its lock",
    "W011": "lock-order cycle across lock acquisitions (deadlock risk)",
    "W012": "blocking call (sleep/synchronize/.item()/socket/device copy) while holding a lock",
    "W013": "implicit device->host sync on the warm query path",
    "W014": "host control flow branches on a device value in the warm path",
    # resource-lifecycle passes (analysis/lifecycle.py):
    "W023": "paired resource (reserve/release, try_charge/uncharge, try_fire/unfire, register/deregister, arm/disarm) opened but not closed on exception edges and never handed off",
    "W024": "condition-variable discipline: wait outside a while-predicate loop, or notify without holding the condition's lock (lost-wakeup shapes)",
}

_HOST_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
_HOST_MODULES = frozenset({"np", "numpy"})


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str
    # optional enrichment from the interprocedural passes (analysis/engine.py):
    # a fix hint and the enclosing symbol ("Class.method") — empty for the
    # per-file rules so the greppable str() form stays byte-stable
    hint: str = ""
    symbol: str = ""

    def __str__(self) -> str:
        s = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            s += f" [fix: {self.hint}]"
        return s

    def to_dict(self) -> Dict[str, object]:
        return {
            "path": self.path,
            "line": self.line,
            "rule": self.rule,
            "message": self.message,
            "hint": self.hint,
            "symbol": self.symbol,
        }


def _is_vmap_func(node: ast.AST) -> bool:
    """ast node that refers to torch.func.vmap (Name 'vmap' or Attribute
    '*.vmap')."""
    if isinstance(node, ast.Attribute):
        return node.attr == "vmap"
    return isinstance(node, ast.Name) and node.id == "vmap"


def _vmapped_function_names(tree: ast.AST) -> Set[str]:
    """Names passed to vmap(...) as a bare Name anywhere in the module."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_vmap_func(node.func):
            for a in node.args[:1]:
                if isinstance(a, ast.Name):
                    out.add(a.id)
    return out


def _has_vmap_decorator(fn: ast.FunctionDef) -> bool:
    for d in fn.decorator_list:
        if _is_vmap_func(d):
            return True
        if isinstance(d, ast.Call):
            if _is_vmap_func(d.func):
                return True
            # @partial(torch.func.vmap, ...)
            if (
                isinstance(d.func, ast.Name)
                and d.func.id == "partial"
                and d.args
                and _is_vmap_func(d.args[0])
            ):
                return True
    return False


def _is_plain_version(fn: ast.FunctionDef) -> bool:
    """A kernel's plain PyTorch version: the port names it `*_reference`
    (ops/fused_scan.py `fused_group_tables_reference`, ops/funnel_scan.py
    `scan_runs_reference`)."""
    return fn.name.endswith("_reference")


def _check_sync_in_loop(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """W002: `.synchronize()` (torch.cuda / a stream / an event) inside a
    for/while body — a per-launch fence serializes the launch pipeline (the
    macro-batch loop drains once at the collect point instead).  Function
    bodies reset the loop scope: a def inside a loop runs when called, not
    per iteration."""

    def walk(node: ast.AST, depth: int) -> None:
        is_loop = isinstance(node, (ast.For, ast.While))
        for child in ast.iter_child_nodes(node):
            nd = (
                0
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef))
                else depth + (1 if is_loop else 0)
            )
            if (
                nd > 0
                and isinstance(child, ast.Call)
                and isinstance(child.func, ast.Attribute)
                and child.func.attr == "synchronize"
            ):
                findings.append(
                    Finding(
                        path, child.lineno, "W002",
                        "per-launch .synchronize() in a loop serializes the launch pipeline",
                    )
                )
            walk(child, nd)

    walk(tree, 0)


def _is_lock_name(name: str) -> bool:
    # condition variables count: `with self._cv:` acquires the underlying lock
    low = name.lower()
    return "lock" in low or "cond" in low or low.lstrip("_") == "cv"


def _mentions_lock(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and _is_lock_name(n.attr):
            return True
        if isinstance(n, ast.Name) and _is_lock_name(n.id):
            return True
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for `self.x`, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _reads_self_attr(node: ast.AST, attr: str) -> bool:
    for n in ast.walk(node):
        if _self_attr(n) == attr:
            return True
    return False


class _KernelRules(ast.NodeVisitor):
    """W001 + W002 inside one vmapped body or plain version (W002 only in
    vmapped bodies: a plain version runs eagerly, where a host read is
    legal)."""

    def __init__(self, path: str, findings: List[Finding], syncs: bool = True):
        self.path = path
        self.findings = findings
        self.syncs = syncs

    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(self.path, getattr(node, "lineno", 0), rule, msg))

    def visit_BinOp(self, node: ast.BinOp) -> None:
        for op in (node.left, node.right):
            if isinstance(op, ast.Constant) and type(op.value) is float:
                self._flag("W001", op, f"float literal {op.value!r} in kernel arithmetic")
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        for op in [node.left] + list(node.comparators):
            if isinstance(op, ast.Constant) and type(op.value) is float:
                self._flag("W001", op, f"float literal {op.value!r} in kernel comparison")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if self.syncs and isinstance(f, ast.Attribute):
            if f.attr in _HOST_SYNC_ATTRS:
                self._flag("W002", node, f".{f.attr}() syncs host<->device inside a vmapped body")
            elif (
                f.attr == "asarray"
                and isinstance(f.value, ast.Name)
                and f.value.id in _HOST_MODULES
            ):
                self._flag("W002", node, f"{f.value.id}.asarray() materializes on host inside a vmapped body")
        self.generic_visit(node)


def _check_w004(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """Unlocked RMW on shared self attributes in cluster/ classes."""
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef) or fn.name == "__init__":
                continue
            # local aliases of self attrs (`b = self._buckets.get(k)` then
            # `b[0] = ...` is still an RMW on the shared dict's values)
            aliases: Dict[str, str] = {}
            locked_lines: List[range] = []
            for n in ast.walk(fn):
                if isinstance(n, ast.With) and any(_mentions_lock(i.context_expr) for i in n.items):
                    locked_lines.append(range(n.lineno, (n.end_lineno or n.lineno) + 1))

            def under_lock(node: ast.AST) -> bool:
                ln = getattr(node, "lineno", 0)
                return any(ln in r for r in locked_lines)

            for n in ast.walk(fn):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                    src = n.value
                    if isinstance(src, ast.Call) and isinstance(src.func, ast.Attribute):
                        src = src.func.value  # self.x.get(...) -> self.x
                    if isinstance(src, ast.Subscript):
                        src = src.value
                    attr = _self_attr(src)
                    if attr is not None and not under_lock(n):
                        aliases[n.targets[0].id] = attr

            def shared_target(t: ast.AST) -> Optional[str]:
                if isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
                    if attr is not None:
                        return attr
                    if isinstance(t.value, ast.Name) and t.value.id in aliases:
                        return aliases[t.value.id]
                return _self_attr(t)

            for n in ast.walk(fn):
                if isinstance(n, ast.AugAssign):
                    attr = shared_target(n.target)
                    if attr is not None and not under_lock(n):
                        findings.append(
                            Finding(
                                path, n.lineno, "W004",
                                f"unlocked `self.{attr}` read-modify-write in {cls.name}.{fn.name}",
                            )
                        )
                elif isinstance(n, ast.Assign):
                    for t in n.targets:
                        attr = shared_target(t) if isinstance(t, ast.Subscript) else None
                        if attr is None or under_lock(n):
                            continue
                        # writing through an ALIAS of a shared container is an
                        # RMW by construction (the alias bind read it); direct
                        # self.X[k] = v writes only count when the value reads
                        # X back (plain inserts are setup, not RMW)
                        via_alias = (
                            isinstance(t.value, ast.Name) and t.value.id in aliases
                        )
                        reads = via_alias or _reads_self_attr(n.value, attr) or any(
                            isinstance(x, ast.Name) and aliases.get(x.id) == attr
                            for x in ast.walk(n.value)
                        )
                        if reads:
                            findings.append(
                                Finding(
                                    path, n.lineno, "W004",
                                    f"unlocked `self.{attr}` read-modify-write in {cls.name}.{fn.name}",
                                )
                            )


def _is_time_time_call(node: ast.AST) -> bool:
    """`time.time()` — the wall clock (bare `time()` is ambiguous, skipped)."""
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "time"
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "time"
    )


def _contains_time_time(node: ast.AST, aliases: Set[str]) -> bool:
    for n in ast.walk(node):
        if _is_time_time_call(n):
            return True
        if isinstance(n, ast.Name) and n.id in aliases:
            return True
    return False


def _check_w005(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """Wall-clock elapsed-time math: time.time() (or a local assigned
    exactly `time.time()`) used as an operand of a subtraction or
    comparison.  `int(time.time() * 1000)` stored as an epoch timestamp is
    deliberately NOT tracked through the alias — epoch math against data
    timestamps (retention windows, segment time ranges) is correct use."""

    def scope_nodes(body: List[ast.stmt]):
        """Walk a scope without descending into nested function bodies
        (those get their own pass with their own aliases)."""
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            yield n
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested scope: gets its own pass with its own aliases
            stack.extend(ast.iter_child_nodes(n))

    def scan_scope(body: List[ast.stmt]) -> None:
        aliases: Set[str] = set()
        nodes = list(scope_nodes(body))
        for n in nodes:  # collect aliases first: use can precede def in walk order
            if (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and _is_time_time_call(n.value)
            ):
                aliases.add(n.targets[0].id)
        if not aliases and not any(_is_time_time_call(n) for n in nodes):
            return
        for n in nodes:
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub):
                if _contains_time_time(n.left, aliases) or _contains_time_time(n.right, aliases):
                    findings.append(
                        Finding(
                            path, n.lineno, "W005",
                            "time.time() in elapsed-time subtraction — use time.monotonic()/perf_counter()",
                        )
                    )
            elif isinstance(n, ast.Compare):
                if any(_contains_time_time(op, aliases) for op in [n.left] + list(n.comparators)):
                    findings.append(
                        Finding(
                            path, n.lineno, "W005",
                            "time.time() in a time comparison — use time.monotonic()/perf_counter()",
                        )
                    )

    scan_scope(getattr(tree, "body", []))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_scope(node.body)


# lease/election/fencing scope: the code whose clock MUST be injectable
_W022_SCOPE = re.compile(r"lease|election|fence|fencing|promote|demote|deposed", re.I)
# identifiers whose arithmetic against the wall clock marks a fencing bug
# even outside a scope-named function (max_epoch, lease_deadline, expiresAt)
_W022_IDENT = re.compile(r"lease|expires|(^|_)epoch", re.I)


def _check_w022(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """W022: wall-clock time.time() arithmetic in lease-deadline or
    epoch-compare code paths.  Two triggers:

      * any +/-/compare involving time.time() (or an exact local alias)
        inside a function or class whose name matches lease/election/
        fence/promote/demote — that code's clock must be the injectable
        one, full stop;
      * anywhere else, a +/-/compare that MIXES time.time() with a
        lease/epoch-named identifier (``entry_epoch > time.time() - ttl``).

    Epoch *timestamp* stamping (``int(time.time() * 1000)``) is
    multiplication, not flagged; retention math over data timestamps never
    touches time.time() in the same expression and stays clean."""

    def scope_nodes(body: List[ast.stmt]):
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            yield n
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested scope: gets its own pass
            stack.extend(ast.iter_child_nodes(n))

    def names_match(node: ast.AST) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and _W022_IDENT.search(n.id):
                return True
            if isinstance(n, ast.Attribute) and _W022_IDENT.search(n.attr):
                return True
        return False

    def scan(body: List[ast.stmt], scoped: bool) -> None:
        nodes = list(scope_nodes(body))
        aliases: Set[str] = set()
        for n in nodes:
            if (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and _is_time_time_call(n.value)
            ):
                aliases.add(n.targets[0].id)
        for n in nodes:
            if isinstance(n, ast.BinOp) and isinstance(n.op, (ast.Add, ast.Sub)):
                operands = [n.left, n.right]
            elif isinstance(n, ast.Compare):
                operands = [n.left] + list(n.comparators)
            else:
                continue
            if not any(_contains_time_time(op, aliases) for op in operands):
                continue
            if scoped:
                findings.append(
                    Finding(
                        path, n.lineno, "W022",
                        "wall-clock time.time() arithmetic in lease/election code — "
                        "use the injectable clock (LeaseManager.now / time.monotonic)",
                    )
                )
            elif any(names_match(op) for op in operands):
                findings.append(
                    Finding(
                        path, n.lineno, "W022",
                        "time.time() mixed with a lease/epoch identifier — fencing "
                        "decisions must ride the injectable/monotonic clock",
                    )
                )

    def collect(node: ast.AST, enclosing_scoped: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                collect(child, enclosing_scoped or bool(_W022_SCOPE.search(child.name)))
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scoped = enclosing_scoped or bool(_W022_SCOPE.search(child.name))
                scan(child.body, scoped)
                collect(child, scoped)
            else:
                collect(child, enclosing_scoped)

    scan(getattr(tree, "body", []), False)
    collect(tree, False)


# registry-managed serving knob attributes (cluster/autopilot.py SPECS):
# runtime mutation must go through a clamped KnobRegistry setter, never a
# bare attribute write that skips the clamp bounds and the atomic swap
_W026_KNOB_ATTRS = frozenset(
    {"wait_ms", "pipeline_depth", "staging_depth", "budget_pct", "quantile_mult"}
)
# wall clocks forbidden inside the autopilot: the controller's whole test
# story rides the injected clock (threads.monotonic or a ctor fake)
_W026_WALL_CLOCKS = frozenset({"time", "monotonic", "perf_counter"})


def _is_wall_clock_call(node: ast.AST) -> bool:
    """`time.time()` / `time.monotonic()` / `time.perf_counter()` — module
    attribute calls only, so `threads.monotonic()` (the injection seam)
    and `self.clock()` stay clean."""
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _W026_WALL_CLOCKS
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "time"
    )


def _check_w026(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """W026 (controller discipline), two triggers:

      * an Assign/AugAssign whose target is a `<obj>.<knob>` attribute for
        a registry-managed knob name, outside `__init__` (construction
        wires defaults) and outside a property-setter body (the sanctioned
        pin-the-override path) — runtime knob mutation must go through a
        clamped KnobRegistry setter so the static ceilings and the atomic
        snapshot discipline hold;
      * in an autopilot module (path contains "autopilot"), any
        `time.time()`/`time.monotonic()`/`time.perf_counter()` call — the
        control loop must read the INJECTED clock (`threads.monotonic` or
        the ctor's fake) or the deterministic scheduler cannot drive it."""

    def is_exempt_fn(fn: ast.AST) -> bool:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        if fn.name == "__init__":
            return True
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Attribute) and dec.attr == "setter":
                return True
        return False

    def scan_writes(body: List[ast.stmt]) -> None:
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not is_exempt_fn(n):
                    scan_writes(n.body)
                continue
            targets: List[ast.AST] = []
            if isinstance(n, ast.Assign):
                targets = list(n.targets)
            elif isinstance(n, ast.AugAssign):
                targets = [n.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr in _W026_KNOB_ATTRS:
                    findings.append(
                        Finding(
                            path, n.lineno, "W026",
                            f"direct write to registry-managed knob `.{t.attr}` "
                            "outside a clamped KnobRegistry setter — route runtime "
                            "tuning through autopilot.knobs().set() so clamp bounds "
                            "and the atomic knob snapshot hold",
                        )
                    )
            stack.extend(ast.iter_child_nodes(n))

    scan_writes(getattr(tree, "body", []))

    if "autopilot" in os.path.basename(path):
        for n in ast.walk(tree):
            if _is_wall_clock_call(n):
                findings.append(
                    Finding(
                        path, n.lineno, "W026",
                        f"wall-clock time.{n.func.attr}() inside the autopilot — "
                        "the control loop must use its injected clock "
                        "(threads.monotonic / the ctor's fake) so the "
                        "deterministic scheduler and fake-clock tests can drive it",
                    )
                )


def _check_w006(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """Swallowed exceptions: a handler with no Raise and no Call anywhere
    in its body drops the fault invisibly (`except: pass`, `except:
    continue`).  Any call — logging, metrics, recording onto a stats
    object, even a send — counts as surfacing it."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        has_signal = any(
            isinstance(n, (ast.Raise, ast.Call)) for n in ast.walk(ast.Module(body=node.body, type_ignores=[]))
        )
        if not has_signal:
            findings.append(
                Finding(
                    path, node.lineno, "W006",
                    "except block swallows the exception (no raise, no log/metrics/record call)",
                )
            )


_METRIC_NAME_SINKS = frozenset({"counter", "gauge", "timer", "histogram", "span"})
_UNBOUNDED_HINTS = ("sql", "query", "qid", "uuid", "fingerprint", "text")


def _unbounded_hint(name: str) -> bool:
    """Identifier that smells like a per-request value: sql text, query /
    request ids, uuids, fingerprints.  Table/segment/server names are
    bounded label spaces and interpolate freely."""
    low = name.lower()
    return low == "id" or low.endswith("_id") or any(h in low for h in _UNBOUNDED_HINTS)


def _check_w007(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """Metric/span names from f-strings interpolating unbounded values:
    `METRICS.counter(f"lat.{sql}")` mints one counter PER DISTINCT QUERY —
    the registry (and any Prometheus scraper behind it) grows without
    bound.  Scope is the name argument of the registry factories and
    trace spans; only the interpolated expressions are inspected, so
    `f"server.segmentBytes.{table}"` stays clean."""
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _METRIC_NAME_SINKS
            and node.args
            and isinstance(node.args[0], ast.JoinedStr)
        ):
            continue
        for part in node.args[0].values:
            if not isinstance(part, ast.FormattedValue):
                continue
            for n in ast.walk(part.value):
                name = n.id if isinstance(n, ast.Name) else (
                    n.attr if isinstance(n, ast.Attribute) else None
                )
                if name is not None and _unbounded_hint(name):
                    findings.append(
                        Finding(
                            path, node.lineno, "W007",
                            f"metric/span name interpolates unbounded value {name!r} "
                            f"in .{node.func.attr}(...) — one series per distinct value",
                        )
                    )
                    break


def _contains_fingerprint_call(node: ast.AST) -> bool:
    """An expression containing a `.fingerprint()` call — the FULL form that
    bakes literal values.  `.shape_fingerprint()` is a different attribute
    and deliberately does not match."""
    for n in ast.walk(node):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "fingerprint"
        ):
            return True
    return False


def _is_plan_cache_name(node: ast.AST) -> bool:
    """A name/attribute that IS a plan cache by repo convention
    (`_PLAN_CACHE`, `self._plan_cache`, ...).  Result caches, slow logs and
    audit maps legitimately hold full fingerprints and never match."""
    name = node.attr if isinstance(node, ast.Attribute) else (
        node.id if isinstance(node, ast.Name) else None
    )
    return name is not None and "plan_cache" in name.lower()


def _check_w008(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """Literal-baked plan-cache keys: `.fingerprint()` output reaching a
    plan-cache subscript or .get/.put key, directly or via one local
    assignment (`key = (ctx.fingerprint(), ...)` then `cache.get(key)`).
    Every distinct literal then retraces an identical kernel shape — the
    exact recompile storm shape_fingerprint() exists to prevent."""

    def scan_scope(body: List[ast.stmt]) -> None:
        nodes: List[ast.AST] = []
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            nodes.append(n)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested scope: its own pass, its own taints
            stack.extend(ast.iter_child_nodes(n))
        tainted: Set[str] = set()
        for n in nodes:
            if (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and _contains_fingerprint_call(n.value)
            ):
                tainted.add(n.targets[0].id)

        def literal_bearing(expr: ast.AST) -> bool:
            return _contains_fingerprint_call(expr) or (
                isinstance(expr, ast.Name) and expr.id in tainted
            )

        for n in nodes:
            if (
                isinstance(n, ast.Subscript)
                and _is_plan_cache_name(n.value)
                and literal_bearing(n.slice)
            ):
                findings.append(
                    Finding(
                        path, n.lineno, "W008",
                        "literal-baked fingerprint() in plan-cache key — "
                        "key on shape_fingerprint() so literals parameterize",
                    )
                )
            elif (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("get", "put", "setdefault", "pop")
                and _is_plan_cache_name(n.func.value)
                and n.args
                and literal_bearing(n.args[0])
            ):
                findings.append(
                    Finding(
                        path, n.lineno, "W008",
                        "literal-baked fingerprint() in plan-cache key — "
                        "key on shape_fingerprint() so literals parameterize",
                    )
                )

    scan_scope(getattr(tree, "body", []))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_scope(node.body)


_W015_GROW = frozenset({"append", "extend", "appendleft", "add", "insert"})
_W015_EVICT = frozenset({"pop", "popitem", "popleft", "clear", "discard", "remove"})
_W015_DICTLIKE = frozenset({"dict", "OrderedDict", "defaultdict", "Counter"})
_W015_SEQLIKE = frozenset({"list", "set", "deque"})
# method-name fragments marking the request-serving path — growth in setup /
# registration / teardown methods is a topology-sized one-shot, not a leak
_W015_SERVING = (
    "execute", "query", "handle", "scatter", "admit",
    "record", "check", "serve", "request", "do_",
)


def _check_w015(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """Unbounded container growth on a serving path: an attribute born
    unbounded in `__init__` (list/set/dict literal, `deque()` with no
    maxlen) that a serving-named method grows per request — `.append()`
    and friends, or a dict write keyed by an unbounded value (query id,
    sql, uuid; W007's hint list) — while NOTHING in the class ever evicts.
    Eviction evidence is any `.pop/.clear/.discard/...` call on the
    attribute, a `del self.x[...]`, or a reassignment outside `__init__`.
    Dict writes keyed by bounded label spaces (table/segment/server names)
    never flag: only per-request key spaces grow without bound."""
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        # --- pass 1: containers created unbounded in __init__ ------------
        unbounded: Dict[str, str] = {}  # attr -> "dict" | "seq"
        init = next(
            (n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == "__init__"),
            None,
        )
        if init is None:
            continue
        for n in ast.walk(init):
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(n, ast.Assign):
                targets, value = n.targets, n.value
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                targets, value = [n.target], n.value
            if value is None:
                continue
            kind: Optional[str] = None
            if isinstance(value, ast.Dict):
                kind = "dict"
            elif isinstance(value, (ast.List, ast.Set)):
                kind = "seq"
            elif isinstance(value, ast.Call):
                fn = value.func
                fname = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else None
                )
                if fname in _W015_DICTLIKE:
                    kind = "dict"
                elif fname in _W015_SEQLIKE:
                    if fname == "deque" and any(k.arg == "maxlen" for k in value.keywords):
                        kind = None  # bounded ring buffer
                    else:
                        kind = "seq"
            if kind is None:
                continue
            for t in targets:
                attr = _self_attr(t)
                if attr is not None:
                    unbounded[attr] = kind
        if not unbounded:
            continue
        # --- pass 2: eviction evidence anywhere in the class exempts -----
        for n in ast.walk(cls):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _W015_EVICT
            ):
                attr = _self_attr(n.func.value)
                if attr is not None:
                    unbounded.pop(attr, None)
            elif isinstance(n, ast.Delete):
                for t in n.targets:
                    base = t.value if isinstance(t, ast.Subscript) else t
                    attr = _self_attr(base)
                    if attr is not None:
                        unbounded.pop(attr, None)
        for meth in cls.body:
            if not isinstance(meth, ast.FunctionDef) or meth.name == "__init__":
                continue
            for n in ast.walk(meth):
                targets = (
                    n.targets if isinstance(n, ast.Assign)
                    else [n.target] if isinstance(n, (ast.AnnAssign, ast.AugAssign))
                    else []
                )
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        unbounded.pop(attr, None)  # rebuilt/reset elsewhere
        if not unbounded:
            continue
        # --- pass 3: growth inside serving-named methods -----------------
        for meth in cls.body:
            if not isinstance(meth, ast.FunctionDef):
                continue
            low = meth.name.lower()
            if not any(h in low for h in _W015_SERVING):
                continue
            for n in ast.walk(meth):
                if (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _W015_GROW
                ):
                    attr = _self_attr(n.func.value)
                    if attr in unbounded and unbounded[attr] != "dict":
                        findings.append(
                            Finding(
                                path, n.lineno, "W015",
                                f"self.{attr}.{n.func.attr}(...) in serving method "
                                f"{meth.name!r} grows without bound — no eviction "
                                f"anywhere in class {cls.name!r}",
                            )
                        )
                # dict growth: subscript-store or setdefault keyed by an
                # unbounded (per-request) value
                key: Optional[ast.expr] = None
                attr = None
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        if isinstance(t, ast.Subscript):
                            a = _self_attr(t.value)
                            if a in unbounded and unbounded[a] == "dict":
                                key, attr = t.slice, a
                elif (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "setdefault"
                    and n.args
                ):
                    a = _self_attr(n.func.value)
                    if a in unbounded and unbounded[a] == "dict":
                        key, attr = n.args[0], a
                if key is None:
                    continue
                keyed_unbounded = False
                for kn in ast.walk(key):
                    name = kn.id if isinstance(kn, ast.Name) else (
                        kn.attr if isinstance(kn, ast.Attribute) else None
                    )
                    if name is not None and _unbounded_hint(name):
                        keyed_unbounded = True
                        break
                if keyed_unbounded:
                    findings.append(
                        Finding(
                            path, n.lineno, "W015",
                            f"self.{attr}[...] keyed by a per-request value in "
                            f"serving method {meth.name!r} grows without bound — "
                            f"no eviction anywhere in class {cls.name!r}",
                        )
                    )


# path fragments naming durability artifacts: a torn write here IS data loss
_W016_PATH_HINTS = ("checkpoint", "journal", "snapshot", "manifest", "metadata")
# function-name fragments marking commit/persist paths
_W016_FUNC_HINTS = ("commit", "checkpoint", "journal", "snapshot", "persist")


def _check_w016(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """Durable-write discipline: a bare `open(target, "w"/"wb")` aimed at a
    durability artifact must live in a function that commits via
    tmp-fsync-replace (os.fsync AND os.replace both called, in any order —
    the write-ahead idiom) or delegates to the spi.filesystem
    durable_write_* helpers.  Without that, a crash mid-write leaves a torn
    half-file where the committed state used to be.  Scope is the enclosing
    function: the rule checks discipline where the write happens, so a
    clean helper used from many callers stays clean everywhere."""

    def scope_nodes(body: List[ast.stmt]) -> List[ast.AST]:
        nodes: List[ast.AST] = []
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            nodes.append(n)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested function: its own discipline, its own pass
            stack.extend(ast.iter_child_nodes(n))
        return nodes

    def call_name(n: ast.AST) -> Optional[str]:
        if not isinstance(n, ast.Call):
            return None
        fn = n.func
        if isinstance(fn, ast.Name):
            return fn.id
        if isinstance(fn, ast.Attribute):
            return fn.attr
        return None

    def write_mode(call: ast.Call) -> Optional[str]:
        mode = call.args[1] if len(call.args) > 1 else next(
            (k.value for k in call.keywords if k.arg == "mode"), None
        )
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            return mode.value
        return None

    def scan_scope(func_name: str, body: List[ast.stmt]) -> None:
        nodes = scope_nodes(body)
        disciplined = False
        has_fsync = has_replace = False
        for n in nodes:
            name = call_name(n)
            if name == "fsync":
                has_fsync = True
            elif name == "replace":
                has_replace = True
            elif name is not None and name.startswith("durable_write"):
                disciplined = True
        disciplined = disciplined or (has_fsync and has_replace)
        if disciplined:
            return
        low_fn = func_name.lower()
        fn_is_commit_path = any(h in low_fn for h in _W016_FUNC_HINTS)
        for n in nodes:
            if call_name(n) != "open" or not n.args:
                continue
            mode = write_mode(n)
            if mode is None or not mode.startswith("w"):
                continue
            target = ast.unparse(n.args[0]).lower()
            if fn_is_commit_path or any(h in target for h in _W016_PATH_HINTS):
                findings.append(
                    Finding(
                        path, n.lineno, "W016",
                        f"open({ast.unparse(n.args[0])}, {mode!r}) writes a durability "
                        f"artifact in place — commit via tmp + os.fsync + os.replace "
                        f"(or spi.filesystem.durable_write_*) so a crash can't tear it",
                    )
                )

    scan_scope("<module>", getattr(tree, "body", []))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_scope(node.name, node.body)


_W017_CLOCK_FUNCS = frozenset({"perf_counter", "monotonic"})
_W017_FENCE_FUNCS = frozenset({"synchronize", "elapsed_time", "cpu"})
# the port's kernel wrappers: each call enqueues a CUDA launch and returns
# before the card has run it (ops/fused_scan.py, ops/funnel_scan.py)
_W017_LAUNCHES = frozenset({"fused_group_tables", "scan_runs", "funnel_reach"})


def _is_perf_clock_call(node: ast.AST) -> bool:
    """Call to time.perf_counter / time.monotonic (module attr or bare)."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (fn.id if isinstance(fn, ast.Name) else None)
    return name in _W017_CLOCK_FUNCS


def _w017_dispatch_names(tree: ast.AST) -> Set[str]:
    """Names that launch asynchronously when called: the kernel wrappers
    and `f = torch.func.vmap(...)` assignment targets (a vmapped closure
    reaches the fused scan's member-axis launch)."""
    out: Set[str] = set(_W017_LAUNCHES)
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
            and _is_vmap_func(node.value.func)
        ):
            out.add(node.targets[0].id)
    return out


def _check_w017(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """Unfenced wall-clock timing of an async CUDA launch: between a
    perf_counter/monotonic timer start and the subtraction that stops it,
    a kernel wrapper (or a vmapped closure) is called with no
    synchronize() / elapsed_time / .cpu() before the stop.  CUDA launches
    are async — the elapsed time then measures the enqueue, not the
    kernel.

    Deliberately narrow, as in the JAX package: only calls of the kernel
    wrappers by name (bare or `module.wrapper(...)`) and of vmap-bound
    names count as launches (engine code calling `plan.fn(...)` times its
    host dispatch and is out of scope), and a fence anywhere between the
    launch and the stop — including wrapping the launch itself,
    `f(x).cpu()` — clears it."""
    dispatch_names = _w017_dispatch_names(tree)

    def scope_nodes(body: List[ast.stmt]) -> List[ast.AST]:
        nodes: List[ast.AST] = []
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            nodes.append(n)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested scope: its own timers, its own pass
            stack.extend(ast.iter_child_nodes(n))
        return nodes

    def scan_scope(body: List[ast.stmt]) -> None:
        nodes = scope_nodes(body)
        starts: List[tuple] = []  # (lineno, timer name)
        timer_names: Set[str] = set()
        dispatches: List[int] = []
        fences: List[int] = []
        for n in nodes:
            if (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and _is_perf_clock_call(n.value)
            ):
                starts.append((n.lineno, n.targets[0].id))
                timer_names.add(n.targets[0].id)
            elif isinstance(n, ast.Call):
                fn = n.func
                name = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else None
                )
                if name in _W017_FENCE_FUNCS:
                    fences.append(n.lineno)
                elif (isinstance(fn, ast.Name) and fn.id in dispatch_names) or (
                    isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.attr in _W017_LAUNCHES
                ):
                    dispatches.append(n.lineno)
        if not timer_names or not dispatches:
            return
        for n in nodes:
            if not (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)):
                continue
            used = {
                x.id for x in ast.walk(n) if isinstance(x, ast.Name) and x.id in timer_names
            }
            for tname in used:
                begins = [ln for ln, name in starts if name == tname and ln <= n.lineno]
                if not begins:
                    continue
                begin = max(begins)
                between = [d for d in dispatches if begin < d <= n.lineno]
                if not between:
                    continue
                last_dispatch = max(between)
                if any(last_dispatch <= f <= n.lineno for f in fences):
                    continue
                findings.append(
                    Finding(
                        path, n.lineno, "W017",
                        f"elapsed-time stop for timer '{tname}' after a CUDA launch "
                        f"(line {last_dispatch}) with no synchronize()/elapsed_time/.cpu() fence — "
                        f"an async launch means this times the enqueue, not the kernel",
                    )
                )
                break  # one finding per stop expression

    scan_scope(getattr(tree, "body", []))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_scope(node.body)


_SUPPRESS_MARK = "pinot-lint:"


def parse_suppressions(src: str) -> Dict[int, Optional[Set[str]]]:
    """Per-line `# pinot-lint: disable=W0xx[,W0yy]` markers.

    Returns {lineno: set of suppressed rule ids} — the value None means
    every rule is suppressed on that line (`disable=all`).  Honored by the
    per-file rules (lint_source) and the interprocedural passes (engine).
    """
    out: Dict[int, Optional[Set[str]]] = {}
    for lineno, text in enumerate(src.splitlines(), start=1):
        if _SUPPRESS_MARK not in text:
            continue
        tail = text.split(_SUPPRESS_MARK, 1)[1]
        if "disable=" not in tail:
            continue
        spec = tail.split("disable=", 1)[1].split("#", 1)[0].strip()
        if not spec:
            continue
        if spec.lower() == "all":
            out[lineno] = None
        else:
            out[lineno] = {r.strip().upper() for r in spec.split(",") if r.strip()}
    return out


def is_suppressed(f: Finding, suppressions: Dict[int, Optional[Set[str]]]) -> bool:
    rules = suppressions.get(f.line, "absent")
    if rules == "absent":
        return False
    return rules is None or f.rule in rules


_W018_BLOCKING_ATTRS = frozenset({
    "synchronize", "recv", "recv_into", "sendall",
    "accept", "connect", "create_connection", "item", "tolist", "cpu", "numpy",
})


def _check_w018(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """Blocking call inside the async batch-dispatch path.  Scope: methods
    of classes named *Batcher*, plus functions named pump/_pump or
    containing "dispatch_loop".  These run under (or are the tick of) the
    coalescing scheduler — a sleep, device fence (.synchronize()), host
    read of a tensor (.item/.tolist/.cpu/.numpy) or socket wait there
    stalls every key's pending groups at once.
    Condition.wait (the timed wakeup) is deliberately out of the blocking
    set: it is how the worker sleeps WITHOUT holding up a flush."""
    scopes: List[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and "Batcher" in node.name:
            scopes.extend(
                n for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            )
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in ("pump", "_pump") or "dispatch_loop" in node.name:
                scopes.append(node)
    seen: Set[int] = set()
    for fn in scopes:
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            blocked = None
            if isinstance(f, ast.Name) and f.id == "sleep":
                blocked = "sleep"
            elif isinstance(f, ast.Attribute):
                if f.attr == "sleep" or f.attr in _W018_BLOCKING_ATTRS:
                    blocked = f.attr
            if blocked:
                findings.append(Finding(
                    path, n.lineno, "W018",
                    f"blocking call `{blocked}` inside async batch-dispatch "
                    f"path `{fn.name}` — head-of-line blocks every coalesced query",
                ))


_W019_SERVER_CALLS = frozenset({"execute", "execute_batch"})


def _check_w019(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """W019: retry/hedge loop discipline.  A `while` loop that (re-)issues
    server calls — `.execute(...)` / `.execute_batch(...)` — is the failover
    or hedging shape; it must (a) bound its re-issue rate with a backoff
    (some sleep/_sleep call inside the loop body) and (b) route every server
    call through the cooperative-cancel contract (cancel=/cancels= keyword),
    so an abandoned attempt can be killed between kernels instead of burning
    device time to completion.  `for` loops are exempt: a fan-out over an
    assignment is not a retry."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.While):
            continue
        server_calls = []
        has_backoff = False
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in _W019_SERVER_CALLS:
                server_calls.append(n)
            if (isinstance(f, ast.Name) and f.id in ("sleep", "_sleep")) or (
                isinstance(f, ast.Attribute) and f.attr in ("sleep", "_sleep")
            ):
                has_backoff = True
        if not server_calls:
            continue
        if not has_backoff:
            findings.append(Finding(
                path, node.lineno, "W019",
                "retry loop re-issues a server call with no bounded backoff "
                "(no sleep/_sleep in the loop body) — a tight retry storm "
                "under failure",
            ))
        for call in server_calls:
            if not any(kw.arg in ("cancel", "cancels") for kw in call.keywords):
                findings.append(Finding(
                    path, call.lineno, "W019",
                    "server call re-issued in a retry loop without cancel=/"
                    "cancels= — the abandoned attempt can never be "
                    "cooperatively cancelled and burns device time to "
                    "completion",
                ))


_W021_SEGMENT_OPERAND = re.compile(
    r"codes|packed|values|nulls|mv_len|lengths|column|segment"
)
_W021_STAGING_SCOPE = re.compile(r"to_device|stage")


def _w021_ships_segment_operand(node: ast.AST) -> bool:
    """Any identifier in the shipped expression smells segment-sized."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and _W021_SEGMENT_OPERAND.search(sub.id):
            return True
        if isinstance(sub, ast.Attribute) and _W021_SEGMENT_OPERAND.search(sub.attr):
            return True
    return False


# files that ARE the budgeted copy engine: the staging stream's pinned
# ring and copy stream, and the residency manager's charge/evict ledger
_W021_STAGING_FILES = ("parallel/staging.py", "segment/residency.py")
_W021_TENSOR_CTORS = frozenset({"as_tensor", "tensor", "from_numpy"})


def _w021_device_arg(node: ast.AST) -> bool:
    """`.to(...)`'s target is a device (not a dtype): a `device=` keyword,
    a "cuda..." string, or a first argument whose identifier mentions a
    device (`dev`, `device`, `self.device`, `torch.device(...)`)."""
    if not isinstance(node, ast.Call):
        return False
    if any(k.arg == "device" for k in node.keywords):
        return True
    if not node.args:
        return False
    a = node.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value.startswith("cuda")
    for sub in ast.walk(a):
        name = sub.id if isinstance(sub, ast.Name) else (sub.attr if isinstance(sub, ast.Attribute) else None)
        if name is not None and "dev" in name.lower():
            return True
    return False


def _w021_copy(call: ast.Call) -> Optional[ast.AST]:
    """The shipped operand of a host->device copy call, else None:
    `x.to(device)`, `x.cuda()`, `torch.as_tensor/tensor/from_numpy(x,
    device=...)`."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr == "cuda" and not call.args:
        return f.value
    if f.attr == "to" and _w021_device_arg(call):
        return f.value
    if (
        f.attr in _W021_TENSOR_CTORS
        and isinstance(f.value, ast.Name)
        and f.value.id == "torch"
        and call.args
        and any(k.arg == "device" for k in call.keywords)
    ):
        return call.args[0]
    return None


def _check_w021(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """W021: a segment-sized synchronous host->device copy outside the
    staging stream.

    Tiered storage (segment/residency.py) requires every segment-shaped
    host->device copy to run under a staging OWNER: charged against the
    residency budget (so eviction keeps device memory bounded) and issued
    on the copy stream (parallel/staging.py).  A bare `.to(device)` /
    `.cuda()` / `torch.as_tensor(..., device=)` of column arrays anywhere
    else on the serving path is an unbudgeted pin plus a synchronous
    pageable copy.  Functions whose name marks them as the staging path
    (`to_device`, `*stage*`) and the two staging files are exempt — they
    ARE the budgeted copy engine."""
    norm = path.replace(os.sep, "/")
    if norm.endswith(_W021_STAGING_FILES):
        return

    def visit(node: ast.AST, exempt: bool) -> None:
        for child in ast.iter_child_nodes(node):
            child_exempt = exempt
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_exempt = bool(_W021_STAGING_SCOPE.search(child.name))
            if isinstance(child, ast.Call) and not exempt:
                shipped = _w021_copy(child)
                if shipped is not None and _w021_ships_segment_operand(shipped):
                    findings.append(Finding(
                        path, child.lineno, "W021",
                        "segment-sized host->device copy outside the staging "
                        "stream — unbudgeted device pin and a synchronous "
                        "copy on the serving path; route it through "
                        "to_device/residency staging",
                    ))
            visit(child, child_exempt)

    visit(tree, False)


# the port's mesh builders and folds (parallel/mesh.py) and the
# torch.distributed collectives: the calls an axis name reaches
_W025_COLLECTIVES = frozenset({
    "Mesh", "default_mesh", "normalize_axes", "combine_hierarchical",
    "psum_hierarchical", "pmin_hierarchical", "pmax_hierarchical", "psum_ordered",
    "fold_field", "fold_partials",
    "all_reduce", "all_gather", "all_to_all", "reduce_scatter", "broadcast",
})
_W025_AXIS_LITERALS = frozenset({"seg", "replica", "shard"})
_W025_AXIS_KEYWORDS = ("axis_name", "axis_names", "axis", "axes")


def _w025_axis_literal(node: ast.AST) -> bool:
    """A bare axis-name literal: the string itself, or a tuple/list literal
    whose elements include one (the 2-D `("replica", "shard")` spelling)."""
    if isinstance(node, ast.Constant) and node.value in _W025_AXIS_LITERALS:
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(
            isinstance(e, ast.Constant) and e.value in _W025_AXIS_LITERALS for e in node.elts
        )
    return False


def _check_w025(path: str, tree: ast.AST, findings: List[Finding]) -> None:
    """W025: bare mesh-axis string literals at mesh builder and fold call
    sites.

    The 2-D (replica x shard) mesh made axis names a TOPOLOGY decision:
    engines carry the mesh's actual axes (parallel/mesh.data_axes) and
    folds must reduce hierarchically over them.  A builder or fold called
    with a hardcoded "seg"/"replica"/"shard" literal binds the call site to
    one topology.  parallel/mesh.py is exempt: it DEFINES the names (the
    call sites use its SEG_AXIS / DATA_AXES constants)."""
    norm = path.replace(os.sep, "/")
    if norm.endswith("parallel/mesh.py"):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (f.id if isinstance(f, ast.Name) else None)
        if name not in _W025_COLLECTIVES:
            continue
        operands = list(node.args) + [
            kw.value for kw in node.keywords if kw.arg in _W025_AXIS_KEYWORDS
        ]
        for arg in operands:
            if _w025_axis_literal(arg):
                findings.append(Finding(
                    path, node.lineno, "W025",
                    f"mesh call {name}(...) with a bare mesh-axis "
                    "string literal — binds the call site to one mesh "
                    "topology; thread the engine's mesh (or the "
                    "parallel/mesh axis constants) instead",
                ))
                break


def lint_source(src: str, path: str = "<string>", threaded: bool = False) -> List[Finding]:
    """Lint one module's source.  `threaded` enables the cluster/-scoped
    rules (W004 shared-state races, W006 swallowed exceptions, W015
    unbounded serving-path growth, W018 blocking calls in async
    batch-dispatch paths, W019 retry loops).  W003 and W020 have no torch
    object and report nothing."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "E000", f"syntax error: {e.msg}")]

    vmapped = _vmapped_function_names(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        if node.name in vmapped or _has_vmap_decorator(node):
            rules = _KernelRules(path, findings)
        elif _is_plain_version(node):
            rules = _KernelRules(path, findings, syncs=False)
        else:
            continue
        for stmt in node.body:
            rules.visit(stmt)
    _check_sync_in_loop(path, tree, findings)
    _check_w005(path, tree, findings)
    _check_w007(path, tree, findings)
    _check_w008(path, tree, findings)
    _check_w016(path, tree, findings)
    _check_w017(path, tree, findings)
    _check_w021(path, tree, findings)
    _check_w022(path, tree, findings)
    _check_w025(path, tree, findings)
    _check_w026(path, tree, findings)
    if threaded:
        _check_w004(path, tree, findings)
        _check_w006(path, tree, findings)
        _check_w015(path, tree, findings)
        _check_w018(path, tree, findings)
        _check_w019(path, tree, findings)
    suppressions = parse_suppressions(src)
    if suppressions:
        findings = [f for f in findings if not is_suppressed(f, suppressions)]
    return findings


def lint_paths(paths: Iterable[str], pkg_root: Optional[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    for p in paths:
        rel = os.path.relpath(p, pkg_root) if pkg_root else p
        threaded = os.sep + "cluster" + os.sep in p or rel.startswith("cluster" + os.sep)
        with open(p, "r", encoding="utf-8") as f:
            findings.extend(lint_source(f.read(), path=rel, threaded=threaded))
    return findings


def lint_tree(root: Optional[str] = None) -> List[Finding]:
    """Lint every .py file under the pinot_tpu package (default: this one)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            if name.endswith(".py"):
                paths.append(os.path.join(dirpath, name))
    return lint_paths(sorted(paths), pkg_root=os.path.dirname(root))
