"""Host-device sync auditor (W013/W014) over a Project, on torch.

Port of pinot_tpu/analysis/device_sync.py, retargeted from jax.numpy to
torch.  Propagates "device value" taint from the sources below through
local dataflow and the call graph (a function whose return value is
tainted marks every call site tainted — a fixpoint over the whole
package), then flags the two ways a CUDA value silently stalls the async
launch pipeline *on the warm query path*:

  sources  torch.* tensor ops (any torch function but the metadata and
           host-result ones below; torch.from_numpy is a view of a host
           array), factories with a `device=` keyword or a device argument,
           tensor methods on tainted values, `.to(device)` / `.cuda()`, and
           the kernel wrappers (ops/fused_scan.py `fused_group_tables`,
           ops/funnel_scan.py `scan_runs` and `funnel_reach`).
  W013     implicit device->host sync: float()/int()/bool(), .item(),
           .tolist(), .numpy() or np.*() on a device value;
           torch.cuda.synchronize() and an event's or stream's
           .synchronize() (unconditionally: the warm path's one sanctioned
           fence is ServerInstance._device_wait, on the allowlist below);
           and the ops whose output shape depends on the data, each of
           which waits on the card under CUDA: torch.nonzero / argwhere /
           one-argument torch.where, masked_select, torch.unique, and
           repeat_interleave without output_size (the torch.* forms
           unconditionally, the method forms on device values), and
           boolean-mask indexing `x[mask]` of a device value (a mask is a
           device comparison, a logical op over one, or a device value
           whose name mentions "mask").
  W014     host control flow (if/while) branching on a device value.

The sanitizer is an explicit `.cpu()` / `.to("cpu")` — the drain the
collect points use, the role jax.device_get plays in the JAX pass.

Warm path = parallel/engine.py, query/reduce.py, cluster/server.py,
ops/* (the JAX pass's list).  Bodies passed to torch.func.vmap by name
(or decorated with it) are excluded — under vmap a host read raises
rather than syncs (repo_lint W002 covers that side).  Taint does not
flow through parameters (only through returns); that keeps the pass fast
and false-positive-shy at the cost of missing device values handed down
as arguments.

`audit_sites` classifies call sites (file, line) that torch itself
reports as synchronizing (torch.cuda.set_sync_debug_mode) against this
pass: a finding, a baseline entry, an inline suppression, the
allowlisted fence, the sanitizer (an explicit `.cpu()` drain, which the
pass sanctions), or nothing (a gap of the auditor).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pinot_tpu_torch.analysis.engine import (
    FunctionInfo,
    Pass,
    Project,
    _baseline_matches,
    load_baseline,
)
from pinot_tpu_torch.analysis.repo_lint import Finding, _w021_device_arg, is_suppressed

WARM_PATH_SUFFIXES = (
    "parallel/engine.py",
    "query/reduce.py",
    "cluster/server.py",
)
WARM_PATH_DIRS = ("/ops/",)

# the sanctioned warm-path fence: the trace's `device_wait`, one event
# recorded after the last launch and waited on, splitting device time from
# host dispatch in the trace tree (execute and execute_batch both call it;
# the JAX pass names those two methods, whose block_until_ready it is)
ALLOWED_SYNCS: Set[Tuple[str, str]] = {
    ("cluster/server.py", "ServerInstance._device_wait"),
}

# torch functions whose RESULT lives on the host (metadata, handles,
# context managers, callables) — never device values
_HOST_RESULT_TORCH = {
    "torch.device", "torch.dtype", "torch.iinfo", "torch.finfo",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.numel", "torch.get_default_dtype", "torch.set_default_dtype",
    "torch.promote_types", "torch.result_type", "torch.can_cast",
    "torch.Size", "torch.Generator", "torch.manual_seed", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.is_grad_enabled",
    "torch.get_num_threads", "torch.set_num_threads", "torch.compile",
    "torch.from_numpy", "torch.frombuffer",
}
_HOST_RESULT_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.profiler.", "torch.library.",
    "torch.utils.", "torch.autograd.", "torch.distributed.", "torch.func.",
    "torch.jit.", "torch.testing.",
)
# factories make a host tensor unless given a device (or a device value)
_FACTORIES = {
    "zeros", "ones", "empty", "full", "arange", "linspace", "logspace",
    "eye", "tensor", "as_tensor", "rand", "randn", "randint", "randperm",
    "empty_strided", "scalar_tensor",
}
# the kernel wrappers: each returns tensors on the launch's device
_KERNEL_WRAPPERS = (
    ".ops.fused_scan.fused_group_tables",
    ".ops.funnel_scan.scan_runs",
    ".ops.funnel_scan.funnel_reach",
)
_DEVICE_CALLS = {"torch.cuda.synchronize"}  # a sink, named for the scan
_METADATA_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "nbytes", "itemsize",
    "layout", "requires_grad", "is_sparse", "names",
}
# tensor methods whose result is host: metadata, and the sinks
_HOST_RESULT_METHODS = {
    "item", "tolist", "numpy", "cpu", "numel", "dim", "ndimension", "size",
    "element_size", "data_ptr", "stride", "storage_offset", "is_contiguous",
    "nelement", "get_device", "is_floating_point", "untyped_storage",
}
_SINK_METHODS = {"item", "tolist", "numpy"}
# data-dependent output shapes: the op waits on the card for the count
_SHAPE_SYNC_TORCH = {
    "torch.nonzero", "torch.argwhere", "torch.masked_select", "torch.unique",
    "torch.unique_consecutive", "torch.repeat_interleave",
}
_SHAPE_SYNC_METHODS = {
    "nonzero", "argwhere", "masked_select", "unique", "unique_consecutive",
    "repeat_interleave",
}
# ops whose result is a boolean mask (for boolean-mask indexing)
_BOOL_TORCH = {
    "isin", "isnan", "isinf", "isfinite", "isneginf", "isposinf", "eq", "ne",
    "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
    "logical_xor", "greater", "less", "greater_equal", "less_equal",
    "not_equal", "equal",
}

_TRACE_WRAPPERS = ("vmap",)


def _callable_name(func: ast.AST) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _is_trace_wrapper(func: ast.AST) -> bool:
    name = _callable_name(func)
    return any(w in name for w in _TRACE_WRAPPERS)


def traced_names(tree: ast.Module) -> Set[str]:
    """Function names whose bodies run under torch.func.vmap: decorated
    with it, or passed to it by name anywhere in the module."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_trace_wrapper(node.func):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name):
                    names.add(arg.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                if _is_trace_wrapper(d) or any(
                    _is_trace_wrapper(a)
                    for a in (dec.args if isinstance(dec, ast.Call) else [])
                ):
                    names.add(node.name)
    return names


def _is_cpu_target(call: ast.Call) -> bool:
    """`.to("cpu")` / `.to(torch.device("cpu"))` / `.to(device="cpu")`."""
    args = list(call.args) + [k.value for k in call.keywords if k.arg == "device"]
    for a in args[:1] if call.args else args:
        for sub in ast.walk(a):
            if isinstance(sub, ast.Constant) and sub.value == "cpu":
                return True
    return False


class _Scope:
    """Flow-sensitive local taint for one function body."""

    def __init__(
        self,
        pass_: "DeviceSyncPass",
        fi: FunctionInfo,
        project: Project,
        returns_device: Set[str],
        module_traced: Set[str],
        findings: Optional[List[Finding]],
    ) -> None:
        self.p = pass_
        self.fi = fi
        self.project = project
        self.returns_device = returns_device
        self.module_traced = module_traced
        self.findings = findings
        self.taint: Set[str] = set()
        self.bool_taint: Set[str] = set()  # device values that are masks
        self.jitted_locals: Set[str] = set()
        self.returns_tainted = False
        self._reported: Set[Tuple[int, str]] = set()

    # -- expression taint --------------------------------------------------

    def tainted(self, e: Optional[ast.AST]) -> bool:
        if e is None:
            return False
        if isinstance(e, ast.Name):
            return e.id in self.taint
        if isinstance(e, ast.Call):
            return self._call_tainted(e)
        if isinstance(e, ast.Attribute):
            return self.tainted(e.value) and e.attr not in _METADATA_ATTRS
        if isinstance(e, ast.Subscript):
            return self.tainted(e.value)
        if isinstance(e, ast.Compare):
            # `is`/`is not` never touch values; `in`/`not in` against a host
            # container of device values (the params-dict idiom) is a host
            # key lookup, not a sync
            _HOST_OPS = (ast.Is, ast.IsNot, ast.In, ast.NotIn)
            t = False
            if not isinstance(e.ops[0], _HOST_OPS):
                t = self.tainted(e.left)
            for op, comp in zip(e.ops, e.comparators):
                if not isinstance(op, _HOST_OPS):
                    t = t or self.tainted(comp)
            return t
        if isinstance(e, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        # generic containers/operators: tainted if any child expression is
        return any(
            self.tainted(c)
            for c in ast.iter_child_nodes(e)
            if isinstance(c, ast.expr)
        )

    def is_mask(self, e: ast.AST) -> bool:
        """A device boolean mask: a comparison of device values, a logical
        op over masks, a torch predicate, or a device value named *mask*."""
        if not self.tainted(e):
            return False
        if isinstance(e, ast.Name):
            return e.id in self.bool_taint or "mask" in e.id.lower()
        if isinstance(e, ast.Attribute):
            return "mask" in e.attr.lower()
        if isinstance(e, ast.Compare):
            return True
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self.is_mask(e.operand)
        if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(e.left) or self.is_mask(e.right)
        if isinstance(e, ast.Call):
            name = _callable_name(e.func)
            if name in _BOOL_TORCH or name == "bool":
                return True
            if name == "to" and any(
                isinstance(a, ast.Attribute) and a.attr == "bool" for a in e.args
            ):
                return True
        return False

    def _call_tainted(self, e: ast.Call) -> bool:
        target = self.project.resolve_expr(self.fi, e.func)
        if target is not None:
            if target in _HOST_RESULT_TORCH or target.startswith(_HOST_RESULT_PREFIXES):
                return False
            if target.endswith(_KERNEL_WRAPPERS):
                return True
            if target.startswith("torch."):
                leaf = target.rsplit(".", 1)[-1]
                if leaf in _FACTORIES or leaf.endswith("_like"):
                    return any(
                        k.arg == "device" and not _is_cpu_target(e) for k in e.keywords
                    ) or any(self.tainted(a) for a in e.args)
                return True  # a torch op: its result is a device value
            if target in self.returns_device:
                return True
            if target.startswith("numpy."):
                return False  # host result (and possibly a sink — checked there)
        if isinstance(e.func, ast.Name) and e.func.id in self.jitted_locals:
            return True
        if isinstance(e.func, ast.Attribute):
            attr = e.func.attr
            if attr in _HOST_RESULT_METHODS:
                return False
            if attr == "to" and _is_cpu_target(e):
                return False  # .to("cpu") is the sanitizer
            if attr == "cuda" or (attr == "to" and _w021_device_arg(e)):
                return True
            # method call on a device value stays on device (x.sum(), x.to(dtype))
            return self.tainted(e.func.value)
        return False

    # -- sinks -------------------------------------------------------------

    def _warm(self) -> bool:
        rel = self.fi.module.relpath
        return rel.endswith(self.p.warm_suffixes) or any(
            d in f"/{rel}" for d in self.p.warm_dirs
        )

    def _allowed(self) -> bool:
        sym = self._symbol()
        rel = self.fi.module.relpath
        return any(rel.endswith(p) and sym == s for p, s in self.p.allowed_syncs)

    def _symbol(self) -> str:
        if self.fi.cls is not None:
            return f"{self.fi.cls.name}.{self.fi.name}"
        return self.fi.name

    def _emit(self, line: int, rule: str, msg: str, hint: str) -> None:
        if self.findings is None:
            return
        key = (line, rule)
        if key in self._reported:
            return
        self._reported.add(key)
        self.findings.append(
            Finding(self.fi.module.relpath, line, rule, msg, hint=hint, symbol=self._symbol())
        )

    def check_call_sink(self, e: ast.Call) -> None:
        if self.findings is None or not self._warm():
            return
        target = self.project.resolve_expr(self.fi, e.func)
        name = _callable_name(e.func)
        if name == "synchronize" or target in _DEVICE_CALLS:
            if not self._allowed():
                self._emit(
                    e.lineno,
                    "W013",
                    "synchronize() on the warm path — every call is a "
                    "full pipeline stall",
                    "drain via .cpu() at the collect point; the warm "
                    "path's one sanctioned fence is "
                    "ServerInstance._device_wait",
                )
            return
        if target in _SHAPE_SYNC_TORCH or (
            target == "torch.where" and len(e.args) == 1 and not e.keywords
        ):
            if target != "torch.repeat_interleave" or not any(
                k.arg == "output_size" for k in e.keywords
            ):
                self._emit(
                    e.lineno,
                    "W013",
                    f"{target}() has a data-dependent output shape: the host "
                    "waits on the card for its size",
                    "keep a fixed-shape form on the device (a mask, "
                    "output_size=, a padded top-k), or fetch once at the "
                    "collect point",
                )
            return
        if (
            isinstance(e.func, ast.Attribute)
            and e.func.attr in _SHAPE_SYNC_METHODS
            and self.tainted(e.func.value)
            and not (
                e.func.attr == "repeat_interleave"
                and any(k.arg == "output_size" for k in e.keywords)
            )
        ):
            self._emit(
                e.lineno,
                "W013",
                f".{e.func.attr}() on a device value has a data-dependent "
                "output shape: the host waits on the card for its size",
                "keep a fixed-shape form on the device, or fetch once at "
                "the collect point",
            )
            return
        if (
            isinstance(e.func, ast.Name)
            and e.func.id in ("float", "int", "bool")
            and any(self.tainted(a) for a in e.args)
        ):
            self._emit(
                e.lineno,
                "W013",
                f"{e.func.id}() on a device value forces an implicit "
                "device->host sync",
                "materialize once via .cpu() at the drain point, "
                "then convert on host",
            )
            return
        if (
            isinstance(e.func, ast.Attribute)
            and e.func.attr in _SINK_METHODS
            and self.tainted(e.func.value)
        ):
            self._emit(
                e.lineno,
                "W013",
                f".{e.func.attr}() on a device value forces an implicit "
                "device->host sync",
                "materialize once via .cpu() at the drain point",
            )
            return
        if target is not None and target.startswith("numpy.") and any(
            self.tainted(a) for a in e.args
        ):
            self._emit(
                e.lineno,
                "W013",
                f"{target}() on a device value forces an implicit "
                "device->host transfer",
                "keep the computation in torch on the device, or .cpu() "
                "once and reuse the host array",
            )

    def check_subscript_sink(self, e: ast.Subscript) -> None:
        """Boolean-mask indexing of a device value (a load): the result's
        length is the mask's count, which the host waits for."""
        if self.findings is None or not self._warm():
            return
        if not isinstance(e.ctx, ast.Load) or not self.tainted(e.value):
            return
        idx = e.slice
        parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        if any(self.is_mask(p) for p in parts):
            self._emit(
                e.lineno,
                "W013",
                "boolean-mask indexing of a device value has a "
                "data-dependent output shape: the host waits on the card "
                "for the mask's count",
                "keep the mask (torch.where / a masked reduction), or "
                "fetch once at the collect point",
            )

    def check_branch(self, test: ast.AST, lineno: int) -> None:
        if self.findings is None or not self._warm():
            return
        if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        ):
            return
        if self.tainted(test):
            self._emit(
                lineno,
                "W014",
                "host control flow branches on a device value (blocking "
                "transfer at the branch)",
                "hoist the decision to plan time or compute both sides with "
                "torch.where",
            )

    # -- statement walk ----------------------------------------------------

    def run(self, body: List[ast.stmt]) -> None:
        self.process_block(body)

    def process_block(self, stmts: Iterable[ast.stmt]) -> None:
        for s in stmts:
            self.process_stmt(s)

    def _scan_sinks(self, node: ast.AST) -> None:
        """Check every call and subscript in an expression tree, skipping
        deferred bodies."""
        stack = [node]
        while stack:
            cur = stack.pop()
            if isinstance(cur, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(cur, ast.Call):
                self.check_call_sink(cur)
            elif isinstance(cur, ast.Subscript):
                self.check_subscript_sink(cur)
            stack.extend(ast.iter_child_nodes(cur))

    def _assign_target(self, target: ast.AST, value_tainted: bool, is_mask: bool = False) -> None:
        if isinstance(target, ast.Name):
            if value_tainted:
                self.taint.add(target.id)
            else:
                self.taint.discard(target.id)
            if value_tainted and is_mask:
                self.bool_taint.add(target.id)
            else:
                self.bool_taint.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign_target(elt, value_tainted)
        elif isinstance(target, ast.Starred):
            self._assign_target(target.value, value_tainted)
        elif isinstance(target, ast.Subscript) and value_tainted:
            # storing a device value into a local container taints the container
            if isinstance(target.value, ast.Name):
                self.taint.add(target.value.id)

    def _note_jitted_local(self, target: ast.AST, value: ast.AST) -> None:
        if not isinstance(target, ast.Name) or not isinstance(value, ast.Call):
            return
        name = _callable_name(value.func)
        if any(w in name for w in _TRACE_WRAPPERS):
            self.jitted_locals.add(target.id)

    def process_stmt(self, s: ast.stmt) -> None:
        if isinstance(s, ast.Assign):
            self._scan_sinks(s.value)
            t = self.tainted(s.value)
            m = t and self.is_mask(s.value)
            for target in s.targets:
                self._assign_target(target, t, m)
                self._note_jitted_local(target, s.value)
            for target in s.targets:
                self._scan_sinks(target)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._scan_sinks(s.value)
                t = self.tainted(s.value)
                self._assign_target(s.target, t, t and self.is_mask(s.value))
        elif isinstance(s, ast.AugAssign):
            self._scan_sinks(s.value)
            if self.tainted(s.value):
                self._assign_target(s.target, True)
        elif isinstance(s, ast.Return):
            if s.value is not None:
                self._scan_sinks(s.value)
                if self.tainted(s.value):
                    self.returns_tainted = True
        elif isinstance(s, ast.Expr):
            self._scan_sinks(s.value)
        elif isinstance(s, ast.If):
            self._scan_sinks(s.test)
            self.check_branch(s.test, s.lineno)
            self.process_block(s.body)
            self.process_block(s.orelse)
        elif isinstance(s, ast.While):
            self._scan_sinks(s.test)
            self.check_branch(s.test, s.lineno)
            for _ in range(2):  # second pass picks up loop-carried taint
                self.process_block(s.body)
            self.process_block(s.orelse)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            self._scan_sinks(s.iter)
            iter_tainted = self.tainted(s.iter)
            for _ in range(2):
                self._assign_target(s.target, iter_tainted)
                self.process_block(s.body)
            self.process_block(s.orelse)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self._scan_sinks(item.context_expr)
                if item.optional_vars is not None:
                    self._assign_target(
                        item.optional_vars, self.tainted(item.context_expr)
                    )
            self.process_block(s.body)
        elif isinstance(s, ast.Try):
            self.process_block(s.body)
            for h in s.handlers:
                self.process_block(h.body)
            self.process_block(s.orelse)
            self.process_block(s.finalbody)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if s.name in self.module_traced:
                return  # vmapped body: a host read there raises, not syncs
            inner = _Scope(
                self.p, self.fi, self.project, self.returns_device,
                self.module_traced, self.findings,
            )
            inner.taint = set(self.taint)
            inner.bool_taint = set(self.bool_taint)
            inner.jitted_locals = set(self.jitted_locals)
            inner._reported = self._reported
            inner.process_block(s.body)
        elif isinstance(s, (ast.Assert, ast.Raise)):
            for child in ast.iter_child_nodes(s):
                self._scan_sinks(child)
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    self.taint.discard(t.id)
                    self.bool_taint.discard(t.id)


class DeviceSyncPass(Pass):
    name = "device_sync"

    def __init__(
        self,
        warm_suffixes: Optional[Tuple[str, ...]] = None,
        warm_dirs: Optional[Tuple[str, ...]] = None,
        allowed_syncs: Optional[Set[Tuple[str, str]]] = None,
    ) -> None:
        self.warm_suffixes = warm_suffixes or WARM_PATH_SUFFIXES
        self.warm_dirs = warm_dirs or WARM_PATH_DIRS
        self.allowed_syncs = allowed_syncs if allowed_syncs is not None else ALLOWED_SYNCS

    def run(self, project: Project) -> List[Finding]:
        module_traced: Dict[str, Set[str]] = {
            name: traced_names(mi.tree) for name, mi in project.modules.items()
        }

        def analyze(fi: FunctionInfo, returns_device: Set[str], findings):
            scope = _Scope(
                self, fi, project, returns_device,
                module_traced[fi.module.name], findings,
            )
            scope.run(fi.node.body)
            return scope.returns_tainted

        # fixpoint: which project functions return device values
        returns_device: Set[str] = set()
        for _ in range(8):
            changed = False
            for fi in project.functions.values():
                if fi.name in module_traced[fi.module.name]:
                    continue
                if fi.qname in returns_device:
                    continue
                if analyze(fi, returns_device, None):
                    returns_device.add(fi.qname)
                    changed = True
            if not changed:
                break

        findings: List[Finding] = []
        for fi in project.functions.values():
            if fi.name in module_traced[fi.module.name]:
                continue
            analyze(fi, returns_device, findings)
        return findings


# verdicts of audit_sites, in the order they are tried
FINDING, BASELINE, INLINE, FENCE, DRAIN, NOTHING = (
    "finding", "baseline entry", "inline suppression", "allowlisted fence", "sanitizer", "nothing",
)


def audit_sites(
    sites: Iterable[Tuple[str, int]],
    root: Optional[str] = None,
    baseline_path: Optional[str] = None,
) -> Dict[Tuple[str, int], Dict[str, str]]:
    """The auditor's verdict on each (relpath, line) site — relpaths as the
    project names them ("pinot_tpu_torch/query/executor.py").  A W013/W014
    at the line is a FINDING unless an inline `# pinot-lint: disable`
    covers it (INLINE) or the baseline matches it (BASELINE); a line inside
    an allowlisted fence's body is FENCE; a line that drains with an
    explicit `.cpu()` / `.to("cpu")` is DRAIN (the pass's sanitizer);
    anything else is NOTHING, a site the pass does not see.  Each verdict
    carries the enclosing symbol."""
    project = Project.from_tree(root)
    pass_ = DeviceSyncPass()
    raw = pass_.run(project)  # before inline suppressions
    baseline = load_baseline(baseline_path)
    by_rel = {mi.relpath: mi for mi in project.modules.values()}
    out: Dict[Tuple[str, int], Dict[str, str]] = {}
    for rel, line in sites:
        hits = [f for f in raw if f.path == rel and f.line == line]
        symbol = _enclosing_symbol(project, rel, line)
        mi = by_rel.get(rel)
        if hits:
            f = hits[0]
            if mi is not None and is_suppressed(f, mi.suppressions):
                verdict = INLINE
            elif any(_baseline_matches(e, f) for e in baseline):
                verdict = BASELINE
            else:
                verdict = FINDING
            out[(rel, line)] = {"verdict": verdict, "rule": f.rule, "symbol": f.symbol}
        elif any(rel.endswith(p) and symbol == s for p, s in pass_.allowed_syncs):
            out[(rel, line)] = {"verdict": FENCE, "rule": "", "symbol": symbol}
        elif mi is not None and _drains_at(mi.tree, line):
            out[(rel, line)] = {"verdict": DRAIN, "rule": "", "symbol": symbol}
        else:
            out[(rel, line)] = {"verdict": NOTHING, "rule": "", "symbol": symbol}
    return out


def _drains_at(tree: ast.AST, line: int) -> bool:
    """An explicit `.cpu()` / `.to("cpu")` call on `line`."""
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and n.lineno == line and isinstance(n.func, ast.Attribute):
            if n.func.attr == "cpu" or (n.func.attr == "to" and _is_cpu_target(n)):
                return True
    return False


def _enclosing_symbol(project: Project, rel: str, line: int) -> str:
    """"Class.method" or "function" of the innermost project function whose
    span holds `line` ("" at module level)."""
    best = None
    for fi in project.functions.values():
        if fi.module.relpath != rel:
            continue
        end = getattr(fi.node, "end_lineno", None) or fi.node.lineno
        if fi.node.lineno <= line <= end and (best is None or fi.node.lineno > best.node.lineno):
            best = fi
    if best is None:
        return ""
    return f"{best.cls.name}.{best.name}" if best.cls is not None else best.name
