"""Expression evaluation on device columns.

Port of pinot_tpu/query/transform.py (reference parity: pinot-core's
vectorized transform functions + TransformOperator).  Each Expr node becomes
eager torch ops over the plan's device tensors.  Null propagation is
SQL-style: a row's value is null if any input column value is null (a bool
mask beside the values; None when statically known null-free).

Result dtypes are the JAX package's, set explicitly at every node: a LITERAL
is a weakly typed Python scalar, as in JAX, and torch's own promotion
differs from JAX's where a weak operand meets a tensor (int32 * 2.5 is
float64 in the JAX package, float32 in torch) and where a 0-dim tensor
meets a row tensor.  So the internal evaluator carries a `weak` flag with
each value and `_promote` applies JAX's rules: a weak operand of the same
or a lower kind (bool < int < float) takes the other operand's dtype, of a
higher kind the kind's 64-bit default; two strong operands promote as
torch.promote_types (which agrees with JAX on the column dtypes); the
result is weak only when every operand is.  MOD by zero is 0 for integers
(jnp.mod), never a torch error.

eval_expr_host evaluates over a selected row subset on the host (selection
queries gather at most offset + limit rows); it shares the device functions
through CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.query import scalar
from pinot_tpu_torch.query.ir import Expr, ExprKind

Value = Union[torch.Tensor, bool, int, float]
# value, null-mask (None = no nulls possible)
EvalResult = Tuple[Value, Optional[torch.Tensor]]

_KIND_DEFAULT = {0: torch.bool, 1: torch.int64, 2: torch.float64}


def or_masks(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _kind(dt: torch.dtype) -> int:
    if dt == torch.bool:
        return 0
    return 2 if dt.is_floating_point else 1


def _scalar_dtype(v) -> torch.dtype:
    if isinstance(v, (bool, np.bool_)):
        return torch.bool
    if isinstance(v, (int, np.integer)):
        return torch.int64
    if isinstance(v, (float, np.floating)):
        return torch.float64
    raise TypeError(f"non-numeric literal {v!r} in an arithmetic expression")


def _dtype_of(v) -> torch.dtype:
    return v.dtype if isinstance(v, torch.Tensor) else _scalar_dtype(v)


def _promote(a, a_weak: bool, b, b_weak: bool) -> Tuple[torch.dtype, bool]:
    """JAX's result dtype (and weakness) of a binary op on a and b."""
    da, db = _dtype_of(a), _dtype_of(b)
    if a_weak == b_weak:
        return torch.promote_types(da, db), a_weak
    strong, weak = (da, db) if b_weak else (db, da)
    if _kind(weak) <= _kind(strong):
        return strong, False
    return _KIND_DEFAULT[_kind(weak)], False


def _as_tensor(v, dtype: torch.dtype, like) -> torch.Tensor:
    """v in `dtype`: a tensor cast, a scalar made a 0-dim tensor on the
    device of `like` (the other operand).  A device fill, not
    torch.tensor(v, device=...), whose host copy would wait for the stream."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.full((), v, dtype=dtype, device=dev)


# host constant arrays (derived per-code values, derived remaps) on a
# device, keyed by the array's identity and the device; the entry holds the
# array, so an id is never reused while it is cached
_DEVICE_CONSTS: Dict[Tuple[int, str], Tuple[np.ndarray, torch.Tensor]] = {}
_DEVICE_CONSTS_MAX = 256


def device_constant(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A plan's host constant on `dev`, copied once (a pageable copy to the
    card waits for the stream, so it stays out of the launch loop after the
    first query)."""
    key = (id(arr), str(dev))
    hit = _DEVICE_CONSTS.get(key)
    if hit is not None:
        return hit[1]
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    if len(_DEVICE_CONSTS) >= _DEVICE_CONSTS_MAX:
        _DEVICE_CONSTS.pop(next(iter(_DEVICE_CONSTS)))
    _DEVICE_CONSTS[key] = (arr, t)
    return t


def _mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.mod: floor-sign remainder; an integer remainder by 0 is 0."""
    if a.is_floating_point():
        return torch.remainder(a, b)
    zero = b == 0
    return torch.where(zero, torch.zeros_like(a), torch.remainder(a, torch.where(zero, torch.ones_like(b), b)))


def _pow(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # a negative literal exponent of an integer is an error, as in jnp.power
    if not a.is_floating_point() and not b.is_floating_point() and b.dim() == 0 and int(b) < 0:
        raise ValueError("Integers cannot be raised to negative powers")
    return torch.pow(a, b)


_BINARY = {
    "plus": torch.add,
    "add": torch.add,
    "minus": torch.sub,
    "sub": torch.sub,
    "times": torch.mul,
    "mult": torch.mul,
    "mod": _mod,
    "pow": _pow,
}

# unary functions that keep an integer operand's dtype, and those that
# compute in its float dtype (scalar.inexact)
_UNARY_SAME = {
    "abs": torch.abs,
    "neg": torch.neg,
    "floor": torch.floor,
    "ceiling": torch.ceil,
    "ceil": torch.ceil,
    "sign": torch.sign,
}
_UNARY_FLOAT = {
    "exp": torch.exp,
    "ln": torch.log,
    "log": torch.log,  # Pinot's LOG is natural log
    "log2": torch.log2,
    "log10": torch.log10,
    "sqrt": torch.sqrt,
}
_UNARY = set(_UNARY_SAME) | set(_UNARY_FLOAT)
_BOOL_OPS = ("__and", "__or", "__not", "__eq", "__in", "__ge", "__gt", "__le", "__lt", "__isnull")
_CMP = {"__ge": torch.ge, "__gt": torch.gt, "__le": torch.le, "__lt": torch.lt, "__eq": torch.eq}


def _binop(fn, a, a_weak, b, b_weak):
    """fn(a, b) in JAX's result dtype.  Two weak scalars compute on 0-dim
    tensors and give a weak Python scalar back."""
    dt, weak = _promote(a, a_weak, b, b_weak)
    out = fn(_as_tensor(a, dt, b), _as_tensor(b, dt, a))
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return out.item(), True
    return out, weak


def _unary(op: str, v, weak):
    t = v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=_scalar_dtype(v))
    if op in _UNARY_SAME:
        if t.dtype == torch.bool and op in ("neg", "sign"):
            raise TypeError(f"{op} does not accept a boolean operand")
        out = t if t.dtype == torch.bool or (op in ("floor", "ceiling", "ceil") and not t.is_floating_point()) \
            else _UNARY_SAME[op](t)
    else:
        if weak and not t.is_floating_point():
            t = t.to(torch.float64)  # a weak int becomes the default float
        out = _UNARY_FLOAT[op](scalar.inexact(t))
    if not isinstance(v, torch.Tensor):
        return out.item(), True
    return out, weak


def astype(vals, dt: torch.dtype, like=None) -> torch.Tensor:
    """dtype cast that also accepts the Python scalars LITERAL nodes produce
    (a strong 0-dim tensor, as jnp.asarray(v, dtype) is)."""
    if isinstance(vals, torch.Tensor):
        return vals.to(dt)
    return _as_tensor(vals, dt, like)


def as_row_array(vals, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a literal to a row-shaped float64 tensor shaped like `like`;
    pass tensors through."""
    if isinstance(vals, torch.Tensor):
        return vals
    return torch.full(tuple(like.shape), float(vals), dtype=torch.float64, device=like.device)


def column_values(name: str, segment, cols: Dict) -> EvalResult:
    """Numeric values of a column from its device entry (a dictionary gather
    for dict-encoded numerics) and its null mask."""
    c = segment.column(name)
    entry = cols[name]
    if c.data_type.is_string_like:
        raise ValueError(
            f"column {name!r} is {c.data_type.value}; string values never materialize on device "
            "(use it in predicates/group-by, which operate on dict codes)"
        )
    if "values" in entry:
        vals = entry["values"]
    else:
        vals = entry["dict"][entry["codes"].to(torch.int64)]
    return vals, entry.get("nulls")


def eval_expr(expr: Expr, segment, cols: Dict, dev: torch.device) -> EvalResult:
    """(values, nulls) of an expression over the segment's device columns.
    Values are a tensor, or a Python scalar for a literal-only expression."""
    v, nulls, _weak = _eval(expr, segment, cols, dev)
    return v, nulls


def _eval(expr: Expr, segment, cols: Dict, dev: torch.device):
    """(values, nulls, weak) — weak marks JAX's weakly typed values."""
    if expr.kind is ExprKind.COLUMN:
        v, n = column_values(expr.op, segment, cols)
        return v, n, False
    if expr.kind is ExprKind.LITERAL:
        return expr.value, None, True
    op = expr.op
    if op in _BINARY and len(expr.args) == 2:
        a, na, wa = _eval(expr.args[0], segment, cols, dev)
        b, nb, wb = _eval(expr.args[1], segment, cols, dev)
        out, weak = _binop(_BINARY[op], a, wa, b, wb)
        return out, or_masks(na, nb), weak
    if op in ("divide", "div"):
        a, na, _ = _eval(expr.args[0], segment, cols, dev)
        b, nb, _ = _eval(expr.args[1], segment, cols, dev)
        # SQL divide: always double (Pinot DivisionTransformFunction)
        a64, b64 = astype(a, torch.float64, b), astype(b, torch.float64, a)
        return a64 / b64, or_masks(na, nb), False
    if op in _UNARY and len(expr.args) == 1:
        a, na, wa = _eval(expr.args[0], segment, cols, dev)
        out, weak = _unary(op, a, wa)
        return out, na, weak
    if op == "cast" and len(expr.args) == 2 and expr.args[1].is_literal:
        a, na, _ = _eval(expr.args[0], segment, cols, dev)
        target = str(expr.args[1].value).upper()
        dt = {"INT": torch.int32, "LONG": torch.int64, "FLOAT": torch.float32, "DOUBLE": torch.float64}.get(target)
        if dt is None:
            raise ValueError(f"unsupported CAST target {target}")
        return astype(a, dt, None if isinstance(a, torch.Tensor) else torch.empty(0, device=dev)), na, False
    if op in ("arraylength", "cardinality") and len(expr.args) == 1 and expr.args[0].is_column:
        entry = cols[expr.args[0].op]
        if "lengths" not in entry:
            raise ValueError(f"{op} requires a multi-value column ({expr.args[0].op} is single-value)")
        return entry["lengths"].to(torch.int32), None, False
    if op == "case":
        return _eval_case(expr, segment, cols, dev)
    if op in _BOOL_OPS:
        return _eval_bool(expr, segment, cols, dev), None, False
    if op in ("least", "greatest") and expr.args:
        evald = [_eval(a, segment, cols, dev) for a in expr.args]
        acc, nl, weak = evald[0]
        for v, n, w in evald[1:]:
            acc, weak = _binop(torch.minimum if op == "least" else torch.maximum, acc, weak, v, w)
            nl = or_masks(nl, n)
        return acc, nl, weak
    if op in scalar.DEVICE_MULTI_FNS:
        # positional: every arg evaluates (literals stay scalars)
        vals, nulls = [], None
        for a in expr.args:
            if a.is_literal:
                vals.append(a.value)
            else:
                v, nv, _ = _eval(a, segment, cols, dev)
                vals.append(v)
                nulls = or_masks(nulls, nv)
        return scalar.DEVICE_MULTI_FNS[op](*vals), nulls, False
    if op in scalar.DEVICE_FNS:
        # one evaluated operand + literal parameters, in SQL order
        # (DATETRUNC('day', ts) / ROUND(x, 2) / TIMECONVERT(t, 'SECONDS', 'DAYS'))
        operands = [a for a in expr.args if not a.is_literal]
        lits = [a.value for a in expr.args if a.is_literal]
        if len(operands) != 1:
            raise ValueError(f"{op} expects exactly one column/expression argument, got {expr}")
        v, nv, _ = _eval(operands[0], segment, cols, dev)
        if not isinstance(v, torch.Tensor):
            v = torch.full((), v, dtype=_scalar_dtype(v), device=dev)
        return scalar.DEVICE_FNS[op](v, *lits), nv, False
    if scalar.is_dict_fn_expr(expr):
        # dictionary-domain function: host-evaluate over the dictionary's
        # VALUES (cardinality-sized) and gather derived[codes] on the device
        col = next(a for a in expr.args if not a.is_literal).op
        c = segment.column(col)
        if not c.has_dictionary:
            raise ValueError(f"{op} requires a dictionary-encoded column ({col} is raw)")
        if scalar.string_result(expr):
            raise ValueError(
                f"string-valued {op}(...) never materializes on device; use it in "
                "predicates, GROUP BY, or the select list (host paths)"
            )
        derived = scalar.derived_for(expr, c.dictionary)
        entry = cols[col]
        vals = device_constant(derived, dev)[entry["codes"].to(torch.int64)]
        return vals, entry.get("nulls"), False
    raise ValueError(f"unsupported transform function {op!r} in {expr}")


def _rows(segment, dev, fill: bool) -> torch.Tensor:
    return torch.full((segment.num_docs,), fill, dtype=torch.bool, device=dev)


def _eval_bool(expr: Expr, segment, cols: Dict, dev: torch.device) -> torch.Tensor:
    """CASE condition ops -> bool row mask (CaseTransformFunction's WHEN
    evaluation).  String equality/IN resolve against the dictionary (code
    compares); numerics compare values in JAX's promoted dtype.  As in the
    JAX package, the mask carries no nulls: a NULL input compares as its
    stored placeholder value."""
    op = expr.op
    if op in ("__and", "__or"):
        out = None
        for a in expr.args:
            b = _eval_bool(a, segment, cols, dev)
            out = b if out is None else (out & b if op == "__and" else out | b)
        return out
    if op == "__not":
        return ~_eval_bool(expr.args[0], segment, cols, dev)
    lhs = expr.args[0]
    lits = [a.value for a in expr.args[1:]]
    if op == "__isnull":
        entry = cols.get(lhs.op, {}) if lhs.is_column else {}
        if "nulls" in entry:
            return entry["nulls"]
        return _rows(segment, dev, False)
    # string column comparisons resolve to dictionary codes
    if lhs.is_column and segment.column(lhs.op).data_type.is_string_like:
        c = segment.column(lhs.op)
        codes = cols[lhs.op]["codes"].to(torch.int32)
        ids = [c.dictionary.index_of(v) for v in lits]
        if op == "__eq":
            return codes == ids[0]
        if op == "__in":
            valid = [i for i in ids if i >= 0]
            if not valid:
                return torch.zeros(codes.shape, dtype=torch.bool, device=codes.device)
            return torch.isin(codes, torch.tensor(valid, dtype=torch.int32, device=codes.device))
        raise ValueError(f"CASE condition {op} not supported on string column {lhs.op}")
    v, _, wv = _eval(lhs, segment, cols, dev)
    if op == "__in":
        arr = torch.from_numpy(np.asarray(lits)).to(v.device if isinstance(v, torch.Tensor) else dev)
        dt = torch.promote_types(_dtype_of(v), arr.dtype)
        return torch.isin(_as_tensor(v, dt, arr), arr.to(dt))
    out, _ = _binop(_CMP[op], v, wv, lits[0], True)
    return out


def _eval_case(expr: Expr, segment, cols: Dict, dev: torch.device):
    """CASE WHEN ... THEN ... ELSE ... END: a reverse fold of torch.where.
    An omitted ELSE yields SQL NULL via the null mask (its value a strong
    float64 0.0, as in the JAX package)."""
    args = list(expr.args)
    else_e = args[-1]
    else_null = else_e.is_literal and else_e.value is None
    if else_null:
        out, en, weak = torch.full((), 0.0, dtype=torch.float64, device=dev), None, False
    else:
        out, en, weak = _eval(else_e, segment, cols, dev)
    evaluated = [
        (_eval_bool(c, segment, cols, dev), *_eval(t, segment, cols, dev))
        for c, t in zip(args[:-1:2], args[1::2])
    ]
    # values and null masks fold together: a row's nullness is the CHOSEN
    # branch's nullness, not the OR of all branches
    if else_null or en is not None or any(tn is not None for _, _, tn, _ in evaluated):
        nulls = en if en is not None else _rows(segment, dev, else_null)
    else:
        nulls = None
    for cond, tv, tn, tw in reversed(evaluated):
        dt, weak = _promote(tv, tw, out, weak)
        out = torch.where(cond, _as_tensor(tv, dt, cond), _as_tensor(out, dt, cond))
        if nulls is not None:
            nulls = torch.where(cond, tn if tn is not None else torch.zeros((), dtype=torch.bool, device=dev), nulls)
    return out, nulls, weak


# ---------------------------------------------------------------------------
# Host evaluation over selected rows (selection path)
# ---------------------------------------------------------------------------
def _host_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _eval_bool_host(expr: Expr, segment, docids: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of _eval_bool for selection-path CASE."""
    op = expr.op
    if op in ("__and", "__or"):
        out = None
        for a in expr.args:
            b = _eval_bool_host(a, segment, docids)
            out = b if out is None else (out & b if op == "__and" else out | b)
        return out
    if op == "__not":
        return ~_eval_bool_host(expr.args[0], segment, docids)
    lhs = expr.args[0]
    lits = [a.value for a in expr.args[1:]]
    if op == "__isnull":
        if lhs.is_column and segment.column(lhs.op).nulls is not None:
            return np.asarray(segment.column(lhs.op).nulls)[docids]
        return np.zeros(len(docids), dtype=bool)
    v = eval_expr_host(lhs, segment, docids)
    if op == "__eq":
        return np.asarray([x == lits[0] for x in v], dtype=bool)
    if op == "__in":
        s = set(lits)
        return np.asarray([x in s for x in v], dtype=bool)
    v = np.asarray(v, dtype=np.float64)
    if op == "__ge":
        return v >= lits[0]
    if op == "__gt":
        return v > lits[0]
    if op == "__le":
        return v <= lits[0]
    return v < lits[0]


def eval_expr_host(expr: Expr, segment, docids: np.ndarray) -> np.ndarray:
    """Host-side expression evaluation over a SELECTED row subset (O(rows
    out)).  Arithmetic and the device functions run as torch ops on CPU
    tensors of the decoded values, with JAX's dtypes for array operands;
    string-valued dictionary functions evaluate over the dictionary and
    gather by code."""
    if expr.kind is ExprKind.COLUMN:
        return segment.column(expr.op).decoded_rows(docids)
    if expr.kind is ExprKind.LITERAL:
        return np.full(len(docids), expr.value)
    if expr.op in ("arraylength", "cardinality") and len(expr.args) == 1 and expr.args[0].is_column:
        c = segment.column(expr.args[0].op)
        if getattr(c, "mv_lengths", None) is None:
            raise ValueError(f"{expr.op} requires a multi-value column")
        return c.mv_lengths[docids].astype(np.int64)
    if expr.op == "case":
        args = list(expr.args)
        else_e = args[-1]
        pairs = list(zip(args[:-1:2], args[1::2]))
        if else_e.is_literal and else_e.value is None:
            out = np.full(len(docids), None, dtype=object)
        else:
            out = np.asarray(eval_expr_host(else_e, segment, docids), dtype=object)
        for cond_e, then_e in reversed(pairs):
            cond = _eval_bool_host(cond_e, segment, docids)
            tv = np.asarray(eval_expr_host(then_e, segment, docids), dtype=object)
            out = np.where(cond, tv, out)
        return out
    if scalar.is_dict_fn_expr(expr):
        col = next(a for a in expr.args if not a.is_literal).op
        c = segment.column(col)
        if c.has_dictionary:
            derived = scalar.derived_for(expr, c.dictionary)
            return derived[np.asarray(c.codes, dtype=np.int64).reshape(-1)[docids]]
    op = expr.op
    if op in _BINARY and len(expr.args) == 2:
        a = _host_tensor(eval_expr_host(expr.args[0], segment, docids))
        b = _host_tensor(eval_expr_host(expr.args[1], segment, docids))
        return _binop(_BINARY[op], a, False, b, False)[0].numpy()
    if op in ("divide", "div"):
        a = eval_expr_host(expr.args[0], segment, docids).astype(np.float64)
        b = eval_expr_host(expr.args[1], segment, docids).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            return a / b
    if op in _UNARY and len(expr.args) == 1:
        return _unary(op, _host_tensor(eval_expr_host(expr.args[0], segment, docids)), False)[0].numpy()
    if op in scalar.DEVICE_MULTI_FNS:
        vals = [
            a.value if a.is_literal else _host_tensor(eval_expr_host(a, segment, docids).astype(np.float64))
            for a in expr.args
        ]
        return scalar.DEVICE_MULTI_FNS[op](*vals).numpy()
    if op in scalar.DEVICE_FNS:
        operands = [a for a in expr.args if not a.is_literal]
        lits = [a.value for a in expr.args if a.is_literal]
        if len(operands) == 1:
            v = eval_expr_host(operands[0], segment, docids)
            return scalar.DEVICE_FNS[op](_host_tensor(v), *lits).numpy()
    if op == "todatetime" and len(expr.args) in (2, 3) and expr.args[1].is_literal:
        v = eval_expr_host(expr.args[0], segment, docids)
        tz = expr.args[2].value if len(expr.args) == 3 and expr.args[2].is_literal else None
        return scalar.to_datetime(v, expr.args[1].value, tz)
    if op == "cast" and len(expr.args) == 2 and expr.args[1].is_literal:
        v = eval_expr_host(expr.args[0], segment, docids)
        target = str(expr.args[1].value).upper()
        npdt = {"INT": np.int32, "LONG": np.int64, "FLOAT": np.float32, "DOUBLE": np.float64, "STRING": None}.get(
            target, np.float64
        )
        return v.astype(str) if npdt is None else v.astype(npdt)
    raise ValueError(f"unsupported selection expression {op!r} in {expr}")
