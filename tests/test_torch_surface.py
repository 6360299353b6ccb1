"""The port's public surface held against the JAX package's, by source.

Every module of pinot_tpu/ with a module at the same path in
pinot_tpu_torch/ is parsed (ast: neither package is imported).  Each public
name the JAX module defines -- a top-level function or class, a method of a
public class, an UPPER-case constant -- must exist in the port module (a
definition, an import or an assignment there; a method in the port class's
body or a base's), or stand in UNPORTED_NAMES with where the port keeps it
instead, or None, and why.  JAX modules with no port module at their path
stand in UNPORTED_FILES with their port counterparts.  A second set of
cases holds every row of both tables to the code, so that no row goes
stale: the JAX module still defines the name, the port still lacks it, and
a named port location exists.
"""
from __future__ import annotations

import ast
import functools
import os
from typing import Dict, Optional, Set, Tuple

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(ROOT, "pinot_tpu")
PORT_ROOT = os.path.join(ROOT, "pinot_tpu_torch")
PORT_PKG = "pinot_tpu_torch"

# JAX modules with no port module at the same path: (port counterparts, reason)
UNPORTED_FILES: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "ops/pallas_scan.py": (
        ("ops/fused_scan.py", "ops/sparse_merge.py"),
        "the Pallas kernel fused_group_tables_pallas is the hand-written CUDA fused scan "
        "(ops/csrc/fused_scan.cu, wrapper and plain version ops/fused_scan.py); merge_sparse_tables "
        "is the device merge of ops/sparse_merge.py",
    ),
    "utils/native.py": (
        ("utils/bitmaps.py", "ingest/readers.py"),
        "a ctypes loader of native/bitmap.cc and native/csv.cc; the port's compressed-bitmap codec "
        "(byte-compatible with the native one) and CSV field split are numpy and Python",
    ),
}

# (JAX module, public name) -> (port location "module.py:name" or None, reason)
UNPORTED_NAMES: Dict[Tuple[str, str], Tuple[Optional[str], str]] = {
    ("ops/segmented.py", "accum_policy"): (
        None,
        "selects the XLA limb path's f32 'wide' accumulation on a TPU; the port adds with torch "
        "scatters into int64 / f64 tables (ops/segmented.py's docstring), so there is no policy to pick",
    ),
    ("parallel/engine.py", "shard_map_compat"): (
        None,
        "a shim over jax.shard_map's spelling across jax versions; the port's mesh is one process "
        "driving device positions (parallel/mesh.py) with no shard_map",
    ),
    ("parallel/engine.py", "make_agg_inputs"): (
        "query/planner.py:make_agg_inputs",
        "one builder of the aggregation inputs, shared by the segment planner, the distributed "
        "engine and the multi-stage engine",
    ),
    ("parallel/engine.py", "sse_executor_needed_columns"): (
        "query/planner.py:_needed_columns",
        "the distributed engine calls the planner's column set over the stacked table directly",
    ),
    ("segment/packing.py", "unpack_codes_jnp"): (
        "segment/packing.py:unpack_codes_torch",
        "the same lane unpack on torch tensors (int32 views, masked shifts)",
    ),
    ("utils/perf.py", "capture_cost"): (
        None,
        "reads XLA's cost analysis of a compiled program; a CUDA kernel has none, so every launch "
        "records the analytic model (utils/perf.py analytic_cost, KernelCost source 'analytic')",
    ),
}


def _modules(root: str):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/") for f in files if f.endswith(".py")]
    return sorted(out)


JAX_MODULES = _modules(JAX_ROOT)


@functools.lru_cache(maxsize=None)
def _tree(root: str, rel: str) -> ast.Module:
    with open(os.path.join(root, rel), encoding="utf-8") as f:
        return ast.parse(f.read(), filename=rel)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _targets(node) -> list:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)]


def jax_public_names(rel: str) -> Set[str]:
    """Public names the JAX module defines: functions, classes,
    Class.method, UPPER constants."""
    out: Set[str] = set()
    for node in _tree(JAX_ROOT, rel).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.add(node.name)
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(m.name))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(n for n in _targets(node) if n.isupper() and _public(n))
    return out


def _port_rel(module: str) -> Optional[str]:
    """pinot_tpu_torch.a.b -> "a/b.py" (or "a/b/__init__.py")."""
    if not module.startswith(PORT_PKG + "."):
        return None
    base = module[len(PORT_PKG) + 1:].replace(".", "/")
    for rel in (base + ".py", base + "/__init__.py"):
        if os.path.exists(os.path.join(PORT_ROOT, rel)):
            return rel
    return None


def _port_bound(rel: str) -> Dict[str, Optional[Tuple[str, str]]]:
    """Top-level names the port module binds -> (module, name) where an
    import from the port binds it, else None."""
    out: Dict[str, Optional[Tuple[str, str]]] = {}
    for node in _tree(PORT_ROOT, rel).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update((n, None) for n in _targets(node))
        elif isinstance(node, ast.ImportFrom):
            src = _port_rel(node.module or "")
            for a in node.names:
                out[a.asname or a.name] = (src, a.name) if src else None
        elif isinstance(node, ast.Import):
            out.update(((a.asname or a.name).split(".")[0], None) for a in node.names)
    return out


def _port_class(rel: str, name: str, depth: int = 0) -> Optional[Tuple[str, ast.ClassDef]]:
    """(module, ClassDef) of class `name` as the port module binds it,
    following imports from the port."""
    for node in _tree(PORT_ROOT, rel).body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return rel, node
    src = _port_bound(rel).get(name)
    if src and depth < 4:
        return _port_class(src[0], src[1], depth + 1)
    return None


def _port_has_method(rel: str, cls: str, method: str, depth: int = 0) -> bool:
    found = _port_class(rel, cls)
    if found is None:
        return False
    mod, node = found
    if any(isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and m.name == method for m in node.body):
        return True
    bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
    return depth < 8 and any(_port_has_method(mod, b, method, depth + 1) for b in bases)


def port_has(rel: str, name: str) -> bool:
    if not os.path.exists(os.path.join(PORT_ROOT, rel)):
        return False
    if "." in name:
        cls, method = name.split(".", 1)
        return _port_has_method(rel, cls, method)
    return name in _port_bound(rel)


def _location_exists(loc: str) -> bool:
    rel, _, name = loc.partition(":")
    return os.path.exists(os.path.join(PORT_ROOT, rel)) and port_has(rel, name)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_public_names_ported(rel):
    """Each public name of the JAX module exists in the port module at the
    same path, or stands in UNPORTED_NAMES; a JAX module without a port
    module stands in UNPORTED_FILES."""
    if rel in UNPORTED_FILES:
        assert not os.path.exists(os.path.join(PORT_ROOT, rel))
        return
    assert os.path.exists(os.path.join(PORT_ROOT, rel)), (
        f"pinot_tpu/{rel} has no port module: port it or add it to UNPORTED_FILES with a reason"
    )
    missing = sorted(n for n in jax_public_names(rel) if (rel, n) not in UNPORTED_NAMES and not port_has(rel, n))
    assert not missing, (
        f"pinot_tpu/{rel}'s public names missing from pinot_tpu_torch/{rel}: {missing} "
        "(port them, or add them to UNPORTED_NAMES with where the port keeps them and why)"
    )


@pytest.mark.parametrize("key", sorted(UNPORTED_NAMES), ids=lambda k: f"{k[0]}:{k[1]}")
def test_unported_name_row_is_live(key):
    """The row names a public name the JAX module still defines and the
    port module still lacks; its port location, if any, exists."""
    rel, name = key
    loc, reason = UNPORTED_NAMES[key]
    assert reason
    assert rel in JAX_MODULES and name in jax_public_names(rel), f"stale row: pinot_tpu/{rel} has no {name}"
    assert not port_has(rel, name), f"stale row: pinot_tpu_torch/{rel} now has {name}"
    assert loc is None or _location_exists(loc), f"the row's port location {loc} does not exist"


@pytest.mark.parametrize("rel", sorted(UNPORTED_FILES))
def test_unported_file_row_is_live(rel):
    """The row names a JAX module that exists with no port module at its
    path, and port counterparts that exist."""
    counterparts, reason = UNPORTED_FILES[rel]
    assert reason and counterparts
    assert rel in JAX_MODULES, f"stale row: pinot_tpu/{rel} is gone"
    assert not os.path.exists(os.path.join(PORT_ROOT, rel)), f"stale row: pinot_tpu_torch/{rel} exists"
    for c in counterparts:
        assert os.path.exists(os.path.join(PORT_ROOT, c)), c


def test_every_port_module_parses():
    """The scan reads every port module it needs (a syntax error there
    would otherwise read as missing names)."""
    for rel in _modules(PORT_ROOT):
        _tree(PORT_ROOT, rel)
