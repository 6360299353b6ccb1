"""Device mesh: an array of device positions and the folds across them.

Port of pinot_tpu/parallel/mesh.py.  In the JAX package a mesh is a
``jax.sharding.Mesh`` of devices, a query is one shard_map program over it,
and partial results combine in-graph with psum / pmin / pmax over the data
axes.  Here one Python process drives every position of the mesh (a single
controller, as ``jax.devices()`` is): a position is a ``torch.device``, and
positions may repeat one physical device, so a mesh of four positions runs
on one card as four shards whose launches take turns on its stream (the
tests use eight positions of the CPU).  On a machine with several cards the
positions are distinct cards.

The axes name the two parallelism strategies, as in the JAX package:

  shard    - table shards, one range of them a position; partials combine
             across positions.
  replica  - replica rows for QPS: each row holds a full copy of the data on
             its own positions (ReplicatedEngine routes a query to one row).

The 1-D form names its one axis ``SEG_AXIS``; the 2-D (R, S) mesh names
``DATA_AXES`` = (REPLICA_AXIS, SHARD_AXIS), outermost first.  Every mesh
orders its positions row-major, and a position's global index is its place
in that order on every topology: position p of a 1-D mesh of 8 and of a 2x4
mesh holds the same shards.

A collective is a fold of the per-position tensors, in global position
order, on the first position's device (a peer copy across distinct cards,
none on a shared one).  ``combine_hierarchical`` folds innermost axis first
(each replica row to one partial, then across rows) and serves integer adds
and min / max, which are exact under any association.  ``psum_ordered`` is
one explicit left fold in global order, the float add: it gives the same
bits on every topology of the same number of positions.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.device import DeviceLike, resolve_device

#: QPS axis: replica rows, each a full data copy.
REPLICA_AXIS = "replica"
#: Capacity axis: table shards within one replica row.
SHARD_AXIS = "shard"
#: The 1-D data axis.
SEG_AXIS = "seg"

#: The 2-D data-placement axes, outermost first.
DATA_AXES: Tuple[str, str] = (REPLICA_AXIS, SHARD_AXIS)

AxisSpec = Union[str, Sequence[str]]


def normalize_axes(axis: AxisSpec) -> Tuple[str, ...]:
    """A single axis name or a sequence of them as a tuple."""
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


class Mesh:
    """An array of device positions with named axes.

    devices: an object array of ``torch.device`` (the positions, row-major);
    axis_names: one name an axis; ids: each position's global index (default
    its row-major place), kept by the submeshes of ``replica_rows`` so their
    positions stay distinct when they share a device."""

    def __init__(self, devices, axis_names: AxisSpec, ids=None):
        devs = np.asarray(devices, dtype=object)
        flat = np.empty(devs.size, dtype=object)
        for i, d in enumerate(devs.reshape(-1)):
            flat[i] = torch.device(d)
        self.devices = flat.reshape(devs.shape)
        self.axis_names = normalize_axes(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"axes {self.axis_names} do not match a mesh of shape {self.devices.shape}")
        self.ids = (np.arange(self.devices.size) if ids is None else np.asarray(ids)).reshape(self.devices.shape)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def positions(self) -> List[torch.device]:
        """Every position's device, in global (row-major) order."""
        return list(self.devices.flat)

    @property
    def position_ids(self) -> List[int]:
        return [int(i) for i in self.ids.flat]


def _cuda_devices() -> List[torch.device]:
    """Every visible card; raises without CUDA, as resolve_device(None) does."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _positions(num_devices: Optional[int], device: DeviceLike, default_count: int) -> List[torch.device]:
    """`num_devices` positions: of every visible card when `device` is None,
    else each one `device`."""
    if device is None:
        devs = _cuda_devices()
        n = len(devs) if num_devices is None else int(num_devices)
        if n > len(devs):
            raise ValueError(f"a mesh of {n} cards needs {n} devices, have {len(devs)} (pass device= to "
                             "put several positions on one)")
        return devs[:n]
    n = default_count if num_devices is None else int(num_devices)
    return [resolve_device(device)] * n


def default_mesh(axis: str = SEG_AXIS, num_devices: Optional[int] = None, device: DeviceLike = None) -> Mesh:
    """1-D mesh: every (or the first N) visible card(s) when `device` is
    None, raising without CUDA; else N positions of `device` (one by
    default), e.g. ``default_mesh(device="cpu", num_devices=8)``."""
    return Mesh(_positions(num_devices, device, 1), (axis,))


def make_mesh2d(
    num_replicas: int = 1,
    num_shards: Optional[int] = None,
    num_devices: Optional[int] = None,
    device: DeviceLike = None,
) -> Mesh:
    """2-D (REPLICA_AXIS, SHARD_AXIS) mesh: R replica rows of S positions.

    The position count is `num_devices`, else every visible card when
    `device` is None, else R x S (R when S is not given).  ``num_shards``
    defaults to positions / R; a count that does not factor raises with the
    JAX package's messages."""
    if num_devices is not None:
        n = int(num_devices)
    elif device is None:
        n = len(_cuda_devices())
    else:
        n = num_replicas * (num_shards if num_shards is not None else 1)
    if num_shards is None:
        if n % num_replicas:
            raise ValueError(f"{n} devices not divisible into {num_replicas} replica rows")
        num_shards = n // num_replicas
    if num_replicas * num_shards != n:
        raise ValueError(
            f"mesh shape ({num_replicas} replicas x {num_shards} shards) "
            f"needs {num_replicas * num_shards} devices, have {n}"
        )
    positions = _positions(n, device, n)
    arr = np.empty(n, dtype=object)
    arr[:] = positions
    return Mesh(arr.reshape(num_replicas, num_shards), DATA_AXES)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes that carry table rows, outermost first: every axis."""
    return tuple(mesh.axis_names)


def replica_rows(mesh: Mesh) -> List[Mesh]:
    """One 1-D SHARD_AXIS submesh per replica row of a 2-D mesh; a 1-D mesh
    is its own single row.  The rows hold disjoint position sets (disjoint
    ids; on a shared card the same device), so per-row engines stage
    disjoint full data copies under their own residency budgets."""
    names = tuple(mesh.axis_names)
    if len(names) == 1:
        return [mesh]
    if names != DATA_AXES:
        raise ValueError(f"expected axes {DATA_AXES}, mesh has {names}")
    return [Mesh(mesh.devices[r], (SHARD_AXIS,), ids=mesh.ids[r]) for r in range(mesh.shape[0])]


# -- folds ---------------------------------------------------------------
def _home(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every part on the first part's device (no copy where it is there)."""
    return [to_home(p, parts[0].device) for p in parts]


def combine_hierarchical(op: Callable, parts: Sequence[torch.Tensor], shape: Optional[Tuple[int, ...]] = None):
    """Fold the per-position tensors (global row-major order) with the
    binary `op`, axis by axis, innermost first: on a (R, S) mesh each
    replica row folds to one partial, then the rows fold; `shape` None is
    1-D.  Value-equal to one flat fold for exact ops (integer add, min,
    max)."""
    xs = _home(parts)
    shape = (len(xs),) if shape is None else tuple(shape)
    if int(np.prod(shape)) != len(xs):
        raise ValueError(f"{len(xs)} partials do not fill a mesh of shape {shape}")
    for width in reversed(shape):
        folded = []
        for i in range(0, len(xs), width):
            acc = xs[i]
            for x in xs[i + 1: i + width]:
                acc = op(acc, x)
            folded.append(acc)
        xs = folded
    return xs[0]


def psum_hierarchical(parts: Sequence[torch.Tensor], shape: Optional[Tuple[int, ...]] = None):
    return combine_hierarchical(torch.add, parts, shape)


def pmin_hierarchical(parts: Sequence[torch.Tensor], shape: Optional[Tuple[int, ...]] = None):
    return combine_hierarchical(torch.minimum, parts, shape)


def pmax_hierarchical(parts: Sequence[torch.Tensor], shape: Optional[Tuple[int, ...]] = None):
    return combine_hierarchical(torch.maximum, parts, shape)


def psum_ordered(parts: Sequence[torch.Tensor]):
    """Order-canonical sum: x0 + x1 + ... in global position order, one
    explicit chain of dependent adds (no reassociation), so a float sum has
    the same bits on the 1-D mesh and on every 2-D topology of the same
    positions.  The JAX package gathers the partials the same way and folds
    them with the same chain."""
    xs = _home(parts)
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def fold_field(name: str, parts: Sequence, shape: Optional[Tuple[int, ...]] = None):
    """One partial field across positions by its name's combine
    (functions.FIELD_COMBINE): a float add by psum_ordered, an integer add
    and min / max by the hierarchical folds (the JAX package's _psum_field)."""
    from pinot_tpu_torch.query.functions import FIELD_COMBINE

    if len(parts) == 1:
        return parts[0]
    op = FIELD_COMBINE[name]
    if op == "add":
        if isinstance(parts[0], torch.Tensor) and torch.is_floating_point(parts[0]):
            return psum_ordered(parts)
        return psum_hierarchical(parts, shape)
    if op == "min":
        return pmin_hierarchical(parts, shape)
    return pmax_hierarchical(parts, shape)


def to_home(tree, device: torch.device):
    """A partial's tensors (nested lists, tuples and dicts) on `device`."""
    if device is None:
        return tree
    if isinstance(tree, torch.Tensor):
        return tree if tree.device == device else tree.to(device)
    if isinstance(tree, dict):
        return {k: to_home(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_home(v, device) for v in tree)
    return tree


def fold_partials(aggs, parts_list: Sequence, shape: Optional[Tuple[int, ...]] = None):
    """Per-position aggregation partials (a list over positions of per-agg
    field dicts) folded field by field with fold_field, or by the function's
    pairwise merge in position order for coupled fields."""
    if len(parts_list) == 1:
        return parts_list[0]
    home = next((t.device for t in _leaves(parts_list[0])), None)
    out = []
    for i, fn in enumerate(aggs):
        ps = [parts[i] for parts in parts_list]
        if fn.pairwise_merge:
            acc = to_home(ps[0], home)
            for q in ps[1:]:
                acc = fn.merge(acc, to_home(q, home))
            out.append(acc)
        else:
            out.append({f: fold_field(f, [p[f] for p in ps], shape) for f in ps[0]})
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
