"""Device merge of the sparse group-by's fixed-slot tables across launches.

Port of ``merge_sparse_tables`` (pinot_tpu/ops/pallas_scan.py:363-444).  It
is not a Pallas kernel in the JAX package (its body is XLA sorts, cumsums
and scatters), so its port is plain torch ops on the tables' device:
``torch.sort(stable=True)``, ``cumsum``, ``index_add_`` and
``scatter_reduce_("amin" / "amax")``.  Everything is table-sized (the
launches' [K] tables stacked), never row-length, and only the final
[num_slots] tables leave the device.

A multi-key ``lax.sort(..., num_keys=2)`` becomes two stable sorts, the
secondary key first.  That tie-break by packed key decides which groups
survive a trim, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the sparse path's key of rows filtered out and slots never written: real
# packed keys are >= 0, so int64 max never collides
SPARSE_EMPTY_KEY = int(np.iinfo(np.int64).max)

# merges since the last reset (chip_smoke.py reads and resets it)
MERGES = 0


def merge_sparse_tables(
    uniq: torch.Tensor,
    partials: Sequence[Dict[str, torch.Tensor]],
    num_slots: int,
    field_ops: Sequence[Dict[str, str]],
    order_spec: Optional[Tuple[int, str, bool]] = None,
):
    """Merge stacked fixed-slot sparse group tables on their device.

    uniq: [M] int64 packed keys (SPARSE_EMPTY_KEY padding), every launch's
    [K] key table concatenated.  partials: per-agg {field: [M]} stacked the
    same way.  field_ops: per-agg {field: "add" | "min" | "max"}.
    order_spec: (agg index, order FIELD name, ascending) when an ORDER
    BY-aware trim applies: groups rank by the merged order value (empty and
    NaN last), ties by packed key, the top num_slots survive, emitted in
    ascending key order.  Without one the lowest packed keys survive.

    Returns (keys int64[num_slots], [{field: [num_slots]}])."""
    global MERGES
    MERGES += 1
    uniq = uniq.reshape(-1).to(torch.int64)
    M = int(uniq.shape[0])
    dev = uniq.device
    skey, perm = torch.sort(uniq, stable=True)
    valid = skey != SPARSE_EMPTY_KEY
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev), skey[:-1]])
    is_start = valid & (skey != prev)
    seg_id = torch.cumsum(is_start.to(torch.int64), 0) - 1
    # empty slots fold into an overflow slot M (sliced off): add-fields carry
    # 0 there and min/max their identity, so it absorbs harmlessly
    overflow = torch.full((), M, dtype=torch.int64, device=dev)
    empty = torch.full((), SPARSE_EMPTY_KEY, dtype=torch.int64, device=dev)
    slot = torch.where(valid, seg_id, overflow)

    merged: List[Dict[str, torch.Tensor]] = []
    for fops, p in zip(field_ops, partials):
        q: Dict[str, torch.Tensor] = {}
        for fname, comb in fops.items():
            x = p[fname].reshape(-1)[perm]
            if comb == "add":
                q[fname] = torch.zeros(M + 1, dtype=x.dtype, device=dev).index_add_(0, slot, x)
            else:
                ident = float("inf") if comb == "min" else float("-inf")
                q[fname] = torch.full((M + 1,), ident, dtype=x.dtype, device=dev).scatter_reduce_(
                    0, slot, x, reduce="amin" if comb == "min" else "amax", include_self=True
                )
        merged.append(q)

    gslot = torch.where(is_start, seg_id, overflow)
    gkey = torch.full((M + 1,), SPARSE_EMPTY_KEY, dtype=torch.int64, device=dev).scatter_(
        0, gslot, torch.where(is_start, skey, empty)
    )
    phantom = gkey == SPARSE_EMPTY_KEY  # slots past the last real group
    inf = torch.full((), float("inf"), dtype=torch.float64, device=dev)
    if order_spec is None:
        ovk = torch.where(phantom, inf, torch.zeros((), dtype=torch.float64, device=dev))
    else:
        oi, field, asc = order_spec
        ov = merged[oi][field].to(torch.float64)
        cnt = merged[oi].get("count")
        if cnt is not None:
            # SUM/MIN/MAX over zero agg-mask rows is SQL NULL: rank last
            ov = torch.where(cnt > 0, ov, torch.full((), float("nan"), dtype=torch.float64, device=dev))
        ovk = ov if asc else -ov
        ovk = torch.where(torch.isnan(ovk) | phantom, inf, ovk)
    # rank by (order value, packed key): stable sorts, secondary key first
    by_key = torch.sort(gkey, stable=True).indices
    ranked = by_key[torch.sort(ovk[by_key], stable=True).indices]
    selmask = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    selmask[ranked[:num_slots]] = True
    outkey = torch.where(selmask & ~phantom, gkey, empty)
    okey, operm = torch.sort(outkey, stable=True)
    out = [{f: t[operm][:num_slots] for f, t in q.items()} for q in merged]
    return okey[:num_slots], out
