"""Join primitives: a sorted build side and a searchsorted probe.

Port of pinot_tpu/mse/join.py.  Reference parity: HashJoinOperator's build
and probe phases (build a key -> rows table from the right input, probe with
the left rows).  A sort plus a binary search is a perfect hash for static
shapes: sort the (filtered) build keys once, then search every probe key in
parallel, O(B log B + P log B) of vector work.

lookup_join serves UNIQUE build keys (dimension primary keys, one matched
row per probe); range_join a bounded many-to-many, where the planner gives
the build side's largest key multiplicity and each probe returns up to
max_dup matched rows as a [P, max_dup] expansion.

The argsort is stable (torch.sort(stable=True)), as jnp.argsort is: equal
keys keep their build-row order, and range_join's slot order decides the row
order of a join selection.
"""
from __future__ import annotations

from typing import Tuple

import torch

# larger than any real key: invalid build rows sort to the end
KEY_SENTINEL = torch.iinfo(torch.int64).max


def _sorted_build(build_keys: torch.Tensor, build_valid: torch.Tensor):
    sort_key = torch.where(build_valid, build_keys, torch.full_like(build_keys, KEY_SENTINEL))
    sorted_keys, order = torch.sort(sort_key, stable=True)
    return sorted_keys, order


def lookup_join(
    build_keys: torch.Tensor,  # int64 [B]
    build_valid: torch.Tensor,  # bool [B]
    probe_keys: torch.Tensor,  # int64 [P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe each key against the valid build rows.

    Returns (build_row, match): build_row[p] is the build-side row index
    whose key equals probe_keys[p] (undefined where match[p] is False);
    match[p] is the inner-join hit mask."""
    sorted_keys, order = _sorted_build(build_keys, build_valid)
    pos = torch.searchsorted(sorted_keys, probe_keys, right=False)
    cand = torch.clamp(pos, 0, sorted_keys.shape[0] - 1)
    match = (sorted_keys[cand] == probe_keys) & (probe_keys != KEY_SENTINEL)
    return order[cand], match


def range_join(
    build_keys: torch.Tensor,  # int64 [B]
    build_valid: torch.Tensor,  # bool [B]
    probe_keys: torch.Tensor,  # int64 [P]
    max_dup: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded many-to-many probe.

    Returns (build_rows [P, max_dup], match [P, max_dup]): slot j holds the
    j-th build row whose key equals the probe key (its sorted run), match
    marks real slots.  max_dup must be >= the largest multiplicity among
    valid build rows (the planner takes it from the unfiltered column, a
    safe upper bound)."""
    sorted_keys, order = _sorted_build(build_keys, build_valid)
    lo = torch.searchsorted(sorted_keys, probe_keys, right=False)  # first slot of the run
    b = sorted_keys.shape[0]
    offs = torch.arange(max_dup, dtype=lo.dtype, device=lo.device)
    pos = lo[:, None] + offs[None, :]
    cand = torch.clamp(pos, 0, b - 1)
    # pos < b guards the end clip: without it a run ending at the array's
    # tail re-matches its last row through the clamped index
    match = (
        (sorted_keys[cand] == probe_keys[:, None])
        & (probe_keys[:, None] != KEY_SENTINEL)
        & (pos < b)
    )
    return order[cand], match
