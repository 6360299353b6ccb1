"""What decides `correct`: every answer the timed path gave, against the
plain reference's rows for its query.

Two numbers are compared, each with the limit the configuration's file
gives (both 0 for exact integer aggregates):
  wrong_rows  rows whose group keys, order or count differ from the
              reference's (a missing or extra row counts once), summed over
              every distinct answer
  sum_gap     the largest |program - reference| / max(1, |reference|) of an
              aggregate over the rows whose keys agree
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def canonical(rows) -> Tuple[tuple, ...]:
    """A result's rows as plain Python values, hashable."""
    def v(x):
        if isinstance(x, np.generic):
            x = x.item()
        if isinstance(x, bytes):
            x = x.decode("utf-8")
        return x

    return tuple(tuple(v(x) for x in r) for r in rows)


def compare(got: Sequence[tuple], want: Sequence[tuple], agg_at: int) -> Tuple[int, float]:
    wrong = abs(len(got) - len(want))
    gap = 0.0
    for g, w in zip(got, want):
        if len(g) != len(w) or any(a != b for i, (a, b) in enumerate(zip(g, w)) if i != agg_at):
            wrong += 1
            continue
        try:
            d = abs(float(g[agg_at]) - float(w[agg_at])) / max(1.0, abs(float(w[agg_at])))
        except (TypeError, ValueError):
            wrong += 1
            continue
        gap = max(gap, d if d == d else float("inf"))  # a NaN is an infinite gap
    return wrong, gap


def judge(answers: Dict[str, set], reference: Dict[str, List[tuple]], agg_at: Dict[str, int]) -> Dict[str, float]:
    """answers: qid -> the distinct canonical answers the window saw."""
    wrong, gap, compared = 0, 0.0, 0
    for qid, seen in answers.items():
        for got in seen:
            w, g = compare(got, reference[qid], agg_at[qid])
            wrong += w
            gap = max(gap, g)
            compared += 1
    return {"wrong_rows": wrong, "sum_gap": gap, "answers_compared": compared}
