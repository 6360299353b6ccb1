"""Vector index: a row-normalized embedding matrix and exact top-k.

Port of pinot_tpu/indexes/vector.py.  Reference parity: Pinot's
Lucene-HNSW vector index and the VECTOR_SIMILARITY predicate
(pinot-core/.../operator/filter/VectorSimilarityFilterOperator.java).

As in the JAX package there is no graph structure: the index is a
row-normalized [n, d] float32 matrix (persisted as `{prefix}.mat`), and
VECTOR_SIMILARITY(col, q, k) is one matrix-vector product over the
column's embedding rows on the device plus a threshold at the k-th best
score (``similarity_mask``): exact cosine top-k, where HNSW is
approximate.  Ties at the k-th score admit every tied row (`>=`), as the
JAX package's `lax.top_k` threshold does.  The JAX package computes this
outside any Pallas kernel; so does the port (``torch.mv`` and
``torch.topk``).
"""
from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch


class VectorIndex:
    KIND = "vector"

    def __init__(self, matrix: np.ndarray, dim: int):
        self.matrix = matrix  # [n, d] float32, rows L2-normalized (0 rows stay 0)
        self.dim = dim

    @staticmethod
    def build(values: np.ndarray, lengths: np.ndarray) -> "VectorIndex":
        """values: padded [n, max_len] float matrix; rows with length != the
        modal dimension are zeroed (score -inf at query time)."""
        m = np.asarray(values, dtype=np.float32)
        dims = np.bincount(lengths[lengths > 0]) if len(lengths) else np.array([1])
        dim = int(np.argmax(dims)) if dims.size else m.shape[1]
        ok = lengths == dim
        m = np.where(ok[:, None], m, 0.0)[:, :dim]
        norms = np.linalg.norm(m, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        return VectorIndex((m / norms).astype(np.float32), dim)

    def normalize_query(self, q) -> np.ndarray:
        q = np.asarray(q, dtype=np.float32).reshape(-1)
        if len(q) != self.dim:
            raise ValueError(f"query vector dim {len(q)} != index dim {self.dim}")
        n = np.linalg.norm(q)
        return q / (n if n else 1.0)

    # -- persistence -------------------------------------------------------
    def to_regions(self, prefix: str):
        return [(f"{prefix}.mat", self.matrix)]

    def meta(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "dim": self.dim}

    @staticmethod
    def from_regions(meta: Dict[str, Any], regions, prefix: str) -> "VectorIndex":
        return VectorIndex(np.asarray(regions[f"{prefix}.mat"]), meta["dim"])


def parse_query_vector(raw) -> np.ndarray:
    """VECTOR_SIMILARITY's query argument: a JSON-array string or sequence."""
    if isinstance(raw, str):
        return np.asarray(json.loads(raw), dtype=np.float32)
    return np.asarray(raw, dtype=np.float32)


def similarity_mask(values: torch.Tensor, q: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """Rows of the [n, >= dim] embedding matrix whose cosine score against
    the unit query q is at least the k-th best (ties admit extra rows): one
    matrix-vector product divided by each row's norm, all-zero rows scoring
    -inf (the JAX package's eval_vec), float32 throughout."""
    m = values[:, :dim].to(torch.float32)
    norms = torch.sqrt(torch.sum(m * m, dim=1))
    scores = torch.mv(m, q.to(torch.float32)) / torch.where(norms == 0, torch.ones_like(norms), norms)
    scores = torch.where(norms == 0, torch.full_like(scores, float("-inf")), scores)
    kk = min(int(k), int(scores.shape[0]))
    thresh = torch.topk(scores, kk).values[-1]
    return scores >= thresh
