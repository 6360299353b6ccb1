"""Exchanges: the MSE data plane between stages, over a mesh of positions.

Port of pinot_tpu/mse/exchange.py.  Reference parity: pinot-query-runtime's
BlockExchange strategies (Hash/BroadcastExchange) shipping DataBlocks
through mailboxes with back-pressure.  In the JAX package an exchange is a
collective inside one compiled program over the device mesh: a broadcast is
an all_gather of the filtered build side, a hash exchange bucketizes rows by
their key's hash and sends each bucket with an all_to_all.

Here one process drives every mesh position (parallel/mesh.py), and an
exchange takes the per-position tensors as a list in global position order:

  broadcast_rows    every position receives every position's rows,
                    concatenated in mesh order (the tiled all_gather);
  hash_repartition  each source position's rows ride fixed [ndev, capacity]
                    buckets in stable destination order with a validity
                    mask, rows beyond a bucket's capacity dropped and
                    counted; position j receives bucket j of every source,
                    in source order (the tiled all_to_all), and the overflow
                    is summed over positions.

A single dict (not a list) is one position's rows: at one position every
collective is the identity, but the bucketing is not, so a shuffle planned
with shuffleSlack < 1 overflows exactly as on a one-device mesh in the JAX
package, and the engine's back-pressure loop (mse/engine.py) re-plans with a
doubled slack.  `run_lockstep` drives one plan closure a position, each a
generator that yields its exchange requests, through the collectives.
"""
from __future__ import annotations

from typing import Any, Dict, Generator, List, Tuple, Union

import torch

from pinot_tpu_torch.parallel.mesh import to_home

_INT64_MAX = (1 << 63) - 1
# the murmur3 fmix64 multiplier as a two's-complement int64 (0xFF51AFD7ED558CCD)
_FMIX_MUL = 0xFF51AFD7ED558CCD - (1 << 64)


def broadcast_rows(parts: Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]):
    """Every position receives every position's rows, concatenated in mesh
    order: a list over positions of row dicts in, the same list of gathered
    dicts out (positions on one device share one concatenation).  One
    position's dict comes back as is."""
    if isinstance(parts, dict):
        return parts
    if len(parts) == 1:
        return list(parts)
    by_device: Dict[str, Dict[str, torch.Tensor]] = {}
    out = []
    for part in parts:
        dev = next(iter(part.values())).device
        if str(dev) not in by_device:
            by_device[str(dev)] = {k: torch.cat([to_home(p[k], dev) for p in parts]) for k in part}
        out.append(by_device[str(dev)])
    return out


def _lshr33(k: torch.Tensor) -> torch.Tensor:
    """Logical k >> 33 on the int64 bits of a uint64: the arithmetic shift
    with the sign-extended high bits masked off."""
    return (k >> 33) & ((1 << 31) - 1)


def hash_dest(key: torch.Tensor, ndev: int) -> torch.Tensor:
    """Destination device per row: the murmur-style finalizer over the
    int64 key (bit for bit the JAX package's uint64 arithmetic: the int64
    multiply wraps the same in two's complement), then the UNSIGNED key
    modulo ndev, as int32."""
    k = key.to(torch.int64)
    k = k ^ _lshr33(k)
    k = k * _FMIX_MUL
    k = k ^ _lshr33(k)
    # unsigned k % ndev: a negative int64 is 2^63 + (k & INT64_MAX) as a uint64
    low = (k & _INT64_MAX) % ndev
    high = torch.where(k < 0, torch.full_like(k, (1 << 63) % ndev), torch.zeros_like(k))
    return ((low + high) % ndev).to(torch.int32)


def hash_buckets(
    arrays: Dict[str, torch.Tensor],
    dest: torch.Tensor,
    ok: torch.Tensor,
    ndev: int,
    capacity: int,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """One source position's [ndev * capacity] buckets: each valid row in
    its destination's bucket in stable order, the bucket's validity mask,
    and the count of rows dropped past a bucket's capacity (an int64 scalar
    tensor).  The JAX package writes the buckets with mode="drop", which
    silently skips invalid rows and rows past the capacity; a CUDA
    index_put_ asserts on an out-of-range index, so those rows are filtered
    out before the write."""
    n = dest.shape[0]
    d = torch.where(ok, dest.to(torch.int32), torch.full_like(dest, ndev, dtype=torch.int32))
    dsort, order = torch.sort(d, stable=True)
    # rank within the destination bucket = position - first index of that dest
    first = torch.searchsorted(dsort, dsort, right=False)
    pos = torch.arange(n, dtype=torch.int64, device=dest.device) - first
    shipped = dsort < ndev
    keep = shipped & (pos < capacity)
    overflow = (shipped & (pos >= capacity)).sum()
    src = order[keep]
    flat = dsort[keep].to(torch.int64) * capacity + pos[keep]

    buckets: Dict[str, torch.Tensor] = {}
    for name, a in arrays.items():
        buf = torch.zeros((ndev * capacity,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        buf[flat] = a[src]
        buckets[name] = buf
    valid = torch.zeros(ndev * capacity, dtype=torch.bool, device=dest.device)
    valid[flat] = True
    return buckets, valid, overflow


def hash_repartition(arrays, dest, ok, ndev: int, capacity: int):
    """HashExchange: send each valid row to position `dest[row]`.

    arrays: per-row payload tensors [N, ...] (same leading dim), a dict, or
    a list of dicts over the mesh's positions; dest: int32 [N] in [0, ndev)
    (a list with the lists); ok: bool [N] (invalid rows are not shipped).

    Returns (received_arrays, received_valid, overflow): received_arrays[k]
    is [ndev * capacity, ...], the position's partition of the row set
    (bucket j of every source, in source order), received_valid marks real
    rows, overflow is the number of rows dropped over every position (an
    int64 scalar tensor on the first position's device).  With lists the
    first two are lists over positions; with one dict they are one
    position's (the all_to_all is the identity)."""
    if isinstance(arrays, dict):
        return hash_buckets(arrays, dest, ok, ndev, capacity)
    sources = [hash_buckets(a, d, o, ndev, capacity) for a, d, o in zip(arrays, dest, ok)]
    if len(sources) == 1:
        return [sources[0][0]], [sources[0][1]], sources[0][2]
    home = sources[0][2].device
    overflow = sources[0][2]
    for _, _, ovf in sources[1:]:
        overflow = overflow + to_home(ovf, home)
    recv, valid = [], []
    for j, (bufs, _, _) in enumerate(sources):
        dev = sources[j][1].device
        cut = slice(j * capacity, (j + 1) * capacity)
        recv.append({k: torch.cat([to_home(src[0][k][cut], dev) for src in sources]) for k in bufs})
        valid.append(torch.cat([to_home(src[1][cut], dev) for src in sources]))
    return recv, valid, overflow


def run_lockstep(gens: List[Generator]) -> List[Any]:
    """Drive one plan closure a mesh position, each a generator, in
    lockstep: every position yields the same exchange request at the same
    point, ("broadcast", rows) or ("shuffle", arrays, dest, ok, ndev,
    capacity); the collective runs over the requests in position order and
    each position receives its part (a shuffle's overflow summed over
    positions, so every position takes the same branch).
    Returns every position's return value, in order."""
    replies: List[Any] = [None] * len(gens)
    while True:
        requests, results = [], []
        for g, reply in zip(gens, replies):
            try:
                requests.append(g.send(reply))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            if requests:
                raise RuntimeError("mesh positions left the exchange out of step")
            return results
        kind = requests[0][0]
        if kind == "broadcast":
            replies = broadcast_rows([r[1] for r in requests])
        elif kind == "shuffle":
            _, _, _, _, ndev, capacity = requests[0]
            recv, valid, overflow = hash_repartition(
                [r[1] for r in requests], [r[2] for r in requests], [r[3] for r in requests], ndev, capacity)
            replies = [(r, v, overflow) for r, v in zip(recv, valid)]
        else:
            raise ValueError(f"unknown exchange {kind!r}")
