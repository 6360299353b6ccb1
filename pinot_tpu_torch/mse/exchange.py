"""Exchanges: the MSE data plane between stages, at one device.

Port of pinot_tpu/mse/exchange.py.  Reference parity: pinot-query-runtime's
BlockExchange strategies (Hash/BroadcastExchange) shipping DataBlocks
through mailboxes with back-pressure.  In the JAX package an exchange is a
collective inside one compiled program over the device mesh: a broadcast is
an all_gather of the filtered build side, a hash exchange bucketizes rows by
their key's hash and sends each bucket with an all_to_all.

At one device every collective is the identity: broadcast_rows returns its
rows, and the psum and the all_to_all inside hash_repartition do nothing.
hash_repartition itself is NOT the identity: rows still ride fixed
[ndev, capacity] buckets in stable destination order with a validity mask,
and rows beyond a bucket's capacity are dropped and counted, so a shuffle
planned with shuffleSlack < 1 overflows here exactly as it does on a
one-device mesh in the JAX package, and the engine's back-pressure loop
(mse/engine.py) re-plans with a doubled slack.  hash_dest keeps any `ndev`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_INT64_MAX = (1 << 63) - 1
# the murmur3 fmix64 multiplier as a two's-complement int64 (0xFF51AFD7ED558CCD)
_FMIX_MUL = 0xFF51AFD7ED558CCD - (1 << 64)


def broadcast_rows(arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every device receives every device's rows: at one device, its own."""
    return arrays


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


def hash_repartition(
    arrays: Dict[str, torch.Tensor],
    dest: torch.Tensor,
    ok: torch.Tensor,
    ndev: int,
    capacity: int,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """HashExchange: send each valid row to device `dest[row]`.

    arrays: per-row payload tensors [N, ...] (same leading dim).
    dest:   int32 [N] in [0, ndev).
    ok:     bool [N]; invalid rows are not shipped.

    Returns (received_arrays, received_valid, overflow): received_arrays[k]
    is [ndev * capacity, ...], this device's partition of the row set;
    received_valid marks real rows; overflow (an int64 scalar tensor) is the
    number of rows dropped for exceeding a bucket's capacity.  The JAX
    package writes the buckets with mode="drop", which silently skips
    invalid rows and rows past the capacity; a CUDA index_put_ asserts on an
    out-of-range index, so those rows are filtered out before the write."""
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

    received: Dict[str, torch.Tensor] = {}
    for name, a in arrays.items():
        buf = torch.zeros((ndev * capacity,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        buf[flat] = a[src]
        received[name] = buf  # the all_to_all is the identity at one device
    valid = torch.zeros(ndev * capacity, dtype=torch.bool, device=dest.device)
    valid[flat] = True
    return received, valid, overflow
