"""One torch.profiler session over part of a traced window, read into the
numbers the per-layer readers and the `breakdown` take: the device's busy
time (the union of its kernels, copies and sets), its copies, the fused
scan's kernel events, the device operations that took most time, and the
longest idle gaps by what the host was doing.

A session can lose events (PR 13's finding; chip_smoke.py's _device_ms
takes only sessions that caught every launch): here the fused scan's
captured kernel events are counted against the launches the recorder
saw, and a session that caught fewer is marked incomplete."""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

KERNEL = "fused_scan_kernel"
TOP = 10
GAPS = 2000  # the longest gaps named


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_intervals(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of device intervals, clipped to [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in _merge(intervals) if b > lo and a < hi]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


CLOCK = "port_bench.clock"


def summarize(prof, window_s: float, recorded_launches: int, spans, p0: float, queries) -> Dict:
    """Times in seconds.  The window is the session's host-clock length
    from p0, where the main thread opened the CLOCK range (the profiler
    records host events of the thread that started it only, so the host
    side comes from the program's spans, tapped, and the clients' queries:
    spans (name, start, end, thread) and queries (qid, sent, done) on the
    host clock)."""
    from torch.autograd import DeviceType

    dev, anchor = [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((a, b, e.name))
        elif e.name == CLOCK:
            anchor = (a + b) / 2  # the host clock was read inside the range
    if anchor is None:
        raise RuntimeError(f"the profiler session lost its {CLOCK} range")
    lo = anchor
    hi = lo + window_s * 1e6

    def us(t: float) -> float:
        return anchor + (t - p0) * 1e6

    cpu = [(us(a), us(b), n) for n, a, b, _t in spans] + [(us(a), us(b), f"query {q} outside spans")
                                                         for q, a, b in queries]
    busy = busy_intervals([(a, b) for a, b, _n in dev], lo, hi)
    busy_s = sum(b - a for a, b in busy) / 1e6

    by_name: Dict[str, float] = defaultdict(float)
    copy_s = 0.0
    kernel_us: List[float] = []
    for a, b, n in dev:
        by_name[n[:96]] += (b - a) / 1e6
        if n.startswith("Memcpy HtoD") or n.startswith("Memcpy DtoH"):
            copy_s += (b - a) / 1e6
        if KERNEL in n:
            kernel_us.append(b - a)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    # the longest idle gaps, each named by the innermost host event open at
    # its middle (a segment's number dropped from its span's name), summed
    # by that name
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:GAPS]
    by_host: Dict[str, float] = defaultdict(float)
    if cpu:
        starts = np.array([a for a, _b, _n in cpu])
        ends = np.array([b for _a, b, _n in cpu])
        names = [n for _a, _b, n in cpu]
        for a, b in idle:
            mid = (a + b) / 2
            open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = names[open_[np.argmin(ends[open_] - starts[open_])]][:96] if len(open_) else "no query"
            name = re.sub(r"_\d+$", "_N", name)
            by_host[name] += (b - a) / 1e6
    idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]

    positive = [t for t in kernel_us if t > 0]
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "copy_s": copy_s,
        "kernel_s": sum(positive) / 1e6,
        "kernel_events": len(positive),
        "launches_recorded": recorded_launches,
        "complete": len(positive) >= recorded_launches,
        "device_ops": [[n, s] for n, s in device_ops],
        "idle_gaps": [[n, s] for n, s in idle_gaps],
    }
