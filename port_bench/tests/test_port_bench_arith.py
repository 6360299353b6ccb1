"""Rate, percentile, spread, idle-share and roofline arithmetic on fixed
inputs."""
import importlib.util

import pytest

from _tiny import REPO
from port_bench.harness import launches, profile, stats


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "port_bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_rate():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_nearest_rank_percentile():
    v = list(range(1, 101))  # 1..100
    assert stats.percentile(v, 95) == 95.0 and stats.percentile(v, 50) == 50.0
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile(list(range(1, 21)), 95) == 19.0  # ceil(0.95 * 20) = 19th
    assert stats.median([1.0, 3.0, 2.0, 10.0]) == 2.5


def test_spread_as_statistics_quantiles():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    # statistics.quantiles (exclusive): q1 = 10.75, q3 = 14.25; median 12.5
    assert stats.spread(v) == pytest.approx(3.5 / 12.5)


def test_busy_union_and_gaps():
    busy = profile.busy_intervals([(0, 10), (5, 20), (30, 40), (95, 120)], 0, 100)
    assert busy == [(0, 20), (30, 40), (95, 100)]
    assert profile.gaps(busy, 0, 100) == [(20, 30), (40, 95)]
    assert profile.gaps([], 0, 100) == [(0, 100)]


def test_idle_and_copy_readers():
    obs = {"profile": {"busy_s": 1.0, "window_s": 4.0, "copy_s": 0.5, "queries": 10}}
    assert _reader("device.idle_pct")(obs) == 75.0
    assert _reader("device.copy_ms_per_query")(obs) == 50.0
    assert _reader("device.copy_ms_per_query")({"profile": {"copy_s": 0.5, "queries": 0}}) is None


def test_roofline_reader():
    peaks = {"hbm_bytes_per_s": 3.35e12}
    p = {"launches_recorded": 10, "kernel_events": 10, "least_bytes": 3.35e9, "kernel_s": 0.004}
    # 3.35e9 B at 3.35e12 B/s is 1 ms of 4 ms
    assert _reader("fused_scan.roofline_pct")({"profile": p, "peaks": peaks}) == pytest.approx(25.0)
    lost = dict(p, kernel_events=5, kernel_s=0.002)  # half the events lost: half the bytes set against them
    assert _reader("fused_scan.roofline_pct")({"profile": lost, "peaks": peaks}) == pytest.approx(25.0)
    assert _reader("fused_scan.roofline_pct")({"profile": dict(p, kernel_events=0), "peaks": peaks}) is None
    assert _reader("fused_scan.roofline_pct")({"profile": p, "peaks": None}) is None


def test_least_bytes():
    import torch

    n = 1024
    key = torch.zeros(n, dtype=torch.int32)
    mask = torch.zeros(n, dtype=torch.bool)
    mask[:100] = True  # 100 counted rows
    vals = torch.zeros(n, dtype=torch.int32)
    entries = [("int_sum", vals, mask, None), ("int_sum", vals, mask, None), ("count", None, mask, None)]
    counts = launches.launch_counts(entries, key, 0, n, None, None)
    ints = (None, {p: int(c) for p, c in counts[1].items()}, int(counts[2]), {p: int(c) for p, c in counts[3].items()})
    # the mask every row (1 B), the key and the one values stream on the 100 counted rows, 3 tables of 7 cells
    assert launches.least_bytes(entries, key, 0, n, 7, None, None, ints) == n + 100 * 4 + 100 * 4 + 3 * 7 * 8
    # filter words keep the first 64 rows: the words, then the mask on the kept rows
    words = torch.zeros(n // 32, dtype=torch.int32)
    words[0] = -1
    words[1] = -1
    counts = launches.launch_counts(entries, key, 0, n, words, None)
    ints = (int(counts[0]), {p: int(c) for p, c in counts[1].items()}, int(counts[2]),
            {p: int(c) for p, c in counts[3].items()})
    assert ints[0] == 64 and ints[2] == 64
    assert launches.least_bytes(entries, key, 0, n, 7, words, None, ints) == n // 8 + 64 + 64 * 4 + 64 * 4 + 168
    # a 16-bit packed key costs 2 bytes a counted row
    assert launches.least_bytes(entries, key, 16, n, 7, words, None, ints) == n // 8 + 64 + 64 * 2 + 64 * 4 + 168


def test_qps_and_latency_readers():
    obs = {"completed": 60, "seconds": 30.0, "latencies_ms": [float(i) for i in range(1, 101)], "setup_s": 12.5}
    assert _reader("stream.qps")(obs) == 2.0
    assert _reader("stream.latency_p50_ms")(obs) == 50.5
    assert _reader("latency_p95_ms")(obs) == 95.0
    assert _reader("setup_s")(obs) == 12.5


def test_span_readers():
    traces = [{"name": "query", "ms": 10.0, "children": [
        {"name": "plan", "ms": 1.0}, {"name": "prune", "ms": 0.5}, {"name": "scatter", "ms": 8.0},
        {"name": "reduce", "ms": 0.5}]}] * 3
    assert _reader("broker.self_ms")({"traces": traces}) == 2.0
    assert _reader("server.scatter_ms")({"traces": traces}) == 8.0
    assert _reader("broker.self_ms")({"traces": []}) is None


def test_lane_unpack_copy_matches_the_program():
    import torch

    from pinot_tpu_torch.ops import fused_scan

    words = torch.tensor([-1, 0x0F0F0F0F, 5, -(1 << 31)], dtype=torch.int32)
    for bits in (1, 4, 8, 16):
        n = 4 * 32 // bits
        assert torch.equal(launches.lane_unpack(words, bits, n), fused_scan.lane_unpack(words, bits, n))


def test_recorder_counts_after_the_window(monkeypatch):
    """While recording, a launch only keeps its operands; the rows are
    counted by total(), once the window has closed."""
    import torch

    from pinot_tpu_torch.ops import fused_scan

    calls = []
    monkeypatch.setattr(fused_scan, "_launch", lambda *a: calls.append(a) or [])
    counted = []
    real = launches.launch_counts
    monkeypatch.setattr(launches, "launch_counts", lambda *a: counted.append(a) or real(*a))
    rec = launches.LaunchRecorder()
    n = 1024
    key, vals = torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)
    mask = torch.zeros(n, dtype=torch.bool)
    mask[:100] = True
    entries = [("int_sum", vals, mask, None)]
    fused_scan._launch(entries, key, 0, n, 7, None, None)  # not recording: not kept
    rec.recording = True
    fused_scan._launch(entries, key, 0, n, 7, None, None)
    rec.recording = False
    assert len(calls) == 2 and rec.launches == 1 and not counted
    assert rec.total() == n + 100 * 4 + 100 * 4 + 7 * 8 and len(counted) == 1
    assert rec.launches == 0
    rec.remove()
    fused_scan._launch(entries, key, 0, n, 7, None, None)  # removed: the launch function is the one it wrapped
    assert len(calls) == 3 and rec.launches == 0
