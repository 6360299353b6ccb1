"""fused_scan.roofline_pct: the least bytes of the profiled launches over
the card's data-sheet HBM rate, over the profiled time of the fused-scan
kernels (harness/launches.py counts the bytes).  Where the session lost
kernel events, the captured events are set against as many launches' mean
bytes.  Nothing when no launch was profiled or the card is not in the
table of peaks."""


def read(obs):
    p, peaks = obs.get("profile"), obs.get("peaks")
    if not p or not peaks or not p["launches_recorded"] or not p["kernel_events"] or p["kernel_s"] <= 0:
        return None
    events = min(p["kernel_events"], p["launches_recorded"])
    least_s = p["least_bytes"] / p["launches_recorded"] * events / peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / p["kernel_s"]
