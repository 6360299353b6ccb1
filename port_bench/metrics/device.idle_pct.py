"""device.idle_pct: the share of the profiled window in which no kernel,
copy or set ran on the card."""


def read(obs):
    p = obs.get("profile")
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"]) if p and p["window_s"] > 0 else None
