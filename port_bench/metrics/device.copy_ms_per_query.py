"""device.copy_ms_per_query: profiled host-to-device and device-to-host
copy time over the profiled window, per query completed in it."""


def read(obs):
    p = obs.get("profile")
    return 1e3 * p["copy_s"] / p["queries"] if p and p["queries"] else None
