"""``device_idle_pct``: the share of the traced jobs' walls in which the
card runs no kernel, copy or memset (the union of the device events of
the profiler's trace), in percent."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or not t["device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
