"""``grid_select.device_ms``: the device time of every ``grid_select``
kernel in the profiler's trace (eager launches and graph replays), per
traced job, in ms."""


def read(run):
    k = (run.trace or {}).get("kernels", {}).get("grid_select")
    if not k or not k["device_launches"]:
        return None
    return 1e3 * k["device_s"] / len(run.jobs)
