"""``grid_select_roofline``: the tracked ``grid_select`` launches' least
time (``roofline/grid_select.py``) over their kernels' device time in the
profiler's trace, in percent.

Tracked launches are the main thread's outside the device loops' windows
and graph captures (``tracing.KernelTap``): the uniform sweep's epoch, the
host iterations' and the host escalation.  Where the trace ties a
different number of kernels to them than were tracked, there is nothing
to read."""


def read(run):
    k = (run.trace or {}).get("kernels", {}).get("grid_select")
    if not k or not k["launches"] or k["matched"] != k["launches"]:
        return None
    return 100.0 * k["bound_s"] / k["matched_s"]
