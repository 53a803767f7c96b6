"""Run a checkout's ``chip_smoke.py`` with every phase line stamped.

    python3 smoke_phases.py CHECKOUT [on|off|cuda-only|cpu-only]

Each JSON line that names a phase gains ``t_stamp`` (seconds since the
start) and ``proc`` (the process's ``VmRSS``, ``VmHWM`` and thread count
from ``/proc/self/status``), so two runs can be compared phase by phase.
The second argument sets the export's weight-cache prefetch
(``SparseSpatialSampling.EXPORT_PREFETCH``): ``on`` (the default),
``off``, or on only for indices on the card (``cuda-only``) or on the CPU
(``cpu-only``); with any but ``on`` the smoke run's check that the exports
consumed the prefetched cache is lifted.  The exit code is the smoke
run's.
"""
import os
import sys
import time


def _status() -> dict:
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(("VmRSS", "VmHWM", "Threads")):
                key, value = line.split(":", 1)
                out[key] = value.strip()
    return out


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    mode = sys.argv[2] if len(sys.argv) > 2 else "on"
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    import sparsespatialsampling_torch as tp

    t0 = time.perf_counter()
    emit = cs.emit

    def stamped(obj):
        if isinstance(obj, dict) and "phase" in obj:
            obj = {**obj, "t_stamp": time.perf_counter() - t0,
                   "proc": _status()}
        emit(obj)
    cs.emit = stamped

    if mode == "on":
        return cs.main()
    if mode == "off":
        tp.SparseSpatialSampling.EXPORT_PREFETCH = False
    elif mode in ("cuda-only", "cpu-only"):
        keep = mode.split("-")[0]
        start = tp.SparseSpatialSampling._start_prefetch

        def start_only(self, knn_index):
            cls = type(self)
            if knn_index is None or knn_index.device.type == keep:
                return start(self, knn_index)
            saved, cls.EXPORT_PREFETCH = cls.EXPORT_PREFETCH, False
            try:
                return start(self, knn_index)
            finally:
                cls.EXPORT_PREFETCH = saved
        tp.SparseSpatialSampling._start_prefetch = start_only
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    summary = cs.export_summary
    cs.export_summary = lambda phase, exp, t, prefetch="consumed": summary(
        phase, exp, t, prefetch=exp.timings["prefetch"])
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
