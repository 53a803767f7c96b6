"""The traced run (``--trace 1``): ``torch.profiler`` over the window's
first jobs, the benchmark's own spans, and the taps that count the
kernels' launches.

Spans (``record_function``, from the benchmark's side of the public
calls): ``s3bench::job``, ``s3bench::init`` (``SparseSpatialSampling``),
``s3bench::generation`` (``execute_grid_generation``), ``s3bench::export``
(``ExportData`` and ``interpolate``), ``s3bench::join`` (the end of a
job), and ``s3bench::window`` around each window of the program's device
loops.  The last reaches into private names of the program
(``SamplingTree._run_window`` and ``_run_geometry_window``), as
``chip_smoke.py``'s ``WindowTap`` does; it is here only so that a kernel
tap can tell a launch inside a window (whose rows are the window's fixed,
padded shapes) from one outside.

:class:`KernelTap` wraps the entries each ``roofline/<kernel>.py`` names.
A launch of the main thread outside the windows and outside a graph
capture is tracked: its bound's counts are enqueued on the device before
it, and it runs inside an ``s3bench::<kernel>`` span.  A kernel of the
trace is matched to its launch call (the CUDA runtime or driver event of
the same correlation id) inside a tracked span.  Not tracked: a launch
inside a window, or replayed by a window's graph, whose rows are the
window's fixed, padded shapes, which the benchmark cannot tell from live
ones; and a launch of another thread (the export's prefetch), whose
kernels the trace does not tie to their launches (see ``PERF.md``).
"""
import importlib
import inspect
import threading
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def roofline_modules(root: Path = HERE) -> dict:
    """Every ``roofline/<kernel>.py`` under ``root``, by file name."""
    from harness import load_module
    return {path.stem: load_module("roofline", path.stem, root)
            for path in sorted((root / "roofline").glob("*.py"))}


class WindowFlag:
    """Marks, per thread, whether the program is inside a device-loop
    window, and spans each window."""

    METHODS = ("_run_window", "_run_geometry_window")

    def __init__(self):
        self.local = threading.local()

    def inside(self) -> bool:
        return getattr(self.local, "depth", 0) > 0

    def __enter__(self):
        from sparsespatialsampling_torch.engine.tree import SamplingTree
        self._cls = SamplingTree
        self._orig = {m: SamplingTree.__dict__[m] for m in self.METHODS}
        for m, orig in self._orig.items():
            setattr(SamplingTree, m, staticmethod(self._wrap(orig.__func__)))
        return self

    def _wrap(self, run):
        flag = self

        def around(*args):
            flag.local.depth = getattr(flag.local, "depth", 0) + 1
            try:
                with torch.profiler.record_function("s3bench::window"):
                    return run(*args)
            finally:
                flag.local.depth -= 1
        return around

    def __exit__(self, *exc):
        for m, orig in self._orig.items():
            setattr(self._cls, m, orig)


class KernelTap:
    """Tracks the launches of one kernel on the main thread outside the
    windows (see the module's docstring).  ``records`` holds ``(facts,
    counts)`` a launch: the bound's shape facts and device counts."""

    def __init__(self, name: str, roofline, window: WindowFlag):
        self.name, self.roofline, self.window = name, roofline, window
        self.records = []

    def __enter__(self):
        self._mod = importlib.import_module(self.roofline.MODULE)
        self._orig = {e: getattr(self._mod, e) for e in self.roofline.ENTRIES}
        for entry, fn in self._orig.items():
            setattr(self._mod, entry, self._wrap(entry, fn))
        return self

    def _wrap(self, entry, fn):
        tap, sig = self, inspect.signature(fn)

        def tapped(*args, **kwargs):
            queries = args[0] if args else kwargs["queries"]
            # a call of no rows launches nothing
            if (not queries.is_cuda or queries.shape[0] == 0
                    or tap.window.inside()
                    or threading.current_thread() is not
                    threading.main_thread()
                    or torch.cuda.is_current_stream_capturing()):
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            facts, counts = tap.roofline.bound_terms(entry, bound.arguments)
            tap.records.append((facts, counts))
            with torch.profiler.record_function(f"s3bench::{tap.name}"):
                return fn(*args, **kwargs)
        return tapped

    def __exit__(self, *exc):
        for entry, fn in self._orig.items():
            setattr(self._mod, entry, fn)

    def bound_s(self, peaks: dict) -> float:
        """The tracked launches' least time (reads the counts back: call
        after a synchronise)."""
        return sum(self.roofline.bound_seconds(facts, counts.tolist(), peaks)
                   for facts, counts in self.records)


def _merge(intervals: list) -> list:
    """Union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _overlap(merged: list, s: int, e: int) -> int:
    """Length of ``[s, e)`` covered by the disjoint sorted ``merged``."""
    total = 0
    for a, b in merged:
        if b <= s:
            continue
        if a >= e:
            break
        total += min(b, e) - max(a, s)
    return total


def analyse(prof, taps: dict, peaks: dict) -> dict:
    """Reduce a profile of the traced jobs: device busy time, the device
    time of each tapped kernel (all launches, and the tracked ones), the
    idle gaps and the busiest device operations."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    device, spans, cpu_ops, launches = [], [], [], {}
    for ev in events:
        name = ev.name()
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith("s3bench::") or ev.is_user_annotation():
                continue
            device.append((start, end, name, ev.correlation_id()))
        elif name.startswith("s3bench::"):
            spans.append((start, end, name, ev.start_thread_id(),
                          ev.correlation_id()))
        elif name.startswith("aten::"):
            cpu_ops.append((start, end, name))
        elif name.startswith("cu") and "Launch" in name:
            launches[ev.correlation_id()] = (start, ev.start_thread_id())
    jobs = _merge([sp[:2] for sp in spans if sp[2] == "s3bench::job"])
    busy = _merge([dv[:2] for dv in device])
    job_ns = sum(e - s for s, e in jobs)
    busy_in_jobs = sum(_overlap(busy, s, e) for s, e in jobs)
    # the traced window is the traced jobs' walls: the making of inputs
    # between jobs (on the card too, for the snapshots) is left out
    out = {"window_s": job_ns / 1e9, "busy_s": busy_in_jobs / 1e9,
           "device_events": len(device), "kernels": {}}

    for name, tap in taps.items():
        mine = [dv for dv in device if tap.roofline.KERNEL in dv[2]]
        tracked = [sp for sp in spans if sp[2] == f"s3bench::{name}"]
        hit = []
        for s, e, _, corr in mine:
            t, tid = launches.get(corr, (None, None))
            if t is not None and any(sp[0] <= t <= sp[1] and sp[3] == tid
                                     for sp in tracked):
                hit.append(e - s)
        out["kernels"][name] = {
            "launches": len(tap.records), "bound_s": tap.bound_s(peaks),
            "matched": len(hit), "matched_s": sum(hit) / 1e9,
            "device_launches": len(mine),
            "device_s": sum(dv[1] - dv[0] for dv in mine) / 1e9}

    # the busiest device operations, and the longest idle gaps inside the
    # jobs, each named by the innermost benchmark span over it and the
    # host operator that overlaps it most
    by_name = {}
    for s, e, n, _ in device:
        inside = _overlap(jobs, s, e)
        if inside:
            by_name[n] = by_name.get(n, 0) + inside
    out["device_ops"] = [[n[:160], t / 1e9] for n, t in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:10]]
    gaps = []
    for s, e in jobs:
        cur = s
        for a, b in busy:
            if b <= s or a >= e:
                continue
            if a > cur:
                gaps.append((a - cur, cur, a))
            cur = max(cur, b)
        if e > cur:
            gaps.append((e - cur, cur, e))
    gaps.sort(reverse=True)
    named = []
    inner = [sp for sp in spans if sp[2] != "s3bench::job"]
    for length, a, b in gaps[:10]:
        mid = (a + b) // 2
        over = [sp for sp in inner if sp[0] <= mid <= sp[1]]
        label = (min(over, key=lambda sp: sp[1] - sp[0])[2][9:]
                 if over else "job")
        best, best_ov = None, 0
        for s, e, n in cpu_ops:
            ov = min(e, b) - max(s, a)
            if ov > best_ov:
                best, best_ov = n, ov
        named.append([f"{label}/{best}" if best else label, length / 1e9])
    out["idle_gaps"] = named
    return out
