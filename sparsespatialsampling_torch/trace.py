"""The port's one clock: nested spans around its phases, and the records a
profiled run keeps of them.

``with span(name, device, **counts) as sp:`` times a block; ``sp.seconds``
is its duration, which every timer key of the port reads (``t_adaptive``,
``ExportData.timings["t_weights"]``, ...), and ``sp.count(...)`` adds
counts of the work it did (points, cells, snapshots, bytes copied to the
card).

Recording is on exactly while a torch profiler records, in any thread:
``torch.autograd.profiler._is_profiler_enabled`` is set for the whole
process, so the export's prefetch thread records too.

- Off, a span reads ``perf_counter`` twice and records nothing.
- On, a span also appends a record to :func:`records`, stamped in
  ``time.time_ns()`` (the clock of the profiler's CPU events), with its
  parent (the thread's enclosing span, or one given across threads), its
  thread and its run (the id of one ``SparseSpatialSampling`` object's
  spans, its ``ExportData`` and prefetch thread included).  On the thread
  the profiler traces, the span is also a ``record_function`` range in the
  profile, and a span given a CUDA ``device`` ends with a synchronise of
  that device's current stream, so its device work is charged to it; never
  during a CUDA graph capture.  A thread the profiler does not trace (the
  prefetch) neither opens ranges nor synchronises.

A record is a dict: ``name``, ``id``, ``parent`` (an id or None),
``run``, ``thread`` (``threading.get_ident()``), ``start_ns``,
``end_ns`` and ``counts``.
"""
import itertools
import threading
from time import perf_counter, time_ns

import torch
from torch.autograd import profiler as _autograd_profiler

_records = []
_ids = itertools.count(1)
_local = threading.local()
# whether the profiler traces the calling thread; where a torch release
# lacks the private query, the main thread is the one it traces
_thread_traced = getattr(
    torch._C._autograd, "_profiler_enabled",
    lambda: threading.current_thread() is threading.main_thread())


def _recording() -> bool:
    """Whether a torch profiler records, in any thread of the process
    (False where a torch release lacks the private flag)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def records() -> list:
    """The records of the spans ended while a profiler recorded, oldest
    first."""
    return list(_records)


def clear() -> None:
    """Forget every record."""
    _records.clear()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _synchronize(device: torch.device) -> None:
    torch.cuda.current_stream(device).synchronize()


class span:
    """A timed block (see the module's docstring).  ``device``: where the
    block enqueues work that it leaves queued (a CUDA device ends the
    recorded span with a synchronise); ``run`` and ``parent`` set a root
    span's run id and a parent on another thread."""

    __slots__ = ("name", "device", "counts", "seconds", "_run", "_parent",
                 "_t0", "_rec", "_range")

    def __init__(self, name: str, device=None, *, run=None, parent=None,
                 **counts):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.counts = counts
        self.seconds = 0.0
        self._run, self._parent = run, parent
        self._rec = self._range = None

    def count(self, **counts) -> None:
        """Add counts of the work the block did."""
        for key, n in counts.items():
            self.counts[key] = self.counts.get(key, 0) + n

    @property
    def id(self):
        """The record's id (None when not recording): the ``parent`` of a
        span another thread opens under this one."""
        return None if self._rec is None else self._rec["id"]

    def __enter__(self):
        if not _recording():
            self._t0 = perf_counter()
            return self
        stack = _stack()
        top = stack[-1] if stack else None
        self._rec = {
            "name": self.name, "id": next(_ids),
            "parent": (self._parent if self._parent is not None
                       else top["id"] if top else None),
            "run": (self._run if self._run is not None
                    else top["run"] if top else None),
            "thread": threading.get_ident(), "start_ns": 0, "end_ns": 0,
            "counts": self.counts}
        stack.append(self._rec)
        self._rec["start_ns"] = time_ns()
        # the profiler traces this thread: the span is one of its ranges
        if _thread_traced():
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is None:
            self.seconds = perf_counter() - self._t0
            return False
        if self._range is not None:
            if (exc[0] is None and self.device is not None
                    and self.device.type == "cuda"
                    and not torch.cuda.is_current_stream_capturing()):
                _synchronize(self.device)
            rec["end_ns"] = time_ns()
            self._range.__exit__(*exc)
            self._range = None
        else:
            rec["end_ns"] = time_ns()
        self.seconds = (rec["end_ns"] - rec["start_ns"]) / 1e9
        _stack().pop()
        _records.append(rec)
        return False
