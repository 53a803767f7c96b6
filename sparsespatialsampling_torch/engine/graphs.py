"""Each window iteration of the device-resident loops as one captured CUDA
graph, cached under the window's key for the run.

The counterpart of the JAX package's ``cached_jit`` over ``lax.while_loop``
(``engine/tree.py:2102-2127`` for the adaptive loop, ``:2686-2690`` for
the geometry loop): there a window is one compiled device program, cached
under everything its trace bakes in; here a window's iteration
(``device_loop.loop_body`` or ``geometry_level_body``, and the small row
the host reads after it) is one CUDA graph, cached under everything its
capture bakes in (:meth:`SamplingTree._window_key`,
:meth:`SamplingTree._geometry_key`), and every window of that key replays
it.  A replay reads and writes the addresses the capture saw, so the
state and the parameters of a key live in fixed tensors outside the
graphs' pool, which the window drivers fill before the window; only an
iteration's temporaries live in the pool.

- The first iteration of a new key runs eagerly on a side stream (the
  warm-up PyTorch asks for before a capture; it is a real iteration, and
  it fills the caches that copy from host memory at first use, such as
  ``geometry/base._card_constant`` and the STL tables, so that the capture
  never makes such a copy).  The next iteration is captured and then
  replayed, and every later one is a replay.
- One memory pool per :class:`WindowGraphs`, that is per ``refine()``,
  which drops the cache, its graphs and its pool when it returns.
- Eager without a graph: a CPU device (the CPU has no graphs), a mesh
  (its epochs copy between shards through the root, and a shard may lie
  on the CPU), and ``SamplingTree._LOOP_GRAPHS = False``.
- On the card a failed capture raises, naming the key and the operation;
  nothing runs the body eagerly in its place.  The capture is global
  (``capture_error_mode="global"``): a CUDA call of another thread during
  it fails.  The port's own worker threads (the export's prefetch,
  :func:`register_worker`) are joined before a capture, and one that is
  alive after it raises; a run that takes a cached kNN index, and an
  export that uses the engine's, join the workers that query it first.
- The kernel wrappers count their launches in Python, which a replay does
  not run: a capture records what each counter gained during it and takes
  that back (a capture launches nothing), and every replay adds it.
"""
import os
import threading
import traceback
import weakref

import torch

from .. import trace
from ..ops import grid_select, topk, winding

# the kernel launch counters a capture records and a replay adds
_COUNTERS = {"topk_smallest": topk, "winding_number": winding,
             "grid_select": grid_select}
# why an iteration ran without a graph (``stats["eager_causes"]``)
EAGER_CAUSES = ("warmup", "cpu", "mesh", "off")

# the port's worker threads, each with the id of the object it uses
_workers = weakref.WeakKeyDictionary()


def register_worker(thread: threading.Thread, holds=None) -> None:
    """A thread of the port that may enqueue CUDA work: a capture waits
    for it to end first, and so does a new user of the object ``holds``
    (:func:`join_workers`), such as a run that takes a cached kNN index."""
    _workers[thread] = id(holds)


def _live_workers(holding=None) -> list:
    """The live workers of other threads; those that hold ``holding``
    where it is given."""
    me = threading.current_thread()
    return [t for t, held in list(_workers.items())
            if t is not me and t.is_alive()
            and (holding is None or held == id(holding))]


def join_workers(holding=None) -> float:
    """Wait for the live workers of other threads: every one, or those
    registered as holding ``holding``.  Returns the seconds waited (the
    span ``workers.join``)."""
    with trace.span("workers.join") as sp:
        for t in _live_workers(holding):
            t.join()
    return sp.seconds


def new_stats() -> dict:
    """A loop's graph counters: captures, replays, iterations run eagerly
    and why, and the seconds the captures took."""
    return {"captures": 0, "replays": 0, "eager_iterations": 0,
            "eager_causes": dict.fromkeys(EAGER_CAUSES, 0),
            "capture_s": 0.0}


def _where(exc: BaseException) -> str:
    """The innermost frame of ``exc``'s traceback outside PyTorch, the
    operation that failed, as ``file:line (function): code``."""
    torch_dir = os.path.dirname(torch.__file__)
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(torch_dir)]
    if not frames:
        return "an unknown operation"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.name}): {f.line}"


class WindowGraph:
    """One captured iteration: the graph, its output row (pool memory that
    every replay rewrites) and the kernel launches a replay makes."""

    def __init__(self, graph, row: torch.Tensor, launches: dict):
        self.graph, self.row, self.launches = graph, row, launches

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        for name, n in self.launches.items():
            _COUNTERS[name].launches += n
        return self.row


class WindowGraphs:
    """The window-graph cache of one run on ``device``; with ``enabled``
    False (or on the CPU) every iteration runs eagerly."""

    def __init__(self, device: torch.device, enabled: bool = True):
        self.device = device
        self._cause = ("cpu" if device.type != "cuda" else
                       None if enabled else "off")
        # key -> None once warmed up, then the WindowGraph
        self._entries = {}
        self._pool = None
        self._stream = None

    def captured(self, key) -> bool:
        return self._entries.get(key) is not None

    def step(self, key, body, row, stats: dict, eager: str = None):
        """One iteration of the window of ``key``: ``body()`` updates the
        state in place, ``row()`` returns the row the host reads after it.
        Returns that row (a graph's own, rewritten by its next replay).
        ``eager`` names a cause to run it eagerly (``"mesh"``)."""
        cause = eager or self._cause
        if cause is None and key not in self._entries:
            self._warm_up(body)
            self._entries[key] = None
            cause = "warmup"
        if cause is not None:
            if cause != "warmup":
                body()
            stats["eager_iterations"] += 1
            stats["eager_causes"][cause] += 1
            return row()
        entry = self._entries[key]
        if entry is None:
            entry = self._entries[key] = self._capture(key, body, row, stats)
        stats["replays"] += 1
        return entry.replay()

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def _warm_up(self, body) -> None:
        """``body()`` eagerly on the side stream, ordered after and before
        the current stream's work."""
        side, main = self._side_stream(), torch.cuda.current_stream(
            self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body()
        main.wait_stream(side)

    def _capture(self, key, body, row, stats: dict) -> WindowGraph:
        join_workers()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = self._side_stream()
        side.wait_stream(torch.cuda.current_stream(self.device))
        before = {n: m.launches for n, m in _COUNTERS.items()}
        graph = torch.cuda.CUDAGraph()
        mode = torch.cuda.get_sync_debug_mode()
        sp = trace.span("graphs.capture")
        try:
            with sp, torch.cuda.stream(side):
                torch.cuda.set_sync_debug_mode("error")
                graph.capture_begin(pool=self._pool)
                try:
                    body()
                    out = row()
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:
                        pass
                    raise
                graph.capture_end()
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture of the window {key!r} failed at "
                f"{_where(exc)}: {exc}") from exc
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            launches = {n: m.launches - before[n]
                        for n, m in _COUNTERS.items()}
            for n, m in _COUNTERS.items():
                m.launches = before[n]
        if _live_workers():
            raise RuntimeError(f"a worker thread ran during the CUDA graph "
                               f"capture of the window {key!r}")
        stats["captures"] += 1
        stats["capture_s"] += sp.seconds
        return WindowGraph(graph, out,
                           {n: c for n, c in launches.items() if c})
