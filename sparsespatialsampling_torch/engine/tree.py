"""Metric-driven quadtree/octree refinement engine on torch.

Port of the JAX package's ``engine/tree.py``.  Cells live in flat host
arrays keyed by (level, integer lattice coordinates); creation index is
the tie-break of every selection.  Each epoch's numerics run on the
device in one fused function (:meth:`SamplingTree._epoch_core`): query
centres of every new cell and its 2^d prospective children, exact kNN
(the grid through the fused ``grid_select`` kernel, or the full scan on
small clouds), IDW prediction, the gain formula and geometry validity,
returned as one ``[M, 4]`` f32 array (gain, metric, invalid, bad).

The adaptive iterations take one of two routes, as in the JAX package:

- the device-resident loop (``SamplingTree.DEVICE_LOOP``, on by default,
  the JAX package's ``S3_TPU_DEVICE_LOOP=1``): windows of iterations whose
  ramp, gain selection, 2:1 closure, split, epoch and stop test run on
  the device over fixed shapes (``device_loop.py``); the host reads one
  small row per iteration and the new cells once per window.  It runs on
  the dilated grid layout or the full-scan core, without geometries above
  ``_FUSED_GEO_BYTES``;
- the per-iteration host loop (``S3_TPU_DEVICE_LOOP=0`` there): the host
  selects, expands and splits, and an epoch runs per iteration.  It runs
  where the loop is ineligible or switched off, and for one iteration
  where a window could not start one (a guard, the level cap).

The geometry refinement after the adaptive phase takes one of two routes,
as in the JAX package: windows of the device-resident geometry loop
(``SamplingTree._device_geometry_call``, ``device_loop.geometry_level_body``;
off with ``DEVICE_LOOP``), up to ``_GEO_LOOP_LEVELS`` levels each, whose
frontier filter, split, flags and next frontier run on the device and
whose host reads one small row a level and the new cells once a window;
or the host's per-level walk, which runs the 2:1 variant unless
``GEO_MDL_LOOP`` is set, geometries above ``_FUSED_GEO_BYTES``, levels
above 22 and each level a window could not run.  The loop tests every
child on device-built nodes, a pre-select geometry's too.

On the card each window iteration of both loops is a replay of one
captured CUDA graph a window key (``engine/graphs.py``; the JAX package
compiles a window into one cached ``lax.while_loop``): the state, series
and parameters of a window live in the run's fixed tensors
(:meth:`SamplingTree._buffer`), which the window drivers fill before the
window, and the graphs and tensors are dropped when ``refine()`` returns.
The CPU and a mesh run the bodies eagerly.

A grid query that is not provably exact is answered again inside the
epoch, as in the JAX package's ``fn_grid_dil``: over the blocked radius-4
neighbourhood (the ring), then, once a cell has had to be escalated, by
the full scan for up to 1,024 leftover rows (the rescue; ``FULL_RESCUE``
runs it from the first epoch in mode "1" and never in "0").  Cells still
``bad`` after that go to the host escalation: a radius-4 ring epoch over
their cells, then the full scan.  Every route emits the canonical
``(sq, idx)`` order with plain f32 distances, so which one answers a query
never changes a cell.  Gains and metrics are computed in f32 on the device
and kept in f64 on the host.  The top-k selection takes gain descending,
creation index ascending: on the host in the host loop, on the device (a
stable sort of the f32 gains) in the device loop, whose captured metric
and stop test are f32 as the JAX package's loop has them.  Levels above
22 (beyond exact f32 lattice centres) take the f64 host path.

Geometry validity outside the epochs (the uniform sweeps' removal and the
geometry refinement) is tested on corner nodes built in f32 on the device,
except where a bbox-routed geometry takes part: one of a pre-select type
(``STL``, ``coord_2D``) while ``pre_select`` is on, or one whose lookup
tables exceed ``_FUSED_GEO_BYTES``.  Then the nodes are built in f64 on
the host, a bounding-box test settles the cells it can, and the predicate
runs on the f32 cast of the rest — the JAX package's ``BatchedValidity``
route, whose nodes can differ from the device-built ones by an ulp.  The
epochs test every geometry in full on device-built nodes, except those
above the table budget, which they test by that host route.

With ``max_delta_level`` every refinement keeps the 2:1 balance: a cell is
split only together with each coarser leaf that touches it by a face, an
edge or a corner, transitively (:meth:`SamplingTree._expand_delta_level`
on the host, ``device_loop._mdl_expand`` in the device loop).

On one device the kNN index is kept between runs (``_KNN_INDEX_CACHE``,
one entry, keyed by :func:`_index_key`), as the JAX package keeps its own:
a sweep over one cloud builds it once.

Where sharding is enabled (``parallel/mesh.sharding_enabled``: more than
one card, or a virtual mesh), the cloud is sharded over a mesh
(``parallel.ShardedKNNIndex``), the cell state stays on the mesh's root,
and the epochs run one of the JAX package's two sharded cores
(``_build_epoch_fn_sharded``): ``shard_grid``, the row-sharded dilated
grid, each shard answering the queries whose home cell it owns, or
``shard_full``, each shard's ``k + 8`` candidates merged on the root.
There is no ring and no rescue under a mesh: a cell still ``bad`` goes
straight to the sharded full scan, and a window of the device loop ends
on it.  Both cores emit the single-device canonical order, so a sharded
grid equals the single-device one row for row.
"""
import hashlib
import logging
from functools import partial, reduce
from operator import or_
from typing import Union

import numpy as np
import torch

from .. import trace
from .._device import resolve_device
from ..ops import morton
from ..parallel import ShardedKNNIndex, default_mesh, sharding_enabled
from ..ops.knn import (KNNIndex, _blocked_topk, _dilated_topk, _fma, _idw,
                       _rowsum, _search, _weighted_sum)
from . import graphs
from .device_loop import (WHY_BAD, WHY_BUDGET, WHY_FILL, WHY_LEVEL, WHY_MDL,
                          WHY_OVER, _bucket, _cell_size, _corner_nodes_f32,
                          _first_rows, geometry_level_body, geometry_may_run,
                          geometry_params, loop_body, loop_params, may_run)

logger = logging.getLogger(__name__)

# child-centre direction order of the reference (``s_cube.py:188-194``); kept
# so faces / centres are emitted in the identical corner order
DIRECTIONS = {
    2: np.asarray([[-1, -1], [-1, 1], [1, 1], [1, -1]], dtype=np.float64),
    3: np.asarray([[-1, -1, 1], [-1, 1, 1], [1, 1, 1], [1, -1, 1],
                   [-1, -1, -1], [-1, 1, -1], [1, 1, -1], [1, -1, -1]],
                  dtype=np.float64),
}
# equivalent lattice offsets in {0, 1}^d
OFFSETS = {d: ((DIRECTIONS[d] + 1) // 2).astype(np.int64) for d in (2, 3)}

# the size-1 reuse of the single-device kNN index across SamplingTree
# instances (the JAX package's ``_KNN_INDEX_CACHE``): ``{"entry": (key,
# index)}``, the key of :func:`_index_key`.  A ``min_metric`` sweep over one
# cloud builds its index once; the entry keeps the index's device tensors
# alive between runs until ``_KNN_INDEX_CACHE.clear()`` or the next miss
_KNN_INDEX_CACHE: dict = {}
# max cells per epoch pass (1 + 2^d queries each); doubled in 3D when the
# grid capacity is <= 32
_EPOCH_CHUNK = {2: 16384, 3: 4096}
# deepest level whose lattice centres are exact in f32
_F32_LEVEL_CAP = 22
# the in-epoch ring: a first pass of up to 256 bad queries at radius 4,
# then batches of up to 1,024 until every bad query has been tried once at
# radius 4 (a radius-4 row is (2·4+1)^d slabs of C points, 280 KB at C = 32
# in 3D, so a batch gathers at most ~290 MB)
_RING_PLAN = ((256, 4),)
_RING_LOOP_ROWS = 1024
_RING_LOOP_RADIUS = 4
# rows the in-epoch full-scan rescue answers at most per epoch pass, and
# at least per epoch of a window once it runs there
_RESCUE_ROWS = 1024
_LOOP_RESCUE_MIN = 128
# cells per host ring epoch (the JAX package's host escalation)
_RETRY_RING_CELLS = 256
# geometry types whose validity outside the epochs takes the bbox
# pre-select route when ``pre_select`` is on
_PRE_SELECT_TYPES = ("STL", "coord_2D")
# lookup-table bytes above which a geometry takes the bbox route
# everywhere, the epochs included, whatever ``pre_select`` says (the JAX
# package's budget, ``engine/tree.py:368``; there it keeps large tables
# out of compiled programs; here it keeps the JAX package's node sets,
# which decide flags at ulp distance)
_FUSED_GEO_BYTES = 16 * 2 ** 20
# narrowest selection of the device-resident loop, in cells an iteration
_LOOP_MIN_WIDTH = 8
# most ring rows an epoch of the device-resident loop tries (bad queries
# beyond them end the window and go to the host escalation)
_LOOP_RING_ROWS = 8192
# why a window ended (``epoch_stats["window_exits"]``): the stop test, a
# full window, or the causes of ``device_loop.WHY_*``
_EXITS = ("stop", "window_full", "bad_rows", "budget", "mdl", "level_cap",
          "fill")
_WHY_EXIT = {WHY_BAD: "bad_rows", WHY_BUDGET: "budget", WHY_MDL: "mdl",
             WHY_LEVEL: "level_cap", WHY_FILL: "fill"}
# why a host iteration ran although the device loop was eligible
# (``epoch_stats["host_fallback"]``): a window ran none on a guard, at the
# level cap, or because its f32 stop test stopped where the host's f64
# one goes on; or the loop's budget outgrew its epoch blocks
_FALLBACKS = ("guard", "level_cap", "stop_test", "disabled")
# why a window of the geometry loop ended (``geometry_route["window_exits"]``):
# the target level or an empty frontier, a full window, or a cause of
# ``device_loop.WHY_*``; and why a geometry level ran on the host
# (``geometry_route["host_fallback"]``): the JAX package's host route (the
# loop switched off, the 2:1 balance without ``GEO_MDL_LOOP``, tables
# above ``_FUSED_GEO_BYTES``), a level above the f32 level cap, a surface
# wider than the window, or the 2:1 closure's guard
_GEO_EXITS = ("done", "window_full", "overflow", "level_cap", "mdl")
_GEO_FALLBACKS = ("route", "level_cap", "overflow", "mdl")
_GEO_WHY_EXIT = {WHY_OVER: "overflow", WHY_LEVEL: "level_cap",
                 WHY_MDL: "mdl"}


def _index_key(vertices, target, device) -> tuple:
    """The :data:`_KNN_INDEX_CACHE` key of a single-device index: the sha1
    of the cloud's and of the metric's f64 bytes, their shapes, the
    ``KNNIndex`` build policy and the device.  Equal keys build equal
    indices."""
    v64 = np.ascontiguousarray(vertices, dtype=np.float64)
    m64 = np.ascontiguousarray(target, dtype=np.float64)
    policy = (KNNIndex.GRID_MIN_POINTS, KNNIndex.GRID_OCCUPANCY,
              KNNIndex.GRID_CAPACITY, KNNIndex.GRID_SHRINK_TARGET,
              KNNIndex.GRID_CHUNK, KNNIndex.DIL_MAX_BYTES)
    return (hashlib.sha1(v64).hexdigest(), hashlib.sha1(m64).hexdigest(),
            v64.shape, m64.shape, policy, str(device))


def _loop_rows(n: int, minimum: int, most: int) -> int:
    """Rows for ``n`` bad queries in a window's epochs: a power of two of
    at least ``minimum`` and at most ``most``; none for none."""
    return min(most, _bucket(n, minimum=minimum)) if n else 0


def _ring_plan(n: int) -> list:
    """Ring pass sizes covering ``n`` rows: the ``_RING_PLAN`` pass, then
    batches of ``_RING_LOOP_ROWS``."""
    ((size, _),) = _RING_PLAN
    plan = []
    while n > 0:
        plan.append(min(size, n))
        n -= size
        size = _RING_LOOP_ROWS
    return plan


def _huge(g) -> bool:
    """Whether geometry ``g``'s lookup tables exceed ``_FUSED_GEO_BYTES``."""
    return g.device_table_bytes > _FUSED_GEO_BYTES


def _enqueue_ahead(step, steps: int, reader) -> list:
    """Run ``step()`` up to ``steps + 1`` times one ahead of the host's
    knowledge: the row ``step()`` returns after step t is posted, and
    waited for after step t + 1 is enqueued, which runs as a no-op where t
    was the last (the row's first entry false).  Returns the last row
    waited for."""
    prev = None
    for _ in range(steps + 1):
        cur = reader.post(step())
        if prev is not None:
            got = reader.wait(prev)
            if not got[0]:
                return got
        prev = cur
    return reader.wait(prev)


class _Reader:
    """Small device rows read back behind the enqueue: on the card a row
    is copied into pinned host memory behind an event, so the host goes
    on enqueueing until it waits for that event.  The enqueue is one step
    ahead at most, so two pinned rows and two events, taken in turn, serve
    a window.  ``reads`` counts the reads the host waited for."""

    def __init__(self, device):
        self._cuda = device.type == "cuda"
        self.reads = 0
        self._slots = None
        self._turn = 0

    def post(self, row: torch.Tensor):
        if not self._cuda:
            return row.clone()
        if self._slots is None:
            self._slots = [(torch.empty(row.shape, dtype=row.dtype,
                                        pin_memory=True), torch.cuda.Event())
                           for _ in range(2)]
        host, event = self._slots[self._turn]
        self._turn ^= 1
        host.copy_(row, non_blocking=True)
        event.record(torch.cuda.current_stream(row.device))
        return host, event

    def wait(self, posted) -> list:
        """The posted row; on the card its event's wait raises a fault of
        the work before it (a failed replay never reads as a row)."""
        self.reads += 1
        if not self._cuda:
            return posted.tolist()
        host, event = posted
        event.synchronize()
        return host.tolist()


class SamplingTree:
    """Generate a metric-based adaptive grid from a CFD point cloud.

    Constructor mirrors the JAX package's ``SamplingTree`` (reference
    ``s_cube.py:87-90``) without its process-pool switch; ``device=None``
    means the card."""

    # the device-resident adaptive loop, the JAX package's default route
    # (its ``S3_TPU_DEVICE_LOOP``); False runs every adaptive iteration on
    # the host
    DEVICE_LOOP = True
    # iterations a window may run (4x that for budgets of at most 512
    # children an iteration)
    _DEVICE_LOOP_ITERS = 64
    # rounds of the in-loop 2:1 closure; a deeper chain guard-exits to the
    # host's general walk
    _MDL_ROUNDS = 4
    # the geometry-refinement loop with the 2:1 balance (the JAX package's
    # ``S3_TPU_GEO_MDL_LOOP``, off there by default on a measured trade-off);
    # False keeps such runs on the host's per-level walk
    GEO_MDL_LOOP = False
    # the in-epoch full-scan rescue (the JAX package's
    # ``S3_TPU_FULL_RESCUE``): "auto" turns it on at the first cell
    # escalation, "1" runs it from the first epoch, "0" never (bad cells
    # then all take the host escalation).  It moves no cell
    FULL_RESCUE = "auto"
    # levels a window of the geometry loop may run
    _GEO_LOOP_LEVELS = 8
    # each window iteration of both loops as a replay of one captured CUDA
    # graph a window key (``engine/graphs.py``; on the card only, never on
    # a mesh); False runs the bodies eagerly, to time them beside the
    # graphs
    _LOOP_GRAPHS = True

    def __init__(self, vertices, target, geometry_obj: list,
                 n_cells: int = None, uniform_level: int = 5,
                 min_metric: float = 0.75, max_delta_level: bool = False,
                 n_cells_iter_start: int = None, n_cells_iter_end: int = None,
                 relTol: Union[int, float] = 1e-3,
                 reach_at_least: float = 0.75, pre_select: bool = False,
                 device=None):
        if self.FULL_RESCUE not in ("auto", "1", "0"):
            raise ValueError(f"SamplingTree.FULL_RESCUE is "
                             f"{self.FULL_RESCUE!r}; use 'auto', '1' or '0'")
        self.device = resolve_device(device)
        vertices = np.asarray(vertices, dtype=np.float64)
        target = np.asarray(target, dtype=np.float64).squeeze()

        self._geometry = geometry_obj
        self._pre_select = pre_select
        self._max_delta_level = max_delta_level
        self._min_metric = min_metric
        self._n_cells_max = n_cells
        self._min_level = uniform_level
        self._current_min_level = 0
        self._current_max_level = 0
        self._n_dimensions = d = vertices.shape[-1]
        self._n_cells_orig = target.shape[0]

        # cells refined per adaptive iteration: 0.1 % of the original grid
        # at the start (reference ``s_cube.py:147-156``)
        self._cells_per_iter_start = (int(0.001 * vertices.shape[0])
                                      if n_cells_iter_start is None
                                      else n_cells_iter_start)
        if self._cells_per_iter_start <= 0:
            self._cells_per_iter_start = 1
        self._cells_per_iter_end = (self._cells_per_iter_start
                                    if n_cells_iter_end is None
                                    else n_cells_iter_end)
        self._cells_per_iter = self._cells_per_iter_start
        self._cells_per_iter_last = 1e9
        self._reach_at_least = reach_at_least
        if relTol is None:
            self._relTol = 1e-3 if n_cells is None else 10
        else:
            self._relTol = relTol

        # k-NN regressor: k = 8 (2D) / 26 (3D), inverse-distance weights
        # (reference ``s_cube.py:161-163``)
        self._n_neighbors = 8 if d == 2 else 26
        # t_knn: the seconds of the spans ``knn.key``, ``workers.join``
        # and ``knn.build``
        if sharding_enabled(self.device):
            # the cloud sharded over the mesh; the state on its root
            self._mesh = default_mesh(self.device)
            self.device = self._mesh.root
            with trace.span("knn.build", self.device,
                            points=vertices.shape[0]) as sp:
                self._knn = ShardedKNNIndex(vertices, self._mesh,
                                            values=target)
            t_knn = sp.seconds
            core = self._knn.core_kind
        else:
            self._mesh = None
            # one index a cloud, metric, build policy and device, reused
            # across runs (the JAX package's size-1 cache); a worker of an
            # earlier run (the export's prefetch) may still query it
            with trace.span("knn.key", points=vertices.shape[0]) as sp:
                key = _index_key(vertices, target, self.device)
            t_knn = sp.seconds
            entry = _KNN_INDEX_CACHE.pop("entry", None)
            if entry is not None and entry[0] == key:
                self._knn = entry[1]
                t_knn += graphs.join_workers(self._knn)
                self._knn.last_fallback = 0     # as a fresh build has it
            else:
                del entry   # the old index's memory before the new build
                self._knn = KNNIndex(vertices, values=target,
                                     device=self.device)
                t_knn += self._knn.build_s
            _KNN_INDEX_CACHE["entry"] = (key, self._knn)
            grid = self._knn._grid
            core = ("full" if grid is None else
                    "dil" if "dil_pts" in grid else "blocked")

        # flat cell arrays (append-only; index == creation order == tie-break)
        self._cap = 4096
        self._coords = np.zeros((self._cap, d), dtype=np.int64)
        self._level = np.zeros(self._cap, dtype=np.int32)
        self._alive = np.zeros(self._cap, dtype=bool)
        self._metric_arr = np.zeros(self._cap, dtype=np.float64)
        self._gain = np.zeros(self._cap, dtype=np.float64)
        self._n_cells = 0

        self._offsets = OFFSETS[d]
        self._dirs = DIRECTIONS[d]
        self._max_depth = morton.MAX_DEPTH[d]

        self._metric = []       # captured-metric history
        self._n_cells_log = []  # leaf-count history
        self._n_cells_after_uniform = None
        self.data_final_mesh = {}
        # the phases' seconds, each read off its span
        self._times = {"t_init": 0.0, "t_knn_build": t_knn,
                       "t_uniform": 0.0, "t_adaptive": 0.0,
                       "t_geometry": None, "t_renumbering": 0.0,
                       "adaptive_split": {}, "renumber_split": {},
                       "geometry_split": {"t_window": 0.0, "t_host": 0.0}}
        # epoch accounting: the epoch core (``dil``, ``blocked`` or
        # ``full`` on one device, ``shard_grid`` or ``shard_full`` on a
        # mesh); query count; main, host-ring and full-scan
        # passes; cells that left their epoch still bad, and those of them
        # the host ring left to the full scan; queries the in-epoch ring
        # and the in-epoch full-scan rescue answered; wall seconds of all
        # epochs, the windows' included, escalations and all (the spans
        # ``engine.epochs`` and ``engine.window``), and of the host
        # escalation (``engine.retry``).  The device-resident loop's
        # windows: how many, the iterations they ran, why each ended,
        # the host iterations run because a window could not start one,
        # state uploads and rows scattered on re-entry, and the reads back
        # to the host that ``_device_adaptive_call`` made; and the geometry
        # loop's windows, their levels, the host levels and why, why each
        # window ended, and the reads back ``_device_geometry_call`` made;
        # each loop's CUDA graphs (``graphs.new_stats``)
        self._epoch_stats = {"core": core, "queries": 0,
                             "n_calls_main": 0,
                             "n_calls_ring": 0, "n_calls_full": 0,
                             "n_bad_cells": 0, "full_scan_cells": 0,
                             "ring_queries": 0, "rescued_queries": 0,
                             "wall_s": 0.0, "t_retry_s": 0.0,
                             "windows": 0, "window_iters": 0,
                             "window_exits": dict.fromkeys(_EXITS, 0),
                             "host_fallback": dict.fromkeys(_FALLBACKS, 0),
                             "state_uploads": 0, "rows_reuploaded": 0,
                             "d2h_syncs": 0, "graphs": graphs.new_stats(),
                             "geometry_route": {
                                 "windows": 0, "window_levels": 0,
                                 "host_levels": 0,
                                 "window_exits": dict.fromkeys(_GEO_EXITS, 0),
                                 "host_fallback": dict.fromkeys(
                                     _GEO_FALLBACKS, 0),
                                 "d2h_syncs": 0,
                                 "graphs": graphs.new_stats()}}
        # the in-epoch full-scan rescue: on from the start in mode "1"; in
        # "auto" it turns on at the first cell escalation
        self._rescue_active = self.FULL_RESCUE == "1"
        # the device loop: off for good once its budget outgrows the
        # epoch blocks; its state after a window (for a cheap re-entry);
        # the ring rows and rescue rows of each of a window's epochs,
        # sized from the bad queries the epochs before it met (none until
        # an epoch meets one)
        self._device_loop_disabled = False
        self._dev_state = None
        # the windows' CUDA graphs and their fixed state, parameter and
        # series tensors, for one refine()
        self._graphs = None
        self._bufs = {}
        self._loop_ring_rows = 0
        self._loop_rescue_rows = 0
        # the geometry loop's (k_geo, cap) per geometry, kept for the phase
        self._geo_loop_shapes = {}

        self.all_nodes = None
        self.all_centers = None
        self.all_levels = None
        self.face_ids = None

        # root cell: cube of edge ``main_width`` centred on the domain
        # geometry (reference ``_create_first_cell``, s_cube.py:338-397)
        self._width = None
        middle = None
        for g in self._geometry:
            if g.keep_inside:
                self._width = float(g.main_width)
                middle = np.asarray(g.center, dtype=np.float64)
            if np.asarray(g.center).shape[0] != d:
                raise ValueError(
                    f"The number of dimensions for geometry object "
                    f"'{g.name}' with dim = {np.asarray(g.center).shape[0]} "
                    f"is not matching the number of dimensions within the "
                    f"CFD grid with dim = {d}.")
        if middle is None:
            raise ValueError("No GeometryObject with 'keep_inside=True', "
                             "representing the numerical domain, was found.")
        self._lo = middle - 0.5 * self._width  # lattice origin

        # f32 epoch constants on the device, and the root cell
        dev = self.device
        with trace.span("engine.setup", dev) as setup:
            self._lo_t = torch.tensor(self._lo, dtype=torch.float32,
                                      device=dev)
            self._width_t = torch.tensor(self._width, dtype=torch.float32,
                                         device=dev)
            self._dirs_t = torch.tensor(self._dirs, dtype=torch.float32,
                                        device=dev)
            self._offsets_t = torch.tensor(self._offsets, dtype=torch.float32,
                                           device=dev)
            self._shift_t = torch.tensor(self._knn._shift, dtype=torch.float32,
                                         device=dev)
            # the device loop's integer child offsets and the 3^d - 1
            # neighbour directions of its 2:1 closure
            self._offsets_i = torch.tensor(self._offsets, device=dev)
            nbdirs = np.stack(np.meshgrid(*([np.array([-1, 0, 1])] * d),
                                          indexing="ij"),
                              axis=-1).reshape(-1, d)
            self._nbdirs_i = torch.tensor(nbdirs[(nbdirs != 0).any(axis=1)],
                                          dtype=torch.int64, device=dev)

            self._target_norm = float(np.linalg.norm(target))
            self._print_settings()
            self._create_first_cell(middle)
            self._gain0_t = torch.tensor(self._gain0, dtype=torch.float32,
                                         device=dev)
        self._times["t_init"] = t_knn + setup.seconds

    # ------------------------------------------------------------------ #
    # lattice helpers                                                    #
    # ------------------------------------------------------------------ #
    def _centers_of(self, coords: np.ndarray, level: np.ndarray) -> np.ndarray:
        """Cell centres ``lo + (coords + 0.5) * width / 2^level`` (f64)."""
        h = self._width / np.exp2(level.astype(np.float64))[:, None]
        return self._lo + (coords.astype(np.float64) + 0.5) * h

    def _gain_query_centers(self, coords, level) -> np.ndarray:
        """Own centre + the 2^d prospective child centres ``[M, 1+2^d, d]``
        (f64)."""
        centers = self._centers_of(coords, level)
        h = self._width / np.exp2(level.astype(np.float64))[:, None, None]
        children = centers[:, None, :] + self._dirs[None, :, :] * 0.25 * h
        return np.concatenate([centers[:, None, :], children], axis=1)

    def _cells_on_device(self, idx: np.ndarray):
        """f32 lattice coords ``[M, d]`` and levels ``[M]`` of ``idx``."""
        coords = torch.from_numpy(self._coords[idx].astype(np.float32))
        level = torch.from_numpy(self._level[idx].astype(np.float32))
        return coords.to(self.device), level.to(self.device)

    # ------------------------------------------------------------------ #
    # cell bookkeeping                                                   #
    # ------------------------------------------------------------------ #
    def _grow(self, needed: int) -> None:
        if self._n_cells + needed <= self._cap:
            return
        new_cap = self._cap
        while self._n_cells + needed > new_cap:
            new_cap *= 2
        for name in ("_coords", "_level", "_alive", "_metric_arr", "_gain"):
            old = getattr(self, name)
            new = np.zeros((new_cap,) + old.shape[1:], dtype=old.dtype)
            new[:self._n_cells] = old[:self._n_cells]
            setattr(self, name, new)
        self._cap = new_cap

    def _append_cells(self, coords: np.ndarray, level: np.ndarray):
        m = coords.shape[0]
        self._grow(m)
        sl = slice(self._n_cells, self._n_cells + m)
        self._coords[sl] = coords
        self._level[sl] = level
        self._alive[sl] = True
        self._n_cells += m
        return np.arange(sl.start, sl.stop)

    def _alive_idx(self) -> np.ndarray:
        return np.nonzero(self._alive[:self._n_cells])[0]

    def _create_first_cell(self, middle: np.ndarray) -> None:
        d = self._n_dimensions
        queries = np.concatenate(
            [middle[None, :],
             middle[None, :] + self._dirs * 0.25 * self._width],
            axis=0)
        pred = self._knn.predict_host(queries, self._n_neighbors).astype(
            np.float64)
        # gain of the level-0 cell: (width/2)^d * sum |m0 - m_child|
        # (reference ``s_cube.py:374-381``), the gain normaliser
        gain0 = (self._width / 2.0) ** d * np.abs(pred[0] - pred[1:]).sum()
        if abs(gain0) < 1e-6:
            gain0 = 1.0
        self._gain0 = float(gain0)
        idx = self._append_cells(np.zeros((1, d), dtype=np.int64),
                                 np.zeros(1, dtype=np.int32))
        self._metric_arr[idx] = pred[0]
        self._gain[idx] = self._gain0

    # ------------------------------------------------------------------ #
    # per-epoch numerics                                                 #
    # ------------------------------------------------------------------ #
    def _query_centers(self, coords, level):
        """Centred f32 queries ``[M·(1+2^d), d]``: each cell's centre, then
        its 2^d prospective child centres."""
        h = _cell_size(self._width_t, level)
        # one rounding: XLA's CPU backend fuses this multiply-add
        centers = _fma(coords + 0.5, h[:, None], self._lo_t)
        child = (centers[:, None, :]
                 + self._dirs_t[None, :, :] * (0.25 * h)[:, None, None])
        queries = torch.cat([centers[:, None, :], child], dim=1)
        return (queries - self._shift_t).reshape(-1, self._n_dimensions)

    def _invalid_on_device(self, coords, level, geometries,
                           refine_geometry: bool = False):
        """OR over ``geometries`` of the cell test on f32 corner nodes."""
        if not geometries:
            return torch.zeros(coords.shape[0], dtype=torch.bool,
                               device=self.device)
        nodes = _corner_nodes_f32(coords, level, self._lo_t, self._width_t,
                                  self._offsets_t)
        return reduce(or_, [g.check_cells(nodes, refine_geometry)
                            for g in geometries])

    def _gain_tail(self, level, pred, invalid, bad):
        """Packed ``[M, 4]`` (gain, metric, invalid, bad) from the
        ``[M·(1+2^d)]`` predictions, with the gain
        ``h^d · Σ|m0 − m_child| / 2^d / gain0``."""
        d = self._n_dimensions
        h = _cell_size(self._width_t, level)
        pred = pred.reshape(-1, 1 + 2 ** d)
        sum_delta = _rowsum(torch.abs(pred[:, :1] - pred[:, 1:]))
        hd = h
        for _ in range(d - 1):
            hd = hd * h
        gain = hd * sum_delta / (2 ** d) / self._gain0_t
        return torch.stack([gain, pred[:, 0], invalid.to(pred.dtype),
                            bad.to(pred.dtype)], dim=1)

    def _epoch(self, idx: np.ndarray, mode: str = "grid") -> np.ndarray:
        """One fused epoch pass over cells ``idx`` → ``[M, 4]`` f32 (gain,
        metric, invalid, bad) on the host (:meth:`_epoch_core`), its ring
        and rescue sized to the bad queries it finds.  Geometries whose
        tables exceed ``_FUSED_GEO_BYTES`` are tested by the JAX package's
        host-merged route (its ``_host_geo_validity``): host-built nodes
        behind the box."""
        coords, level = self._cells_on_device(idx)
        huge = [g for g in self._geometry if _huge(g)]
        host_invalid = (torch.from_numpy(self._cell_flags_host(
            idx, huge, False)).to(self.device) if huge else None)
        out, counts = self._epoch_core(coords, level, mode, host_invalid)
        st = self._epoch_stats
        st["queries"] += int(idx.size) * (1 + 2 ** self._n_dimensions)
        counts = counts.tolist()
        st["ring_queries"] += counts[1]
        st["rescued_queries"] += counts[3]
        if counts[0]:
            # the device loop's ring starts at the JAX package's first pass
            self._loop_ring_rows = max(self._loop_ring_rows,
                                       _RING_PLAN[0][0])
        return out.cpu().numpy()

    def _epoch_core(self, coords, level, mode: str, host_invalid=None,
                    slot=None, ring_plan=None, rescue_rows=None):
        """The fused epoch on the device: ``([M, 4] f32 (gain, metric,
        invalid, bad), [4] int64 counts)`` for cells given as f32 lattice
        ``coords [M, d]`` and ``level [M]``.  The counts are the bad
        queries before the ring, those the ring proved exact, those it
        tried and could not, and those the rescue answered.  A cell is
        ``bad`` when one of its queries is not provably exact.

        - ``"grid"`` (the JAX package's ``fn_grid_dil``): the dilated
          query, or the blocked one at radius 1 where the index has no
          dilated layout; then the ring over the bad queries of valid cells
          (invalid cells are removed regardless, so their queries are never
          retried), then the full-scan rescue.  The ring's pass sizes are
          ``ring_plan`` and the rescue's rows ``rescue_rows``; left None,
          they cover every bad query (one read of their count each), the
          rescue only once it is active.  With both given the pass reads
          nothing back, as the device-resident loop needs; ``slot`` then
          marks the cells that exist (the others' queries are never bad).
        - ``"ring"`` (``fn_grid_ring``): every query over the blocked
          radius-4 neighbourhood, for the host escalation.
        - ``"full"``: the exact full scan, never bad.

        The query centres are computed once and serve every route, so a
        query answered by the ring or the rescue gets the answer its own
        full-scan retry would."""
        knn = self._knn
        k = self._n_neighbors
        n_children = 1 + 2 ** self._n_dimensions
        queries = self._query_centers(coords, level)
        invalid = self._invalid_on_device(
            coords, level, [g for g in self._geometry if not _huge(g)])
        if host_invalid is not None:
            invalid = invalid | host_invalid
        nq = queries.shape[0]
        counts = torch.zeros(4, dtype=torch.int64, device=self.device)
        if self._mesh is not None:
            return self._sharded_epoch_tail(queries, level, mode, invalid,
                                            slot, counts)
        if mode == "full":
            sq, nbr = _search(queries, knn._points, knn._points_sq, k,
                              knn._tile_n, knn._tile_q)
            badq = torch.zeros(nq, dtype=torch.bool, device=self.device)
        elif mode == "ring":
            sq = torch.zeros((nq, k), dtype=torch.float32, device=self.device)
            nbr = torch.zeros((nq, k), dtype=torch.int64, device=self.device)
            badq = torch.ones(nq, dtype=torch.bool, device=self.device)
            self._ring(queries, sq, nbr, badq, counts, _ring_plan(nq))
        else:
            if "dil_pts" in knn._grid:
                sq, nbr, _, ok, _ = _dilated_topk(queries, knn._grid, k)
            else:
                sq, nbr, ok = _blocked_topk(queries, knn._grid, k)
            badq = ~ok & ~invalid.repeat_interleave(n_children)
            if slot is not None:
                badq &= slot.repeat_interleave(n_children)
            counts[0] = badq.sum()
            if ring_plan is None:
                ring_plan = _ring_plan(int(counts[0]))
            self._ring(queries, sq, nbr, badq, counts, ring_plan)
            if rescue_rows is None:
                rescue_rows = (min(int(badq.sum()), _RESCUE_ROWS)
                               if self._rescue_active else 0)
            if rescue_rows:
                self._rescue(queries, sq, nbr, badq, counts, rescue_rows)
        bad = badq.reshape(-1, n_children).any(dim=1)
        pred = _weighted_sum(_idw(sq), knn._values[nbr])
        return self._gain_tail(level, pred, invalid, bad), counts

    def _sharded_epoch_tail(self, queries, level, mode: str, invalid,
                            slot, counts):
        """The kNN and the packed output of :meth:`_epoch_core` under a
        mesh (the JAX package's ``fn_grid`` and ``fn`` of
        ``_build_epoch_fn_sharded``): the ``shard_grid`` core for
        ``"grid"`` where the index has it, else the ``shard_full`` core,
        never bad.  No ring and no rescue: ``counts[0]`` alone is set."""
        knn, k = self._knn, self._n_neighbors
        n_children = 1 + 2 ** self._n_dimensions
        if mode == "grid" and knn.core_kind == "shard_grid":
            sq, _, vals, ok = knn.grid_select(queries, k)
            badq = ~ok & ~invalid.repeat_interleave(n_children)
            if slot is not None:
                badq &= slot.repeat_interleave(n_children)
            counts[0] = badq.sum()
        else:
            sq, nbr = knn.full_select(queries, k)
            vals = knn._values[nbr]
            badq = torch.zeros(queries.shape[0], dtype=torch.bool,
                               device=self.device)
        bad = badq.reshape(-1, n_children).any(dim=1)
        pred = _weighted_sum(_idw(sq), vals)
        return self._gain_tail(level, pred, invalid, bad), counts

    def _ring(self, queries, sq, nbr, badq, counts, plan) -> None:
        """Answer the queries marked in ``badq`` again over the blocked
        radius-4 neighbourhood, in place on ``sq``, ``nbr`` and ``badq``
        (the JAX package's ring passes, ``fn_grid_dil``): each pass of
        ``plan`` takes the given number of marked rows not yet tried, in
        ascending index.  Each row is tried once; its answer does not
        depend on the pass it rides in.  A row the ring cannot prove exact
        keeps the ring's answer and stays marked.  Adds the rows it proved
        exact to ``counts[1]`` and those it could not to ``counts[2]``."""
        tried = torch.zeros_like(badq)
        for rr in plan:
            rows, m = _first_rows(badq & ~tried, rr)
            # the rows past the marked ones are not scored (the kernel's
            # mask): their answers would be thrown away below
            rsq, ridx, rok = _blocked_topk(queries[rows], self._knn._grid,
                                           self._n_neighbors,
                                           _RING_LOOP_RADIUS, mask=m)
            sq[rows] = torch.where(m[:, None], rsq, sq[rows])
            nbr[rows] = torch.where(m[:, None], ridx, nbr[rows])
            badq[rows] = torch.where(m, ~rok, badq[rows])
            tried[rows] = tried[rows] | m
            counts[1] += (m & rok).sum()
        counts[2] += (tried & badq).sum()

    def _rescue(self, queries, sq, nbr, badq, counts, rr: int) -> None:
        """The exact full scan for the first ``rr`` queries still marked in
        ``badq`` (ascending index), in place, as the JAX package's
        in-kernel rescue; adds how many it answered to ``counts[3]``."""
        knn = self._knn
        rows, m = _first_rows(badq, rr)
        rsq, ridx = _search(queries[rows], knn._points, knn._points_sq,
                            self._n_neighbors, knn._tile_n, knn._tile_q)
        sq[rows] = torch.where(m[:, None], rsq, sq[rows])
        nbr[rows] = torch.where(m[:, None], ridx, nbr[rows])
        badq[rows] = badq[rows] & ~m
        counts[3] += m.sum()

    def _maybe_enable_rescue(self) -> None:
        """At the first cell escalation, turn the in-epoch full-scan rescue
        on for every later epoch (the JAX package's default "auto" mode,
        which spares hole-free runs its cost); only in that mode, never
        under a mesh or without a grid."""
        if (self._rescue_active or self._mesh is not None
                or self._knn._grid is None or self.FULL_RESCUE != "auto"):
            return
        logger.info("Bad cells appeared: enabling the in-epoch full-scan "
                    "rescue for subsequent epochs.")
        self._rescue_active = True

    def _update_gain(self, idx: np.ndarray) -> None:
        """f64 host path of the gain (levels above 22): predict the metric
        at each cell centre and its prospective child centres, then
        ``1/2^d * (width / 2^level)^d * Σ|m0 - m_i| / gain0`` (reference
        ``s_cube.py:207-241``)."""
        if idx.size == 0:
            return
        d = self._n_dimensions
        q = self._gain_query_centers(self._coords[idx], self._level[idx])
        m = q.shape[1]
        pred = np.asarray(self._knn.predict(q.reshape(-1, d),
                                            self._n_neighbors),
                          dtype=np.float64).reshape(-1, m)
        sum_delta = np.abs(pred[:, [0]] - pred[:, 1:]).sum(axis=1)
        lvl = self._level[idx].astype(np.float64)
        self._gain[idx] = ((self._width / np.exp2(lvl)) ** d
                           * sum_delta / (2 ** d) / self._gain0)
        self._metric_arr[idx] = pred[:, 0]

    def _process_new_cells(self, idx: np.ndarray) -> float:
        """Gain + metric + validity of newly created cells: fused epoch
        passes in chunks, then the host escalation for the bad cells.
        Returns the seconds (the span ``engine.epochs``), which
        ``epoch_stats["wall_s"]`` sums."""
        if idx.size == 0:
            return 0.0
        with trace.span("engine.epochs", self.device,
                        cells=int(idx.size)) as sp:
            if self._level[idx].max() > _F32_LEVEL_CAP:
                self._update_gain(idx)
                self._remove_invalid_cells(idx)
            else:
                grid = self._knn._grid
                chunk = self._chunk()
                st = self._epoch_stats
                retry = []
                mode = "full" if grid is None else "grid"
                for lo in range(0, idx.size, chunk):
                    part = idx[lo:lo + chunk]
                    out = self._epoch(part, mode)
                    st["n_calls_main"] += 1
                    # cells whose grid kNN could not be answered exactly
                    # are escalated, except those the geometry invalidated
                    bad = (out[:, 3] > 0.5) & ~(out[:, 2] > 0.5)
                    if bad.any():
                        retry.append(part[bad])
                    self._apply_epoch_out(part[~bad], out[~bad])
                if retry:
                    self._resolve_retries(np.concatenate(retry), chunk)
        self._epoch_stats["wall_s"] += sp.seconds
        return sp.seconds

    def _chunk(self) -> int:
        """Cells per epoch pass: ``_EPOCH_CHUNK``, doubled in 3D when the
        grid's capacity is at most 32 (half the gather bytes a query)."""
        d, grid = self._n_dimensions, self._knn._grid
        if d == 3 and grid is not None and grid["C"] <= 32:
            return 2 * _EPOCH_CHUNK[d]
        return _EPOCH_CHUNK[d]

    def _resolve_retries(self, retry_idx: np.ndarray, chunk: int) -> None:
        """Host escalation of cells still bad after their epoch (the JAX
        package's ``_resolve_retries``): the rescue turns on, a radius-4
        ring epoch answers the cells' queries, 256 cells a pass, and only
        the cells it still marks bad run through the exact full scan.
        Under a mesh (no ring) every cell goes to the sharded full scan."""
        with trace.span("engine.retry", self.device,
                        cells=int(retry_idx.size)) as sp:
            self._maybe_enable_rescue()
            st = self._epoch_stats
            st["n_bad_cells"] += int(retry_idx.size)
            if self._mesh is None:
                still = []
                for lo in range(0, retry_idx.size, _RETRY_RING_CELLS):
                    part = retry_idx[lo:lo + _RETRY_RING_CELLS]
                    out = self._epoch(part, "ring")
                    st["n_calls_ring"] += 1
                    bad = (out[:, 3] > 0.5) & ~(out[:, 2] > 0.5)
                    self._apply_epoch_out(part[~bad], out[~bad])
                    still.append(part[bad])
                retry_idx = np.concatenate(still)
            st["full_scan_cells"] += int(retry_idx.size)
            for lo in range(0, retry_idx.size, chunk):
                part = retry_idx[lo:lo + chunk]
                self._apply_epoch_out(part, self._epoch(part, "full"))
                st["n_calls_full"] += 1
        self._epoch_stats["t_retry_s"] += sp.seconds

    def _apply_epoch_out(self, part: np.ndarray, out: np.ndarray) -> None:
        if part.size == 0:
            return
        self._gain[part] = out[:, 0]
        self._metric_arr[part] = out[:, 1]
        dead = part[out[:, 2] > 0.5]
        self._alive[dead] = False
        self._gain[dead] = 0.0

    def _pre_selected(self, g) -> bool:
        """Whether geometry ``g`` takes the bbox route outside the epochs
        (the JAX package's "expensive" geometries): a pre-select type with
        ``pre_select`` on, or tables above the budget."""
        return ((self._pre_select and g.type in _PRE_SELECT_TYPES
                 or _huge(g)) and g.bounding_box() is not None)

    def _cell_flags(self, idx: np.ndarray, geometries,
                    refine_geometry: bool) -> np.ndarray:
        """OR over ``geometries`` of the cell test of cells ``idx`` (host
        bool ``[M]``), by the route of the JAX package's
        ``BatchedValidity.from_cells``: corner nodes built in f32 on the
        device, or, once a pre-select geometry takes part, nodes built in
        f64 on the host for every geometry (:meth:`_cell_flags_host`)."""
        if idx.size == 0:
            return np.zeros(0, dtype=bool)
        if any(self._pre_selected(g) for g in geometries):
            return self._cell_flags_host(idx, geometries, refine_geometry)
        coords, level = self._cells_on_device(idx)
        return self._invalid_on_device(coords, level, geometries,
                                       refine_geometry).cpu().numpy()

    def _cell_flags_host(self, idx: np.ndarray, geometries,
                         refine_geometry: bool) -> np.ndarray:
        """The cell test on f64 corner nodes built on the host.  Every
        geometry tests their f32 cast; a pre-select geometry first lets its
        bounding box settle the cells the box decides, and tests only the
        rest (the candidates): where the verdict needs every node inside
        the geometry (obstacle removal, domain surface), a cell with a node
        outside the box is settled, and where it needs one node inside
        (domain removal, obstacle surface), a cell with no node inside the
        box is; a settled cell keeps the flag of a cell outside the
        geometry."""
        lvl = self._level[idx].astype(np.float64)
        h = (self._width / np.exp2(lvl))[:, None, None]
        nodes = self._lo + (self._coords[idx][:, None, :]
                            + self._offsets[None, :, :]).astype(np.float64) * h
        nodes32 = torch.from_numpy(nodes.astype(np.float32)).to(self.device)
        flags = np.zeros(idx.size, dtype=bool)
        for g in geometries:
            if not self._pre_selected(g):
                flags |= g.check_cells(nodes32, refine_geometry).cpu().numpy()
                continue
            lower, upper = g.bounding_box()
            in_box = ((nodes >= lower) & (nodes <= upper)).all(-1)
            needs_all = refine_geometry == g.keep_inside
            candidates = in_box.all(-1) if needs_all else in_box.any(-1)
            g_flags = np.full(idx.size, g.keep_inside)
            rows = np.nonzero(candidates)[0]
            if rows.size:
                sel = torch.from_numpy(rows).to(self.device)
                g_flags[rows] = g.check_cells(nodes32[sel],
                                              refine_geometry).cpu().numpy()
            flags |= g_flags
        return flags

    def _remove_invalid_cells(self, idx: np.ndarray) -> None:
        """Mask out new cells inside obstacles / outside the domain
        (reference ``_remove_invalid_cells``, s_cube.py:669-732)."""
        if idx.size == 0:
            return
        dead = idx[self._cell_flags(idx, self._geometry, False)]
        self._alive[dead] = False
        self._gain[dead] = 0.0

    def _geo_refine_flags(self, g, idx: np.ndarray):
        """``(invalid, surface)`` flags of cells ``idx`` w.r.t. geometry
        ``g``: one set of device-built corner nodes serves both tests, as
        in the JAX package's one-call route; a bbox-routed geometry
        (:meth:`_pre_selected`: pre-select, or tables above the budget)
        takes its two-call route instead, which tests the surface of the
        valid cells only (a removed cell is never a surface cell).  The JAX
        package also takes the two-call route above level 22, where it
        gives these flags from the same device-built nodes."""
        if self._pre_selected(g):
            invalid = self._cell_flags(idx, [g], False)
            surface = np.zeros_like(invalid)
            valid = np.nonzero(~invalid)[0]
            surface[valid] = self._cell_flags(idx[valid], [g], True)
            return invalid, surface
        return self._geo_flags_device(g, idx)

    def _geo_flags_device(self, g, idx: np.ndarray):
        """``(invalid, surface)`` of cells ``idx`` w.r.t. geometry ``g`` on
        one set of device-built f32 corner nodes, whatever its route (the
        JAX package's ``_geo_refine_flags``, which the geometry loop's
        frontier recompute calls for every geometry)."""
        coords, level = self._cells_on_device(idx)
        nodes = _corner_nodes_f32(coords, level, self._lo_t, self._width_t,
                                  self._offsets_t)
        return (g.check_cells(nodes, False).cpu().numpy(),
                g.check_cells(nodes, True).cpu().numpy())

    def _captured_metric_value(self) -> float:
        """Captured fraction ||metric at alive leaf centres||₂ / ||target||₂
        (per-leaf predictions are cached at creation), in f64."""
        alive = self._alive_idx()
        return float(np.sqrt(np.square(self._metric_arr[alive]).sum())
                     / self._target_norm)

    def _captured_metric(self) -> float:
        ratio = self._captured_metric_value()
        self._metric.append(ratio)
        return ratio

    # ------------------------------------------------------------------ #
    # 2:1 balance (max_delta_level)                                      #
    # ------------------------------------------------------------------ #
    def _make_nb_lookup(self):
        """Point-in-leaf lookup over the alive leaves: their indices and
        Morton anchors on the deepest lattice, sorted by anchor, the size
        of each one's Morton range, and the 3^d − 1 neighbour directions
        (faces, edges and corners)."""
        d = self._n_dimensions
        alive = self._alive_idx()
        anchors = morton.anchor(self._coords[alive].astype(np.uint64),
                                self._level[alive], self._max_depth)
        order = np.argsort(anchors)
        leaves = alive[order]
        sizes = morton.range_size(self._level[leaves], d, self._max_depth)
        dirs = np.stack(np.meshgrid(*([np.array([-1, 0, 1])] * d),
                                    indexing="ij"), axis=-1).reshape(-1, d)
        dirs = dirs[(dirs != 0).any(axis=1)].astype(np.int64)
        return leaves, anchors[order], sizes, dirs

    def _coarser_of(self, idx: np.ndarray, lookup) -> np.ndarray:
        """Sorted unique leaves coarser than a cell of ``idx`` that cover
        one of its same-level neighbour positions (reference ``_check_nb``,
        s_cube.py:447-464).  A cell of ``idx`` may be among them."""
        leaves, anchors, sizes, dirs = lookup
        d = self._n_dimensions
        level = self._level[idx]
        nb = self._coords[idx][:, None, :] + dirs[None, :, :]
        nb_level = np.repeat(level[:, None], dirs.shape[0], axis=1)
        on_lattice = ((nb >= 0) & (nb < (1 << nb_level[..., None]))).all(-1)
        nb = nb[on_lattice]
        nb_level = nb_level[on_lattice]
        if nb.size == 0:
            return np.zeros(0, dtype=np.int64)
        code = morton.anchor(nb.astype(np.uint64), nb_level, self._max_depth)
        pos = np.clip(np.searchsorted(anchors, code, side="right") - 1, 0,
                      anchors.size - 1)
        owner = leaves[pos]
        covers = (anchors[pos] <= code) & (code - anchors[pos] < sizes[pos])
        return np.unique(owner[covers & (self._level[owner] < nb_level)])

    def _expand_delta_level(self, selected: np.ndarray,
                            lookup=None) -> np.ndarray:
        """``selected`` plus, transitively, every coarser leaf a split
        would leave two or more levels above a neighbour (reference
        ``_check_nb`` + ``_check_constraint``, s_cube.py:447-506); sorted
        ascending."""
        if lookup is None:
            lookup = self._make_nb_lookup()
        to_refine = np.unique(selected)
        frontier = to_refine
        while frontier.size:
            frontier = np.setdiff1d(self._coarser_of(frontier, lookup),
                                    to_refine)
            to_refine = np.union1d(to_refine, frontier)
        return to_refine

    # ------------------------------------------------------------------ #
    # refinement driver                                                  #
    # ------------------------------------------------------------------ #
    def _split(self, parents: np.ndarray) -> np.ndarray:
        """Split parent cells into 2^d children; returns new cell indices."""
        if parents.size == 0:
            return np.zeros(0, dtype=np.int64)
        d = self._n_dimensions
        child_coords = (self._coords[parents][:, None, :] * 2
                        + self._offsets[None, :, :]).reshape(-1, d)
        child_level = np.repeat(self._level[parents] + 1, 2 ** d)
        self._alive[parents] = False
        new_idx = self._append_cells(child_coords, child_level)
        self._current_max_level = max(self._current_max_level,
                                      int(child_level.max()))
        return new_idx

    def _refine_uniform(self) -> None:
        """Uniform background refinement (reference ``s_cube.py:508-561``):
        every sweep splits all alive leaves; early sweeps only prune
        invalid children (their gains are never read), the last one runs
        the fused epoch."""
        logger.info("Uniform refinement phase.")
        for j in range(self._min_level):
            leaves = self._alive_idx()
            logger.info(f"\tStarting iteration no. {j}, "
                        f"N_cells = {leaves.size}")
            children = self._split(leaves)
            if j < self._min_level - 1:
                self._remove_invalid_cells(children)
            else:
                self._process_new_cells(children)
            self._current_min_level += 1
        logger.info("Finished uniform refinement.")

    def _check_stopping_criteria(self) -> bool:
        """Mirror of reference ``_check_stopping_criteria``
        (s_cube.py:263-284); True means keep refining."""
        if self._n_cells_max is None:
            if (len(self._metric) > 1 and self._metric[-1] / self._min_metric
                    >= self._reach_at_least):
                return (self._metric[-1] < self._min_metric
                        and abs(self._metric[-1] - self._metric[-2])
                        > self._relTol)
        else:
            n_leaves = int(self._alive.sum())
            if n_leaves / self._n_cells_max >= self._reach_at_least:
                rel_stop = abs(self._cells_per_iter / self._n_cells_max
                               - self._cells_per_iter_last / self._n_cells_max)
                return n_leaves < self._n_cells_max and rel_stop > self._relTol
        return True

    def _compute_n_cells_per_iter(self) -> None:
        """Linear ramp of the per-iteration budget (reference
        ``s_cube.py:286-315``)."""
        if self._n_cells_max is None:
            delta_x = self._min_metric - self._metric[0]
            current_x = self._metric[-1]
        else:
            delta_x = self._n_cells_max - self._n_cells_after_uniform
            current_x = int(self._alive.sum())
        delta_y = self._cells_per_iter_start - self._cells_per_iter_end
        new = self._cells_per_iter_start - (delta_y / delta_x) * current_x
        self._cells_per_iter_last = self._cells_per_iter
        self._cells_per_iter = int(new) if new > 1 else 1

    def _select_top_k(self, k: int) -> np.ndarray:
        """Exact top-k leaves by ``(gain desc, creation index asc)`` — the
        reference's ``heapq.nlargest(..., key=(gain, -idx))`` tie-break
        (``s_cube.py:599-602``)."""
        alive = self._alive_idx()
        if k >= alive.size:
            return alive
        g = self._gain[alive]
        part = np.argpartition(-g, k - 1)[:k]
        thr = g[part].min()
        above = np.nonzero(g > thr)[0]
        need = k - above.size
        at_thr = np.nonzero(g == thr)[0][:need]  # ascending index order
        return alive[np.concatenate([above, at_thr])]

    # ------------------------------------------------------------------ #
    # device-resident adaptive loop                                      #
    # ------------------------------------------------------------------ #
    def _adaptive_device_eligible(self) -> bool:
        """The JAX package's condition (its ``_adaptive_device_eligible``):
        the dilated grid layout, no grid (the full-scan core) or a mesh
        (either sharded core), no geometry above ``_FUSED_GEO_BYTES`` (its
        validity is merged on the host after each epoch, which a window
        never sees), and the loop neither switched off nor disabled."""
        grid = self._knn._grid
        return (self.DEVICE_LOOP and not self._device_loop_disabled
                and (self._mesh is not None or grid is None
                     or "dil_pts" in grid)
                and not any(_huge(g) for g in self._geometry))

    def _device_loop_kmax(self) -> int:
        """Upper bound of the per-iteration budget over the run (the
        loop's selection width; the budget masks the rest).  The ramp is
        linear in the captured metric, so its extremes lie at the ends of
        its range; 1.05 covers an over-approximated metric.  A power of
        two at least ``_LOOP_MIN_WIDTH`` (the JAX package rounds up to 64
        to share compiled loops; every slot costs an epoch row here)."""
        start, end = self._cells_per_iter_start, self._cells_per_iter_end
        if self._n_cells_max is not None:
            return _bucket(max(int(start), 1), minimum=_LOOP_MIN_WIDTH)
        m0 = self._metric[0] if self._metric else 0.0
        delta_x = self._min_metric - m0
        vals = [float(start)]
        if abs(delta_x) > 1e-12:
            for cx in (m0, 1.05):
                vals.append(start - (start - end) / delta_x * cx)
        return _bucket(max(int(max(vals)), 1), minimum=_LOOP_MIN_WIDTH)

    def _device_adaptive_call(self):
        """One window of adaptive iterations on the device (the JAX
        package's ``_device_adaptive_call``): upload the state (on
        re-entry only the rows the host escalation corrected), run the
        iterations, read back what the host keeps, and escalate the cells
        whose kNN the loop could not prove exact.  Returns ``(iterations
        run, cause)``, the cause (of ``_FALLBACKS``) naming why a window
        ran none."""
        d = self._n_dimensions
        n_ch = 2 ** d
        mdl = self._max_delta_level
        metric_mode = self._n_cells_max is None
        k_max = self._device_loop_kmax()
        # the 2:1 closure adds coarser neighbours to the budgeted top-k:
        # twice its width (a larger closure guards to the host's walk)
        k_sel = 2 * k_max if mdl else k_max
        # cells per epoch block, the JAX package's size: the host's chunk
        # doubled, or kept in 3D at a grid capacity above 32; a budget of
        # more than two blocks an iteration stays on the host for good
        grid = self._knn._grid
        block = 2 * _EPOCH_CHUNK[d]
        if d == 3 and grid is not None and grid["C"] > 32:
            block = _EPOCH_CHUNK[d]
        if k_sel * n_ch > 2 * block:
            logger.info(f"Device adaptive loop disabled: a budget of {k_sel} "
                        f"cells an iteration exceeds two epoch blocks.")
            self._device_loop_disabled = True
            return 0, "disabled"
        # a selection at the f32 level cap would guard at once
        if self._current_max_level + 1 > _F32_LEVEL_CAP:
            sel = self._select_top_k(min(self._cells_per_iter,
                                         self._n_cells))
            if (sel.size and int(self._level[sel].max()) + 1
                    > _F32_LEVEL_CAP):
                return 0, "level_cap"
        iters, cap = self._window_shape(k_sel * n_ch)
        n0 = self._n_cells
        s = self._window_state(cap, iters)
        plan, rescue = self._loop_ring()
        key = self._window_key(cap, k_max, k_sel, iters, block, plan, rescue)

        def params():
            vals = torch.tensor(
                [self._min_metric or 0.0, self._relTol, self._reach_at_least,
                 self._n_cells_max or 0, self._cells_per_iter_start,
                 self._cells_per_iter_end, self._target_norm],
                dtype=torch.float32).to(self.device)
            return loop_params(
                cap, k_max, k_sel, iters, d, metric_mode, mdl,
                _F32_LEVEL_CAP, self._MDL_ROUNDS, self._offsets_i,
                self._nbdirs_i, dict(zip(
                    ("min_metric", "relTol", "reach", "ncmax", "cps_start",
                     "cps_end", "tnorm"), vals)))
        p = self._buffer(("params",) + key, params)
        reader = _Reader(self.device)
        ran, fill, why = self._run_window(
            s, p, self._loop_epoch(block, plan, rescue), reader,
            self._graph_step(key, self._epoch_stats["graphs"]))
        retry = self._window_readback(s, n0, fill, ran, reader)

        st = self._epoch_stats
        st["windows"] += 1
        st["window_iters"] += ran
        st["n_calls_main"] += 1
        st["queries"] += (fill - n0) * (1 + n_ch)
        st["d2h_syncs"] += reader.reads
        exits = [name for bit, name in _WHY_EXIT.items() if why & bit]
        for name in exits or ["window_full" if ran == iters else "stop"]:
            st["window_exits"][name] += 1
        # between windows the host changes only the escalated rows; any
        # other change (a host iteration, the geometry phase) changes the
        # cell count and so discards this state
        self._dev_state = {"cap": cap, "fill": fill, "dirty": retry}
        if retry.size:
            self._resolve_retries(retry, self._chunk())
            if metric_mode:
                # the window's last captured metric saw the cells' ring
                # answers; the host's sees their exact ones
                self._metric[-1] = self._captured_metric_value()
        if ran:
            return ran, None
        return 0, ("level_cap" if why & WHY_LEVEL else
                   "guard" if why else "stop_test")

    def _window_shape(self, width: int):
        """``(iterations, state rows)`` of a window whose iterations split
        ``width`` cells at most (the JAX package's sizes: they choose
        a route, never a cell).  With ``n_cells_max`` the iterations left
        are predictable; in metric mode the state holds the expected
        growth and the fill guard ends a window that outgrows it."""
        n0 = self._n_cells
        iters = self._DEVICE_LOOP_ITERS
        if self._n_cells_max is not None:
            # each iteration adds at most cells_per_iter·(2^d − 1) leaves
            est = -(-max(self._n_cells_max - n0, 1) // max(
                self._cells_per_iter * (2 ** self._n_dimensions - 1), 1))
            iters = min(iters, max(8, 1 << int(est + 1).bit_length()))
            growth = iters * width
        elif width <= 512:
            iters *= 4
            growth = iters * width
        else:
            floor = (8 if self._max_delta_level else 16) * width
            growth = min(iters * width, max(8 * n0, floor))
        need = n0 + growth + 1
        cap = max(4096, 1 << (need - 1).bit_length())
        cache = self._dev_state
        if cache is not None and cache["fill"] == n0 and cache["cap"] >= need:
            # a re-entry's scatter is cheaper than a smaller upload
            cap = cache["cap"]
        return iters, cap

    def _buffer(self, key: tuple, make):
        """The run's fixed tensors under ``key``, made by ``make()`` at
        first use: a window graph reads and writes the addresses its
        capture saw, so every window of a key gets the same tensors."""
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = make()
        return buf

    def _graph_step(self, key, stats: dict):
        """One window iteration of ``key`` through the run's graph cache
        (:meth:`graphs.WindowGraphs.step`); eager on a mesh."""
        if self._graphs is None:
            self._graphs = graphs.WindowGraphs(self.device, self._LOOP_GRAPHS)
        return partial(self._graphs.step, key, stats=stats,
                       eager="mesh" if self._mesh is not None else None)

    def _window_key(self, cap: int, k_max: int, k_sel: int, iters: int,
                    block: int, plan: tuple, rescue: int) -> tuple:
        """Everything the capture of an adaptive window's iteration bakes
        in (the JAX package's ``cached_jit`` key of its loop): the shapes,
        the epoch's core, block, ring plan and rescue rows, the stopping
        mode, the 2:1 closure and the geometries the epoch tests."""
        return ("adaptive", self._n_dimensions, cap, k_max, k_sel, iters,
                block, self._epoch_stats["core"], self._n_cells_max is None,
                self._max_delta_level, self._MDL_ROUNDS, plan, rescue,
                tuple(id(g) for g in self._geometry if not _huge(g)))

    def _window_state(self, cap: int, iters: int) -> dict:
        """The loop state on the device, in the run's fixed tensors of
        ``cap`` rows and ``iters`` series entries: the cell rows (uploaded
        in one packed copy, or on re-entry the previous window's, with the
        rows the host escalation corrected scattered in), then the
        window's series and scalars."""
        dev, d, n0 = self.device, self._n_dimensions, self._n_cells
        st = self._epoch_stats
        arrays = self._buffer(("cells", cap), lambda: {
            "coords": torch.zeros((cap + 1, d), dtype=torch.int64,
                                  device=dev),
            "level": torch.zeros(cap + 1, dtype=torch.int64, device=dev),
            "gain": torch.zeros(cap + 1, dtype=torch.float32, device=dev),
            "metric": torch.zeros(cap + 1, dtype=torch.float32, device=dev),
            "alive": torch.zeros(cap + 1, dtype=torch.bool, device=dev),
            "bad": torch.zeros(cap + 1, dtype=torch.bool, device=dev)})
        cache = self._dev_state
        if cache is not None and cache["cap"] == cap and cache["fill"] == n0:
            dirty = cache["dirty"]
            if dirty.size:
                rows = torch.from_numpy(dirty).to(dev)
                gm = torch.from_numpy(np.stack(
                    [self._gain[dirty], self._metric_arr[dirty]]).astype(
                        np.float32)).to(dev)
                arrays["gain"][rows] = gm[0]
                arrays["metric"][rows] = gm[1]
                arrays["alive"][rows] = torch.from_numpy(
                    self._alive[dirty]).to(dev)
                st["rows_reuploaded"] += int(dirty.size)
        else:
            buf = np.zeros((n0, d + 4), dtype=np.int32)
            buf[:, :d] = self._coords[:n0]
            buf[:, d] = self._level[:n0]
            buf[:, d + 1] = self._gain[:n0].astype(np.float32).view(np.int32)
            buf[:, d + 2] = self._metric_arr[:n0].astype(
                np.float32).view(np.int32)
            buf[:, d + 3] = self._alive[:n0]
            t = torch.from_numpy(buf).to(dev)
            for a in arrays.values():
                a.zero_()
            arrays["coords"][:n0] = t[:, :d]
            arrays["level"][:n0] = t[:, d]
            arrays["gain"][:n0] = t[:, d + 1].contiguous().view(torch.float32)
            arrays["metric"][:n0] = t[:, d + 2].contiguous().view(
                torch.float32)
            arrays["alive"][:n0] = t[:, d + 3] != 0
            st["state_uploads"] += 1
        arrays["bad"].zero_()
        series = self._buffer(("series", iters), lambda: {
            "ms": torch.zeros(iters + 1, dtype=torch.float32, device=dev),
            "ns": torch.zeros(iters + 1, dtype=torch.int64, device=dev),
            "nbq": torch.zeros((iters + 1, 4), dtype=torch.int64,
                               device=dev)})
        for a in series.values():
            a.zero_()
        scalars = self._buffer(("scalars",), lambda: {
            "ints": torch.zeros(7, dtype=torch.int64, device=dev),
            "floats": torch.zeros(4, dtype=torch.float32, device=dev),
            "flag": torch.zeros((), dtype=torch.bool, device=dev)})
        m = self._metric
        scalars["ints"].copy_(torch.tensor(
            [n0, 0, int(self._alive[:n0].sum()), self._cells_per_iter,
             len(m), 0, self._current_max_level]))
        scalars["floats"].copy_(torch.tensor(
            [self._cells_per_iter_last, m[0] if m else 0.0,
             m[-2] if len(m) > 1 else np.inf, m[-1] if m else 0.0],
            dtype=torch.float32))
        scalars["flag"].zero_()
        s = {**arrays, **series, "flag": scalars["flag"]}
        s.update(zip(("fill", "it", "n_alive", "cpi", "m_count", "why",
                      "maxlev"), scalars["ints"]))
        s.update(zip(("cpi_last", "m_first", "m_prev", "m_last"),
                     scalars["floats"]))
        return s

    def _loop_ring(self) -> tuple:
        """``(ring pass sizes, rescue rows)`` of a window's epochs, sized
        from the previous window (no ring without a grid); no rescue in
        mode "0", and one from the first window in mode "1"."""
        if self._knn._grid is None:
            return (), 0
        rescue = 0 if self.FULL_RESCUE == "0" else self._loop_rescue_rows
        if self.FULL_RESCUE == "1" and self._mesh is None:
            rescue = max(rescue, _LOOP_RESCUE_MIN)
        return tuple(_ring_plan(self._loop_ring_rows)), rescue

    def _loop_epoch(self, block: int, plan: tuple, rescue: int):
        """The epoch of a window's iterations: :meth:`_epoch_core` over
        blocks of ``block`` cells with the ring passes ``plan`` and
        ``rescue`` rescue rows (nothing read back); returns the packed
        output and ``[bad queries before the ring, ring rows left
        unproven]``."""
        mode = "full" if self._knn._grid is None else "grid"

        def epoch(coords, level, slot):
            outs, counts = [], 0
            for lo in range(0, coords.shape[0], block):
                sl = slice(lo, lo + block)
                out, c = self._epoch_core(coords[sl], level[sl], mode,
                                          slot=slot[sl], ring_plan=plan,
                                          rescue_rows=rescue)
                outs.append(out)
                counts = counts + c
            return torch.cat(outs), counts
        return epoch

    @staticmethod
    def _run_window(s: dict, p, epoch, reader, step):
        """Enqueue the window's iterations one ahead of the host's
        knowledge (:func:`_enqueue_ahead`), each through ``step`` (the
        graph cache's, :meth:`_graph_step`) on ``[may run, it, fill, why]``
        rows.  Returns ``(it, fill, why)``."""
        return tuple(_enqueue_ahead(
            lambda: step(lambda: loop_body(s, p, epoch),
                         lambda: torch.stack([may_run(s, p).long(), s["it"],
                                              s["fill"], s["why"]])),
            p.iters, reader)[1:])

    def _window_readback(self, s: dict, n0: int, fill: int, ran: int,
                         reader) -> np.ndarray:
        """One packed read of what the host keeps after a window: the
        alive and bad flags, the new rows (coords, levels, gains,
        metrics), the per-iteration series and the running scalars.
        Updates the host state; returns the bad rows."""
        d, i32 = self._n_dimensions, torch.int32
        m = fill - n0
        parts = [s["alive"][:fill], s["bad"][:fill],
                 s["coords"][n0:fill].reshape(-1), s["level"][n0:fill],
                 s["gain"][n0:fill].view(i32), s["metric"][n0:fill].view(i32),
                 s["ms"][:ran].view(i32), s["ns"][:ran],
                 s["nbq"][:ran].reshape(-1),
                 torch.stack([s["maxlev"], s["cpi"]]),
                 s["cpi_last"].reshape(1).view(i32)]
        buf = torch.cat([x.to(i32) for x in parts]).cpu().numpy()
        reader.reads += 1
        sizes = [fill, fill, m * d, m, m, m, ran, ran, 4 * ran, 2]
        (alive, bad, coords, level, gain, metric, ms, ns, nbq, head,
         cpi_last) = np.split(buf, np.cumsum(sizes))
        self._grow(m)
        self._coords[n0:fill] = coords.reshape(m, d)
        self._level[n0:fill] = level
        self._gain[n0:fill] = gain.view(np.float32)
        self._metric_arr[n0:fill] = metric.view(np.float32)
        self._alive[:fill] = alive != 0
        self._n_cells = fill
        self._current_max_level = int(head[0])
        self._cells_per_iter = int(head[1])
        self._cells_per_iter_last = float(cpi_last.view(np.float32)[0])
        if self._n_cells_max is None:
            self._metric.extend(ms.view(np.float32).astype(float).tolist())
        self._n_cells_log.extend(ns.tolist())
        if ran:
            nbq = nbq.reshape(ran, 4)
            self._epoch_stats["ring_queries"] += int(nbq[:, 1].sum())
            self._epoch_stats["rescued_queries"] += int(nbq[:, 3].sum())
            # the next window's ring tries as many rows as this window's
            # epochs had bad queries, its rescue as many as the ring left
            most = nbq.max(axis=0)
            self._loop_ring_rows = _loop_rows(int(most[0]), _RING_PLAN[0][0],
                                              _LOOP_RING_ROWS)
            self._loop_rescue_rows = _loop_rows(int(most[2]),
                                                _LOOP_RESCUE_MIN,
                                                _RESCUE_ROWS)
        return np.nonzero(bad)[0]

    def refine(self) -> None:
        """Run the full grid generation (reference ``refine``,
        s_cube.py:563-667)."""
        logger.info("Generating the S^3 grid.")
        try:
            self._refine()
        finally:
            # the windows' graphs, their pool and fixed tensors are the run's
            self._graphs = None
            self._bufs = {}

    def _refine(self) -> None:
        with trace.span("engine.uniform", self.device) as sp:
            self._refine_uniform()
            sp.count(cells=int(self._alive.sum()))
        self._times["t_uniform"] = sp.seconds

        iteration_count = 0
        self._n_cells_after_uniform = int(self._alive.sum())
        if self._n_cells_max is None:
            self._captured_metric()
        self._n_cells_log.append(int(self._alive.sum()))

        logger.info("Adaptive (metric-driven) refinement phase.")
        # host iterations: select, 2:1 expansion, split, epochs; windows of
        # the device-resident loop: their wall and iterations
        asplit = {"t_select": 0.0, "t_expand": 0.0, "t_split": 0.0,
                  "t_epoch": 0.0, "t_window": 0.0, "n_iter": 0}
        with trace.span("engine.adaptive", self.device) as adaptive:
            while self._check_stopping_criteria():
                if self._adaptive_device_eligible():
                    with trace.span("engine.window", self.device) as sp:
                        ran, cause = self._device_adaptive_call()
                        sp.count(iterations=ran)
                    asplit["t_window"] += sp.seconds
                    self._epoch_stats["wall_s"] += sp.seconds
                    if ran:
                        iteration_count += ran
                        asplit["n_iter"] += ran
                        logger.info(f"\tDevice loop ran {ran} iterations "
                                    f"-> N_cells = {int(self._alive.sum())}")
                        continue
                    # the window could not start an iteration: one on the
                    # host
                    self._epoch_stats["host_fallback"][cause] += 1
                elif self.DEVICE_LOOP and self._device_loop_disabled:
                    self._epoch_stats["host_fallback"]["disabled"] += 1
                with trace.span("engine.iteration", self.device):
                    if self._n_cells_max is None:
                        logger.info(f"\tStarting iteration no. "
                                    f"{iteration_count}, captured metric: "
                                    f"{round(self._metric[-1] * 100, 2)} %, "
                                    f"N_cells = {int(self._alive.sum())}")
                    else:
                        logger.info(f"\tStarting iteration no. "
                                    f"{iteration_count}, "
                                    f"N_cells = {int(self._alive.sum())}")
                    if len(self._metric) >= 2:
                        self._compute_n_cells_per_iter()
                    with trace.span("engine.select") as sp:
                        selected = self._select_top_k(
                            min(self._cells_per_iter, self._n_cells))
                    asplit["t_select"] += sp.seconds
                    if self._max_delta_level:
                        with trace.span("engine.expand") as sp:
                            selected = self._expand_delta_level(selected)
                        asplit["t_expand"] += sp.seconds
                    with trace.span("engine.split",
                                    cells=int(selected.size)) as sp:
                        children = self._split(selected)
                    asplit["t_split"] += sp.seconds
                    asplit["t_epoch"] += self._process_new_cells(children)
                    asplit["n_iter"] += 1
                    if self._n_cells_max is None:
                        self._captured_metric()
                iteration_count += 1
                self._n_cells_log.append(int(self._alive.sum()))

            if self._n_cells_max is not None:
                self._captured_metric()
            adaptive.count(cells=int(self._alive.sum()),
                           iterations=iteration_count)
        self._dev_state = None
        self._times["adaptive_split"] = asplit
        self._times["t_adaptive"] = adaptive.seconds
        logger.info("Finished metric-based refinement.")

        self._refine_geometries()
        self._update_min_ref_level()
        self._resort_nodes_and_indices_of_grid()
        self._create_mesh_info(iteration_count)
        logger.info(self)
        if self._n_cells_max is not None and self._metric[-1] > 1:
            logger.info(
                "Detected a captured metric > 100%. This means that the "
                "current number of 'n_cells_max' can be reduced without "
                "further loss of information for this metric field, since "
                "the metric field is over-approximated.")

    # ------------------------------------------------------------------ #
    # geometry refinement                                                #
    # ------------------------------------------------------------------ #
    def _refine_geometries(self) -> None:
        geometries = [g for g in self._geometry if g.refine]
        if geometries:
            with trace.span("engine.geometry", self.device) as sp:
                self._execute_geometry_refinement(geometries)
                sp.count(cells=int(self._alive.sum()))
            self._times["t_geometry"] = sp.seconds

    def _execute_geometry_refinement(self, geometries: list) -> None:
        """Refine near geometry surfaces level by level up to the target
        level (reference ``_execute_geometry_refinement``,
        s_cube.py:774-863), on the JAX package's routes: windows of the
        device-resident geometry loop (:meth:`_device_geometry_call`)
        where its ``dev_ok`` holds and the level is at most 22, else the
        host's per-level walk; a level a window could not run (a guard, a
        surface wider than the window) runs on the host.  Children get no
        gain/metric: the adaptive loop is over and nothing reads them
        again."""
        logger.info("Geometry-surface refinement phase.")
        route = self._epoch_stats["geometry_route"]
        split = self._times["geometry_split"]
        for g in geometries:
            logger.info(f"Starting refining geometry {g.name}.")
            alive = self._alive_idx()
            surface = alive[self._cell_flags(alive, [g], True)]
            if surface.size == 0:
                logger.warning("Could not find any cells to refine. "
                               "Skipping geometry refinement.")
                continue
            gmin = int(self._level[surface].min())
            gmax = (int(self._level[surface].max())
                    if g.min_refinement_level is None
                    else g.min_refinement_level)
            logger.info(f"Found a minimum cell level of {gmin}. Target "
                        f"level is {gmax}.")
            # the JAX package's dev_ok: the 2:1 variant only on request
            # (its measured warm trade-off), never above the table budget
            loop_ok = (self.DEVICE_LOOP and not _huge(g)
                       and (not self._max_delta_level or self.GEO_MDL_LOOP))
            while gmax > gmin and surface.size:
                cause = "route"
                if loop_ok and gmin + 1 <= _F32_LEVEL_CAP:
                    with trace.span("engine.geometry_window",
                                    self.device) as sp:
                        entry = int(surface.size)
                        surface, gmin2, cause = self._device_geometry_call(
                            g, surface, gmin, gmax)
                        sp.count(surface=entry, levels=gmin2 - gmin,
                                 k_geo=self._geo_loop_shapes[id(g)][0])
                    split["t_window"] += sp.seconds
                    if gmin2 > gmin:
                        logger.info(f"\tDevice loop refined levels "
                                    f"{gmin + 1}..{gmin2} / {gmax}.")
                        gmin = gmin2
                        continue
                elif loop_ok:
                    cause = "level_cap"
                with trace.span("engine.geometry_level",
                                self.device) as sp:
                    logger.info(f"\tRefining level {gmin + 1} / {gmax}.")
                    to_refine = surface[self._level[surface] < gmax]
                    if self._max_delta_level:
                        # the 2:1 check covers every surface cell, those
                        # already at the target level too, and refines a
                        # coarser neighbour it finds even when that
                        # neighbour is itself a surface cell at the target
                        # level (reference s_cube.py:826-848)
                        lookup = self._make_nb_lookup()
                        direct = self._coarser_of(surface, lookup)
                        if direct.size:
                            to_refine = np.union1d(
                                to_refine,
                                self._expand_delta_level(direct, lookup))
                    if to_refine.size == 0:
                        break
                    route["host_levels"] += 1
                    route["host_fallback"][cause] += 1
                    children = self._split(to_refine)
                    # children invalid w.r.t. THIS geometry only are
                    # removed (reference s_cube.py:850); the surviving
                    # children near the surface are the next level's
                    # surface set
                    invalid, surf = self._geo_refine_flags(g, children)
                    surface = children[~invalid & surf]
                    dead = children[invalid]
                    sp.count(cells=int(to_refine.size),
                             children=int(children.size),
                             removed=int(dead.size), **{cause: 1})
                    self._alive[dead] = False
                    self._gain[dead] = 0.0
                    gmin += 1
                split["t_host"] += sp.seconds
        self._current_max_level = int(self._level[self._alive_idx()].max())
        logger.info("Finished geometry refinement.")

    def _geometry_loop_shape(self, g, surface: np.ndarray, gmin: int,
                             gmax: int) -> tuple:
        """``(k_geo, cap)`` of geometry ``g``'s windows, chosen at its
        first window and kept for the phase (the JAX package's sizes): the
        frontier of a (d-1)-dimensional surface grows about 2^(d-1)-fold a
        level, so ``k_geo`` holds the last level's, within two epoch
        blocks of children; ``cap`` holds a full window's children."""
        shape = self._geo_loop_shapes.get(id(g))
        if shape is None:
            d = self._n_dimensions
            n_ch = 2 ** d
            levels_left = max(gmax - gmin, 1)
            est = 2 * max(int(surface.size), 64) * (
                1 << ((d - 1) * min(levels_left - 1, 7)))
            k_geo = _bucket(est, minimum=256)
            while k_geo * n_ch > 2 * _EPOCH_CHUNK[d] and k_geo > 256:
                k_geo //= 2
            need = self._n_cells + self._GEO_LOOP_LEVELS * k_geo * n_ch + 1
            shape = (k_geo, max(4096, 1 << (need - 1).bit_length()))
            self._geo_loop_shapes[id(g)] = shape
        return shape

    def _device_geometry_call(self, g, surface: np.ndarray, gmin: int,
                              gmax: int) -> tuple:
        """One window of up to ``_GEO_LOOP_LEVELS`` geometry-refinement
        levels on the device (the JAX package's ``_device_geometry_call``):
        upload the cell rows and the frontier in one copy, run the levels,
        read back the alive flags, the next frontier and each level's
        parents once, and replay the split on the host.  Returns
        ``(surface, gmin, cause)``: the next surface and level, advanced
        past the levels run, and (of ``_GEO_FALLBACKS``) why a window ran
        none."""
        d, dev = self._n_dimensions, self.device
        n_ch, levels = 2 ** d, self._GEO_LOOP_LEVELS
        k_geo, cap = self._geometry_loop_shape(g, surface, gmin, gmax)
        n0 = self._n_cells
        if surface.size > k_geo or n0 + levels * k_geo * n_ch + 1 > cap:
            return surface, gmin, "overflow"
        frontier = np.full(k_geo, cap, dtype=np.int64)
        frontier[:surface.size] = surface
        rows = np.concatenate([self._coords[:n0], self._level[:n0, None],
                               self._alive[:n0, None]], axis=1)
        # n_fr, gcur, it, fill, maxlev, why; the frontier; the cell rows,
        # copied into the run's fixed tensors of this window shape
        buf = torch.from_numpy(np.concatenate([
            [surface.size, gmin, 0, n0, self._current_max_level, 0],
            frontier, rows.reshape(-1)]).astype(np.int64)).to(dev)
        rows = buf[6 + k_geo:].reshape(n0, d + 2)
        key = self._geometry_key(g, cap, k_geo, gmax)
        s = dict(self._buffer(("geometry", cap, k_geo, levels), lambda: {
            "coords": torch.zeros((cap + 1, d), dtype=torch.int64,
                                  device=dev),
            "level": torch.zeros(cap + 1, dtype=torch.int64, device=dev),
            "alive": torch.zeros(cap + 1, dtype=torch.bool, device=dev),
            "fr": torch.zeros(k_geo, dtype=torch.int64, device=dev),
            "flag": torch.zeros((), dtype=torch.bool, device=dev),
            "fr_ok": torch.zeros((), dtype=torch.bool, device=dev),
            "psel": torch.zeros((levels + 1, k_geo), dtype=torch.int64,
                                device=dev),
            "ints": torch.zeros(6, dtype=torch.int64, device=dev)}))
        for name in ("coords", "level", "alive", "flag"):
            s[name].zero_()
        s["coords"][:n0] = rows[:, :d]
        s["level"][:n0] = rows[:, d]
        s["alive"][:n0] = rows[:, d + 1] != 0
        s["fr"].copy_(buf[6:6 + k_geo])
        s["fr_ok"].fill_(True)
        s["psel"].fill_(cap)
        s["ints"].copy_(buf[:6])
        s.update(zip(("n_fr", "gcur", "it", "fill", "maxlev", "why"),
                     s.pop("ints")))
        p = self._buffer(("params",) + key, lambda: geometry_params(
            cap, k_geo, levels, d, gmax, self._max_delta_level,
            _F32_LEVEL_CAP, self._MDL_ROUNDS, self._offsets_i,
            self._nbdirs_i, self._lo_t, self._width_t, self._offsets_t))
        reader = _Reader(dev)
        ran, fill, why, n_fr, fr_ok, maxlev = self._run_geometry_window(
            s, p, g.check_cells, reader,
            self._graph_step(key, self._epoch_stats["geometry_route"][
                "graphs"]))

        route = self._epoch_stats["geometry_route"]
        route["windows"] += 1
        route["window_levels"] += ran
        exits = [name for bit, name in _GEO_WHY_EXIT.items() if why & bit]
        for name in exits or ["done" if gmin + ran >= gmax or n_fr == 0
                              else "window_full"]:
            route["window_exits"][name] += 1
        if ran == 0:
            route["d2h_syncs"] += reader.reads
            return surface, gmin, exits[0]
        i32 = torch.int32
        out = torch.cat([s["alive"][:fill].to(i32), s["fr"].to(i32),
                         s["psel"][:ran].reshape(-1).to(i32)]).cpu().numpy()
        reader.reads += 1
        route["d2h_syncs"] += reader.reads
        alive, fr, psel = np.split(out, [fill, fill + k_geo])
        psel = psel.reshape(ran, k_geo)
        # the split again on the host, with the device's integer arithmetic
        self._grow(fill - n0)
        pos = n0
        for parents in psel:
            parents = parents[parents < cap]
            m = parents.size * n_ch
            self._coords[pos:pos + m] = (
                self._coords[parents][:, None, :] * 2
                + self._offsets[None, :, :]).reshape(-1, d)
            self._level[pos:pos + m] = np.repeat(self._level[parents] + 1,
                                                 n_ch)
            pos += m
        if pos != fill:
            raise RuntimeError(f"geometry window replayed {pos} rows of "
                               f"{fill}")
        self._alive[:fill] = alive != 0
        self._n_cells = fill
        self._current_max_level = maxlev
        gmin += ran
        if fr_ok:
            return fr[fr < cap].astype(np.int64), gmin, None
        if gmin >= gmax:
            return np.zeros(0, dtype=np.int64), gmin, None
        # the last level's surface children outgrew k_geo: their surface
        # flags again from device-built nodes (the JAX package's one call)
        m = int((psel[-1] < cap).sum()) * n_ch
        children = np.arange(fill - m, fill, dtype=np.int64)
        children = children[self._alive[children]]
        return (children[self._geo_flags_device(g, children)[1]], gmin,
                None)

    def _geometry_key(self, g, cap: int, k_geo: int, gmax: int) -> tuple:
        """Everything the capture of a geometry window's level bakes in:
        the shapes, the target level, the 2:1 closure and the geometry."""
        return ("geometry", self._n_dimensions, cap, k_geo,
                self._GEO_LOOP_LEVELS, gmax, self._max_delta_level,
                self._MDL_ROUNDS, id(g))

    @staticmethod
    def _run_geometry_window(s: dict, p, check_cells, reader, step) -> list:
        """Enqueue the window's levels one ahead of the host's knowledge
        (:func:`_enqueue_ahead`), each through ``step`` (the graph
        cache's) on ``[may run, it, fill, why, n_fr, fr_ok, maxlev]``
        rows.  Returns the last row without its first entry."""
        return _enqueue_ahead(
            lambda: step(lambda: geometry_level_body(s, p, check_cells),
                         lambda: torch.stack([
                             geometry_may_run(s, p).long(), s["it"],
                             s["fill"], s["why"], s["n_fr"],
                             s["fr_ok"].long(), s["maxlev"]])),
            p.levels, reader)[1:]

    # ------------------------------------------------------------------ #
    # final assembly                                                     #
    # ------------------------------------------------------------------ #
    def _update_min_ref_level(self) -> None:
        alive = self._alive_idx()
        self._current_min_level = max(self._current_min_level,
                                      int(self._level[alive].min()))

    def _resort_nodes_and_indices_of_grid(self) -> None:
        """Emit the final grid: node identity is topological (corner keys
        on the depth-D node lattice), so one ``np.unique`` deduplicates the
        nodes and numbers the faces."""
        logger.info("Assembling the final mesh (node dedup + renumbering).")
        with trace.span("engine.renumber") as total:
            with trace.span("renumber.pre") as pre:
                alive = self._alive_idx()
                coords = self._coords[alive]
                level = self._level[alive]
                depth = int(level.max())
                if depth > self._max_depth:
                    raise ValueError(f"Refinement depth {depth} exceeds the "
                                     f"lattice limit {self._max_depth}.")
            with trace.span("renumber.keys") as keys_sp:
                keys = morton.node_keys(coords, level, self._offsets, depth)
            with trace.span("renumber.unique") as unique:
                unique_keys, inverse = np.unique(keys.ravel(),
                                                 return_inverse=True)
            with trace.span("renumber.emit", cells=int(alive.size)) as emit:
                idx_dtype = (np.int32
                             if unique_keys.size < np.iinfo(np.int32).max
                             else np.int64)
                self.face_ids = inverse.reshape(keys.shape).astype(idx_dtype)
                node_coords = morton.decode_node_keys(
                    unique_keys, self._n_dimensions, depth)
                h = self._width / float(1 << depth)
                self.all_nodes = self._lo + node_coords.astype(np.float64) * h
                self.all_centers = self._centers_of(coords, level)
                self.all_levels = level.astype(np.int64)[:, None]
        self._times["t_renumbering"] = total.seconds
        # seconds of the renumbering's parts (the JAX package's keys): pre
        # = the alive cells, keys = the corner keys, unique = the node
        # dedup sort, emit = face ids and the f64 nodes and centres
        self._times["renumber_split"] = {
            "t_keys": round(keys_sp.seconds, 4),
            "t_unique": round(unique.seconds, 4),
            "t_emit": round(emit.seconds, 4),
            "t_pre": round(pre.seconds, 4)}

    def _create_mesh_info(self, counter: int) -> None:
        """Mesh statistics + phase timings (reference ``_create_mesh_info``,
        s_cube.py:1557-1584)."""
        t = self._times
        info = self.data_final_mesh
        info["size_initial_cell"] = self._width
        info["n_cells_orig"] = self._n_cells_orig
        info["n_cells"] = int(self._alive.sum())
        info["iterations"] = counter
        info["min_level"] = self._current_min_level
        info["max_level"] = self._current_max_level
        info["metric_per_iter"] = self._metric
        info["cells_per_iter"] = self._n_cells_log
        # the phases' seconds, each its span's; the refinement's the sum
        for key in ("t_init", "t_knn_build", "t_uniform", "t_adaptive",
                    "t_geometry", "t_renumbering"):
            info[key] = t[key]
        info["t_total"] = (t["t_uniform"] + t["t_adaptive"]
                           + (t["t_geometry"] or 0.0) + t["t_renumbering"])
        info["epoch_stats"] = dict(self._epoch_stats)
        info["renumber_split"] = t["renumber_split"]
        info["adaptive_split"] = t["adaptive_split"]
        info["geometry_split"] = dict(t["geometry_split"])

    # ------------------------------------------------------------------ #
    # introspection                                                      #
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        """The cells created so far, parents and removed cells included
        (the JAX package's ``_n_cells``)."""
        return self._n_cells

    def __str__(self) -> str:
        info = self.data_final_mesh
        message = [f"Finished refinement in {info['t_total']:2.4f} s ",
                   f"({info['iterations']} iterations).",
                   f"Time for uniform refinement: {info['t_uniform']:2.4f} s",
                   f"Time for metric-based refinement: "
                   f"{info['t_adaptive']:2.4f} s"]
        if info["t_geometry"] is not None:
            message += [f"Time for geometry refinement: "
                        f"{info['t_geometry']:2.4f} s"]
        message += [f"Time for renumbering the final mesh: "
                    f"{info['t_renumbering']:2.4f} s"]
        message += ["""
                            Number of cells: {:d}
                            Minimum ref. level: {:d}
                            Maximum ref. level: {:d}
                            Captured metric of original grid: {:.2f} %
            """.format(int(self._alive.sum()), self._current_min_level,
                       self._current_max_level, self._metric[-1] * 100)]
        return "\n\t\t\t\t".join(message)

    @property
    def n_dimensions(self) -> int:
        return self._n_dimensions

    @property
    def width(self) -> float:
        return self._width

    @property
    def geometry(self) -> list:
        return self._geometry

    def _print_settings(self) -> None:
        if self._n_cells_max is not None:
            logger.info("Selecting max. number of cells as stopping "
                        "criterion.")
        else:
            logger.info("Selecting min. approximation of the metric as "
                        "stopping criterion.")
        settings = {
            "min_metric": (self._min_metric if self._n_cells_max is None
                           else None),
            "n_cells_max": self._n_cells_max,
            "uniform_level": self._min_level,
            "cells_per_iter_start": self._cells_per_iter_start,
            "cells_per_iter_end": self._cells_per_iter_end,
            "relTol": self._relTol,
            "reach_at_least": self._reach_at_least,
            "n_neighbors": self._n_neighbors,
            "device": str(self.device),
            "geometry": [g.name for g in self._geometry],
        }
        atts = ["\n\tSelected settings:"]
        width = max(len(k) for k in settings)
        atts += [f"\t\t{k:<{width}}:\t{v}" for k, v in settings.items()]
        logger.info("\n".join(atts))
