"""Metric-driven quadtree/octree refinement engine on torch.

Port of the JAX package's ``engine/tree.py`` with its per-iteration host
loop (the path ``S3_TPU_DEVICE_LOOP=0`` selects there).  Cells live in
flat host arrays keyed by (level, integer lattice coordinates); creation
index is the tie-break of every selection.  The host drives the epochs —
the stopping rule is sequential — and each epoch's numerics run on the
device in one fused function (:meth:`SamplingTree._epoch`): query centres
of every new cell and its 2^d prospective children, exact kNN (the grid
through the ``topk_smallest`` kernel, or the full scan on small clouds),
IDW prediction, the gain formula and geometry validity, returned as one
``[M, 4]`` f32 array (gain, metric, invalid, bad).

A grid query that is not provably exact is answered again inside the
epoch, as in the JAX package's ``fn_grid_dil``: over the blocked radius-4
neighbourhood (the ring), then, once a cell has had to be escalated, by
the full scan for up to 1,024 leftover rows (the rescue).  Cells still
``bad`` after that go to the host escalation: a radius-4 ring epoch over
their cells, then the full scan.  Every route emits the canonical
``(sq, idx)`` order with plain f32 distances, so which one answers a query
never changes a cell.  Gains and metrics are computed in f32 on the device
and kept in f64 on the host, where the top-k selection runs (gain
descending, creation index ascending).  Levels above 22 (beyond exact f32
lattice centres) take the f64 host path.

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
edge or a corner, transitively (:meth:`SamplingTree._expand_delta_level`).
"""
import logging
from functools import reduce
from operator import or_
from time import time
from typing import Union

import numpy as np
import torch

from .._device import resolve_device
from ..ops import morton
from ..ops.knn import (KNNIndex, _blocked_topk, _dilated_topk, _fma, _idw,
                       _rowsum, _search, _weighted_sum)

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
# rows the in-epoch full-scan rescue answers at most per epoch pass
_RESCUE_ROWS = 1024
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


def _cell_size(width, level):
    """f32 cell edge ``width / 2^level``, exact: ``2^level`` is assembled
    from its exponent bits (XLA's CPU ``exp2`` is off by ulps from level 13
    on, and the division by a power of two rounds nothing)."""
    pow2 = ((level.to(torch.int32) + 127) << 23).view(torch.float32)
    return width / pow2


def _huge(g) -> bool:
    """Whether geometry ``g``'s lookup tables exceed ``_FUSED_GEO_BYTES``."""
    return g.device_table_bytes > _FUSED_GEO_BYTES


def _corner_nodes_f32(coords, level, lo, width, offsets):
    """f32 corner nodes ``[M, 2^d, d]`` of lattice cells, ``lo + (coords +
    offset)·h`` with one rounding (exact lattice while the coordinates stay
    below 2^23)."""
    h = _cell_size(width, level)
    return _fma(coords[:, None, :] + offsets[None, :, :], h[:, None, None],
                lo)


class SamplingTree:
    """Generate a metric-based adaptive grid from a CFD point cloud.

    Constructor mirrors the JAX package's ``SamplingTree`` (reference
    ``s_cube.py:87-90``) without its process-pool switch; ``device=None``
    means the card."""

    def __init__(self, vertices, target, geometry_obj: list,
                 n_cells: int = None, uniform_level: int = 5,
                 min_metric: float = 0.75, max_delta_level: bool = False,
                 n_cells_iter_start: int = None, n_cells_iter_end: int = None,
                 relTol: Union[int, float] = 1e-3,
                 reach_at_least: float = 0.75, pre_select: bool = False,
                 device=None):
        t_init0 = time()
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
        t_knn0 = time()
        self._knn = KNNIndex(vertices, values=target, device=self.device)
        t_knn = time() - t_knn0

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
        self._times = {"t_start_uniform": 0.0, "t_end_uniform": 0.0,
                       "t_start_adaptive": 0.0, "t_start_geometry": 0.0,
                       "t_end_geometry": 0.0, "t_start_renumber": 0.0,
                       "t_end_renumber": 0.0, "t_init": 0.0,
                       "t_knn_build": 0.0}
        # epoch accounting: query count; main, host-ring and full-scan
        # passes; cells that left their epoch still bad, and those of them
        # the host ring left to the full scan; queries the in-epoch ring
        # and the in-epoch full-scan rescue answered; wall seconds of all
        # epochs and of the host escalation
        self._epoch_stats = {"queries": 0, "n_calls_main": 0,
                             "n_calls_ring": 0, "n_calls_full": 0,
                             "n_bad_cells": 0, "full_scan_cells": 0,
                             "ring_queries": 0, "rescued_queries": 0,
                             "wall_s": 0.0, "t_retry_s": 0.0}
        # the in-epoch full-scan rescue starts off and turns on at the
        # first cell escalation (the JAX package's default "auto" mode)
        self._rescue_active = False

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

        # f32 epoch constants on the device
        dev = self.device
        self._lo_t = torch.tensor(self._lo, dtype=torch.float32, device=dev)
        self._width_t = torch.tensor(self._width, dtype=torch.float32,
                                     device=dev)
        self._dirs_t = torch.tensor(self._dirs, dtype=torch.float32,
                                    device=dev)
        self._offsets_t = torch.tensor(self._offsets, dtype=torch.float32,
                                       device=dev)
        self._shift_t = torch.tensor(self._knn._shift, dtype=torch.float32,
                                     device=dev)

        self._target_norm = float(np.linalg.norm(target))
        self._print_settings()
        self._create_first_cell(middle)
        self._gain0_t = torch.tensor(self._gain0, dtype=torch.float32,
                                     device=dev)
        self._times["t_knn_build"] = t_knn
        self._times["t_init"] = time() - t_init0

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
        metric, invalid, bad) on the host.  A cell is ``bad`` when one of
        its queries is not provably exact.

        - ``"grid"`` (the JAX package's ``fn_grid_dil``): the dilated
          query, or the blocked one at radius 1 where the index has no
          dilated layout; then the ring over the bad queries of valid cells
          (invalid cells are removed regardless, so their queries are never
          retried), then the full-scan rescue once it is active.
        - ``"ring"`` (``fn_grid_ring``): every query over the blocked
          radius-4 neighbourhood, for the host escalation.
        - ``"full"``: the exact full scan, never bad.

        The query centres are computed once and serve every route, so a
        query answered by the ring or the rescue gets the answer its own
        full-scan retry would."""
        knn = self._knn
        k = self._n_neighbors
        n_children = 1 + 2 ** self._n_dimensions
        coords, level = self._cells_on_device(idx)
        queries = self._query_centers(coords, level)
        invalid = self._invalid_on_device(
            coords, level, [g for g in self._geometry if not _huge(g)])
        huge = [g for g in self._geometry if _huge(g)]
        if huge:
            # the JAX package's host-merged validity (its
            # ``_host_geo_validity``): host-built nodes behind the box
            invalid |= torch.from_numpy(self._cell_flags_host(
                idx, huge, False)).to(self.device)
        st = self._epoch_stats
        nq = queries.shape[0]
        st["queries"] += nq
        if mode == "full":
            sq, nbr = _search(queries, knn._points, knn._points_sq, k,
                              knn._tile_n, knn._tile_q)
            badq = torch.zeros(nq, dtype=torch.bool, device=self.device)
        elif mode == "ring":
            sq = torch.zeros((nq, k), dtype=torch.float32, device=self.device)
            nbr = torch.zeros((nq, k), dtype=torch.int64, device=self.device)
            badq = torch.ones(nq, dtype=torch.bool, device=self.device)
            self._ring(queries, sq, nbr, badq)
        else:
            if "dil_pts" in knn._grid:
                sq, nbr, _, ok, _ = _dilated_topk(queries, knn._grid, k)
            else:
                sq, nbr, ok = _blocked_topk(queries, knn._grid, k)
            badq = ~ok & ~invalid.repeat_interleave(n_children)
            st["ring_queries"] += self._ring(queries, sq, nbr, badq)
            if self._rescue_active:
                st["rescued_queries"] += self._rescue(queries, sq, nbr, badq)
        bad = badq.reshape(-1, n_children).any(dim=1)
        pred = _weighted_sum(_idw(sq), knn._values[nbr])
        return self._gain_tail(level, pred, invalid, bad).cpu().numpy()

    def _ring(self, queries, sq, nbr, badq) -> int:
        """Answer the queries marked in ``badq`` again over the blocked
        radius-4 neighbourhood, in place on ``sq``, ``nbr`` and ``badq``
        (the JAX package's ring passes, ``fn_grid_dil``): the
        ``_RING_PLAN`` pass takes the first 256 in ascending index, then
        batches of ``_RING_LOOP_ROWS`` take the rest.  Each is tried once
        at radius 4; its answer does not depend on the batch it rides in.
        A row the ring cannot prove exact keeps the ring's answer and stays
        marked.  Returns how many rows it proved exact."""
        rows = torch.nonzero(badq).flatten()
        ((size, radius),) = _RING_PLAN
        answered = lo = 0
        while lo < rows.numel():
            r = rows[lo:lo + size]
            rsq, ridx, rok = _blocked_topk(queries[r], self._knn._grid,
                                           self._n_neighbors, radius)
            sq[r], nbr[r], badq[r] = rsq, ridx, ~rok
            answered += int(rok.sum())
            lo += size
            size, radius = _RING_LOOP_ROWS, _RING_LOOP_RADIUS
        return answered

    def _rescue(self, queries, sq, nbr, badq) -> int:
        """The exact full scan for the first ``_RESCUE_ROWS`` queries still
        marked in ``badq`` (ascending index), in place, as the JAX package's
        in-kernel rescue; returns how many it answered."""
        rows = torch.nonzero(badq).flatten()[:_RESCUE_ROWS]
        if rows.numel():
            knn = self._knn
            sq[rows], nbr[rows] = _search(queries[rows], knn._points,
                                          knn._points_sq, self._n_neighbors,
                                          knn._tile_n, knn._tile_q)
            badq[rows] = False
        return int(rows.numel())

    def _maybe_enable_rescue(self) -> None:
        """At the first cell escalation, turn the in-epoch full-scan rescue
        on for every later epoch (the JAX package's default "auto" mode,
        which spares hole-free runs its cost)."""
        if not self._rescue_active:
            logger.info("Bad cells appeared: enabling the in-epoch "
                        "full-scan rescue for subsequent epochs.")
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

    def _process_new_cells(self, idx: np.ndarray) -> None:
        """Gain + metric + validity of newly created cells: fused epoch
        passes in chunks, then the host escalation for the bad cells."""
        if idx.size == 0:
            return
        if self._level[idx].max() > _F32_LEVEL_CAP:
            self._update_gain(idx)
            self._remove_invalid_cells(idx)
            return
        d = self._n_dimensions
        grid = self._knn._grid
        chunk = _EPOCH_CHUNK[d]
        if d == 3 and grid is not None and grid["C"] <= 32:
            chunk *= 2
        t0 = time()
        st = self._epoch_stats
        retry = []
        for lo in range(0, idx.size, chunk):
            part = idx[lo:lo + chunk]
            out = self._epoch(part, "full" if grid is None else "grid")
            st["n_calls_main"] += 1
            # cells whose grid kNN could not be answered exactly are
            # escalated, except those the geometry invalidated
            bad = (out[:, 3] > 0.5) & ~(out[:, 2] > 0.5)
            if bad.any():
                retry.append(part[bad])
            self._apply_epoch_out(part[~bad], out[~bad])
        if retry:
            self._resolve_retries(np.concatenate(retry), chunk)
        st["wall_s"] += time() - t0

    def _resolve_retries(self, retry_idx: np.ndarray, chunk: int) -> None:
        """Host escalation of cells still bad after their epoch (the JAX
        package's ``_resolve_retries``): the rescue turns on, a radius-4
        ring epoch answers the cells' queries, 256 cells a pass, and only
        the cells it still marks bad run through the exact full scan."""
        self._maybe_enable_rescue()
        st = self._epoch_stats
        st["n_bad_cells"] += int(retry_idx.size)
        t0 = time()
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
        st["t_retry_s"] += time() - t0

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
        coords, level = self._cells_on_device(idx)
        nodes = _corner_nodes_f32(coords, level, self._lo_t, self._width_t,
                                  self._offsets_t)
        return (g.check_cells(nodes, False).cpu().numpy(),
                g.check_cells(nodes, True).cpu().numpy())

    def _captured_metric(self) -> float:
        """Captured fraction ||metric at alive leaf centres||₂ / ||target||₂
        (per-leaf predictions are cached at creation)."""
        alive = self._alive_idx()
        ratio = float(np.sqrt(np.square(self._metric_arr[alive]).sum())
                      / self._target_norm)
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
        self._times["t_start_uniform"] = time()
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
        self._times["t_end_uniform"] = time()

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

    def refine(self) -> None:
        """Run the full grid generation (reference ``refine``,
        s_cube.py:563-667)."""
        logger.info("Generating the S^3 grid.")
        self._refine_uniform()

        iteration_count = 0
        self._n_cells_after_uniform = int(self._alive.sum())
        if self._n_cells_max is None:
            self._captured_metric()
        self._n_cells_log.append(int(self._alive.sum()))

        logger.info("Adaptive (metric-driven) refinement phase.")
        self._times["t_start_adaptive"] = time()
        asplit = {"t_select": 0.0, "t_expand": 0.0, "t_split": 0.0,
                  "t_epoch": 0.0, "n_iter": 0}
        while self._check_stopping_criteria():
            if self._n_cells_max is None:
                logger.info(f"\tStarting iteration no. {iteration_count}, "
                            f"captured metric: "
                            f"{round(self._metric[-1] * 100, 2)} %, "
                            f"N_cells = {int(self._alive.sum())}")
            else:
                logger.info(f"\tStarting iteration no. {iteration_count}, "
                            f"N_cells = {int(self._alive.sum())}")
            if len(self._metric) >= 2:
                self._compute_n_cells_per_iter()
            t0 = time()
            selected = self._select_top_k(min(self._cells_per_iter,
                                              self._n_cells))
            t1 = time()
            if self._max_delta_level:
                selected = self._expand_delta_level(selected)
            t2 = time()
            children = self._split(selected)
            t3 = time()
            self._process_new_cells(children)
            t4 = time()
            asplit["t_select"] += t1 - t0
            asplit["t_expand"] += t2 - t1
            asplit["t_split"] += t3 - t2
            asplit["t_epoch"] += t4 - t3
            asplit["n_iter"] += 1
            if self._n_cells_max is None:
                self._captured_metric()
            iteration_count += 1
            self._n_cells_log.append(int(self._alive.sum()))

        if self._n_cells_max is not None:
            self._captured_metric()
        self._times["adaptive_split"] = asplit
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
            self._times["t_start_geometry"] = time()
            self._execute_geometry_refinement(geometries)
            self._times["t_end_geometry"] = time()

    def _execute_geometry_refinement(self, geometries: list) -> None:
        """Refine near geometry surfaces level by level up to the target
        level (reference ``_execute_geometry_refinement``,
        s_cube.py:774-863).  Children get no gain/metric: the adaptive loop
        is over and nothing reads them again."""
        logger.info("Geometry-surface refinement phase.")
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
            while gmax > gmin:
                logger.info(f"\tRefining level {gmin + 1} / {gmax}.")
                to_refine = surface[self._level[surface] < gmax]
                if self._max_delta_level and surface.size:
                    # the 2:1 check covers every surface cell, those
                    # already at the target level too, and refines a
                    # coarser neighbour it finds even when that neighbour
                    # is itself a surface cell at the target level
                    # (reference s_cube.py:826-848)
                    lookup = self._make_nb_lookup()
                    direct = self._coarser_of(surface, lookup)
                    if direct.size:
                        to_refine = np.union1d(
                            to_refine,
                            self._expand_delta_level(direct, lookup))
                if to_refine.size == 0:
                    break
                children = self._split(to_refine)
                # children invalid w.r.t. THIS geometry only are removed
                # (reference s_cube.py:850); the surviving children near
                # the surface are the next level's surface set
                invalid, surf = self._geo_refine_flags(g, children)
                surface = children[~invalid & surf]
                dead = children[invalid]
                self._alive[dead] = False
                self._gain[dead] = 0.0
                gmin += 1
        self._current_max_level = int(self._level[self._alive_idx()].max())
        logger.info("Finished geometry refinement.")

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
        self._times["t_start_renumber"] = time()
        alive = self._alive_idx()
        coords = self._coords[alive]
        level = self._level[alive]
        depth = int(level.max())
        if depth > self._max_depth:
            raise ValueError(f"Refinement depth {depth} exceeds the lattice "
                             f"limit {self._max_depth}.")
        keys = morton.node_keys(coords, level, self._offsets, depth)
        unique_keys, inverse = np.unique(keys.ravel(), return_inverse=True)
        idx_dtype = (np.int32 if unique_keys.size < np.iinfo(np.int32).max
                     else np.int64)
        self.face_ids = inverse.reshape(keys.shape).astype(idx_dtype)
        node_coords = morton.decode_node_keys(unique_keys, self._n_dimensions,
                                              depth)
        h = self._width / float(1 << depth)
        self.all_nodes = self._lo + node_coords.astype(np.float64) * h
        self.all_centers = self._centers_of(coords, level)
        self.all_levels = level.astype(np.int64)[:, None]
        self._times["t_end_renumber"] = time()

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
        info["t_total"] = t["t_end_renumber"] - t["t_start_uniform"]
        info["t_init"] = t["t_init"]
        info["t_knn_build"] = t["t_knn_build"]
        info["epoch_stats"] = dict(self._epoch_stats)
        info["t_uniform"] = t["t_end_uniform"] - t["t_start_uniform"]
        info["t_renumbering"] = t["t_end_renumber"] - t["t_start_renumber"]
        info["adaptive_split"] = t.get("adaptive_split", {})
        if t["t_end_geometry"] > 0:
            info["t_geometry"] = t["t_end_geometry"] - t["t_start_geometry"]
            info["t_adaptive"] = t["t_start_geometry"] - t["t_start_adaptive"]
        else:
            info["t_geometry"] = None
            info["t_adaptive"] = t["t_start_renumber"] - t["t_start_adaptive"]

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
