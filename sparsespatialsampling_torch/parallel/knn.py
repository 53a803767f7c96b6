"""Exact k-NN over a point cloud sharded along the cell axis of a mesh.

Port of the JAX package's ``parallel/knn.py`` (``ShardedKNNIndex``).  The
cloud is centred, Morton-sorted as :class:`~..ops.knn.KNNIndex` sorts it,
padded to a multiple of the shard count (pad rows score +inf) and cut into
one contiguous slab per shard.  Queries are replicated; every selection
goes through a hand-written kernel (or, for ``k + 8`` above its queue, the
stable sort of ``ops/knn.py``), never ``torch.topk``: the grid rows'
scoring and selection through ``grid_select``, the full route's through
``topk_smallest``.

- **Full route** (the JAX package's ``_build`` and the engine's
  ``knn_merge``): each shard takes its ``k + 8`` best points by the ranking
  score over its slab's tiles (:meth:`_shard_candidates`), computes their
  exact plain-f32 distances (pad rows +inf) and global ids; the candidates
  are gathered on the root and merged canonically (:meth:`_shard_merge`).
- **Grid route** (``_build_grid``, ``_build_grid_query``): the JAX
  package's row-sharded dilated bucket grid, each row the unsorted 3^d·C
  candidates of one cell's neighbourhood, rows padded with copies of the
  sentinel row to a multiple of the shard count.  The owner of a query is
  the shard holding its home cell's row (``flat // rows_per_dev``); each
  shard answers only the queries it owns (:meth:`_shard_grid_select`:
  the canonical top-k of its rows, then the margin and overflow test),
  and the answers are put back in query order on the root.  Rows not
  certified exact go to the full route (``last_fallback``).

Both routes emit the canonical ascending ``(distance², index)`` order
with the ``k + 8`` slack, ``index`` the Morton-sorted position as in
:class:`~..ops.knn.KNNIndex`, so :meth:`ShardedKNNIndex.query` equals the
single-device ``KNNIndex.query`` bit for bit.  (The JAX package ranks its
full route by the score alone, without slack, and so may order exact
distance ties differently.)
"""
import numpy as np
import torch

from ..ops import topk as _topk
from ..ops.knn import (DEFAULT_TILE_N, DEFAULT_TILE_Q, KNNIndex, _cell_list,
                       _dilated_select, _fill_from_flat, _grid_neighbor_table,
                       _grid_query_margin, _idw, _morton_order,
                       _overflow_contaminated, _pad_perm, _padded_points,
                       _plan_grid, _round_up, _score_candidates,
                       _sorted_values, _sqrt, _sqsum, _topk_canonical,
                       _weighted_sum)
from .mesh import Mesh, all_gather, shard_rows

_INF = float("inf")


class ShardedKNNIndex:
    """Exact k-NN and inverse-distance weights over a cloud sharded across
    a :class:`~.mesh.Mesh`; the results land on the mesh's root."""

    # the grid policy of the single-device index (``ops/knn.KNNIndex``)
    GRID_MIN_POINTS = 32768
    GRID_OCCUPANCY = 16
    GRID_CAPACITY = 64
    # per-shard budget of the dilated rows: the grid's total capacity
    # grows with the mesh
    GRID_DEVICE_BYTES = 1.5e9
    # queries per grid pass of :meth:`query` (bounds the [Q, 3^d·C, d]
    # gather on each shard)
    GRID_CHUNK = {2: 32768, 3: 8192}

    def __init__(self, points, mesh: Mesh, values=None,
                 tile_n: int = DEFAULT_TILE_N, tile_q: int = DEFAULT_TILE_Q):
        points = np.asarray(points)
        self.n_points, self.n_dim = points.shape
        self._shift = points.mean(axis=0)
        centered = points - self._shift
        # the single-device index's order, points and norms, built on the
        # mesh's root
        cloud = torch.from_numpy(centered).to(mesh.root)
        perm = _morton_order(cloud)
        cloud = cloud.index_select(0, perm)
        pts, sq = _padded_points(cloud, _round_up(self.n_points, mesh.size))
        self._setup(mesh, pts, sq, _pad_perm(perm), centered, tile_n, tile_q)
        # the JAX package's own centring, from the cloud cast to f32: the
        # host distances of :meth:`weights`
        p32 = np.asarray(points, dtype=np.float32)
        shift32 = p32.mean(axis=0)
        self._host32 = (p32 - shift32, shift32)
        if self.n_points >= self.GRID_MIN_POINTS and self.n_dim in (2, 3):
            self._build_grid(cloud, pts)
        if values is not None:
            self.set_values(values)

    def _setup(self, mesh, pts, sq, perm_pad, points_host, tile_n, tile_q):
        """The shards' slabs of the padded points and norms (tensors) and
        the root's bookkeeping; ``perm_pad`` is the permutation with the
        pad index's entry."""
        self.mesh = mesh
        self.n_shards = mesh.size
        self.device = mesh.root
        self._n_padded = pts.shape[0]
        self._n_local = self._n_padded // self.n_shards
        self._tile_q = tile_q
        self._tile_n = min(tile_n, _round_up(self._n_local, 128))
        self._shards = [
            {"device": dev, "points": p, "points_sq": s}
            for dev, p, s in zip(mesh.devices, shard_rows(pts, mesh),
                                 shard_rows(sq, mesh))]
        self._points_host = np.asarray(points_host, dtype=np.float64)
        self._pad_idx = self.n_points
        self._perm_dev = perm_pad.to(self.device)
        self._perm = self._perm_dev[:self.n_points].cpu().numpy()
        self._grid = None
        self._grid_fill = None
        self._values = None
        # exact-fallback row count of the most recent grid query
        self.last_fallback = 0

    def _build_grid(self, cloud: torch.Tensor, pts: torch.Tensor) -> None:
        """The row-sharded dilated bucket grid: the single-device index's
        plan, each cell's row the members of its whole 3^d
        neighbourhood (unsorted, 3^d·C wide), rows padded with copies of
        the sentinel row to a multiple of the shard count and cut into one
        contiguous block per shard.  Built only within
        ``GRID_DEVICE_BYTES`` a shard.  ``cloud`` is the centred sorted
        cloud the plan is made from (as the single-device index makes it),
        ``pts`` its padded f32 copy, both on the root."""
        d, root = self.n_dim, self.device
        plan = _plan_grid(cloud, self.n_points,
                          self.GRID_OCCUPANCY, self.GRID_CAPACITY)
        C, n_cells = plan["C"], plan["n_cells"]
        rows = n_cells + 1
        if rows * (3 ** d) * C * (d + 2) * 4 > (self.GRID_DEVICE_BYTES
                                                 * self.n_shards):
            return
        rows_pad = _round_up(rows, self.n_shards)
        cells, pos, order = _fill_from_flat(plan["flat_ids"])
        cell_list = _cell_list(cells, pos, order, rows, C, self._pad_idx)
        # the pad index reads a 1e30 row, clamped to 1e15 as in the
        # single-device layout: squared pad distances stay finite but
        # never rank
        pts_pad = torch.cat([pts[:self.n_points],
                             pts.new_full((1, d), 1e30)])
        cell_pts = torch.clamp_max(pts_pad[cell_list.long()], 1e15)
        dims = torch.from_numpy(plan["dims"]).to(root)
        nb = _grid_neighbor_table(dims, n_cells)
        nb = torch.cat([nb, nb[-1:].expand(rows_pad - rows, -1)])
        overflow = plan["overflow"]
        consts = {
            "origin": plan["origin"].float(),
            "inv_h": torch.tensor(1.0 / plan["h"], dtype=torch.float32),
            "dims": dims}
        rpd = rows_pad // self.n_shards
        shards = []
        for s, dev in enumerate(self.mesh.devices):
            nb_s = nb[s * rpd:(s + 1) * rpd]
            shards.append({
                "device": dev,
                "dil_pts": cell_pts[nb_s].reshape(rpd, -1).to(dev),
                "dil_cand": cell_list[nb_s].reshape(rpd, -1).to(dev),
                "dil_ovf": overflow[nb_s].to(dev),
                **{k: v.to(dev) for k, v in consts.items()}})
        self._grid = {"C": C, "n_cells": n_cells, "rows": rows_pad,
                      "shards": shards,
                      **{k: v.to(root) for k, v in consts.items()}}
        self._grid_fill = (cell_list, nb)

    @property
    def core_kind(self) -> str:
        """The engine's sharded epoch core over this index (the JAX
        package's ``_dil_core_kind``): ``shard_grid`` where the grid rows
        carry values, else ``shard_full``."""
        g = self._grid
        return ("shard_grid" if g is not None and "dil_vals" in g["shards"][0]
                else "shard_full")

    def set_values(self, values) -> None:
        """Attach per-point values (``[N]`` or ``[N, C]``): sorted like the
        points on the root, zero past ``n_points``; a scalar field is also
        laid out along the grid rows of each shard (``dil_vals``)."""
        values = np.asarray(values, dtype=np.float32)
        if values.shape[0] != self.n_points:
            raise ValueError(f"{values.shape[0]} values for "
                             f"{self.n_points} points")
        self._values = _sorted_values(
            values, self._perm_dev, max(self._n_padded, self.n_points + 1))
        self._values_host = values
        if self._grid_fill is not None and values.ndim == 1:
            cell_list, nb = self._grid_fill
            cell_vals = self._values[cell_list.long()]
            rpd = self._grid["rows"] // self.n_shards
            for s, shard in enumerate(self._grid["shards"]):
                shard["dil_vals"] = cell_vals[nb[s * rpd:(s + 1) * rpd]] \
                    .reshape(rpd, -1).to(shard["device"])

    # ------------------------------------------------------------------ #
    # full route                                                         #
    # ------------------------------------------------------------------ #
    def _shard_candidates(self, q, shard: dict, k: int):
        """One shard's ``k + 8`` best points for the queries ``q`` (on the
        shard's device) by the ranking score: their exact plain-f32
        distances (+inf for pads) and local ids."""
        pts, psq = shard["points"], shard["points_sq"]
        s, idx = _score_candidates(q, pts, psq, min(k + 8, self._n_local),
                                   self._tile_n)
        sq = _sqsum(q[:, None, :] - pts[idx])
        return torch.where(s == _INF, _INF, sq), idx

    def _shard_merge(self, q, k: int):
        """Every shard's candidates of one query block, gathered on the
        root in shard order and merged canonically: ``(sq [Q, k], idx
        [Q, k])``, ``idx`` the global sorted position."""
        parts_sq, parts_idx = [], []
        for s, shard in enumerate(self._shards):
            sq, idx = self._shard_candidates(q.to(shard["device"]), shard, k)
            parts_sq.append(sq)
            parts_idx.append(idx + s * self._n_local)
        sq, idx, _ = _topk_canonical(all_gather(parts_sq, self.mesh, dim=1),
                                     all_gather(parts_idx, self.mesh, dim=1),
                                     k)
        return sq, idx

    def full_select(self, queries: torch.Tensor, k: int):
        """Exact canonical k-NN of centred f32 ``queries`` (on the root)
        over every shard, ``tile_q`` queries a block: ``(sq [Q, k], idx
        [Q, k] int64)`` on the root."""
        outs = [self._shard_merge(queries[lo:lo + self._tile_q], k)
                for lo in range(0, queries.shape[0], self._tile_q)]
        if not outs:
            return (torch.empty((0, k), dtype=torch.float32,
                                device=self.device),
                    torch.empty((0, k), dtype=torch.int64,
                                device=self.device))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    # ------------------------------------------------------------------ #
    # grid route                                                         #
    # ------------------------------------------------------------------ #
    def _shard_grid_select(self, q, lflat, margin_sq, shard: dict, k: int):
        """The queries ``q`` one shard owns, over its rows ``lflat``:
        canonical ``(sq, idx)``, the values at the selected slots (None
        without ``dil_vals``) and ``ok``, the rows provably exact."""
        sq, idx, sel = _dilated_select(q, shard["dil_pts"], shard["dil_cand"],
                                       lflat, k, sorted_rows=False)
        sq_max = sq.max(dim=1).values
        ok = (sq_max <= margin_sq) & ~_overflow_contaminated(
            q, shard["dil_ovf"][lflat], sq_max, shard["origin"],
            shard["inv_h"], shard["dims"])
        vals = (shard["dil_vals"][lflat[:, None], sel.long()]
                if "dil_vals" in shard else None)
        return sq, idx, vals, ok

    def grid_select(self, queries: torch.Tensor, k: int):
        """Grid k-NN of centred f32 ``queries`` (on the root): each shard
        answers the queries whose home cell it owns, and the answers are
        put back in query order.  Returns ``(sq [Q, k], idx [Q, k], vals
        [Q, k] or None, ok [Q])`` on the root; one read of the owners'
        counts."""
        g, root = self._grid, self.device
        flat, margin_sq = _grid_query_margin(queries, g["origin"],
                                             g["inv_h"], g["dims"])
        rpd = g["rows"] // self.n_shards
        owner = flat // rpd
        counts = torch.bincount(owner, minlength=self.n_shards).tolist()
        order = torch.argsort(owner, stable=True)
        n = queries.shape[0]
        sq = torch.empty((n, k), dtype=torch.float32, device=root)
        idx = torch.empty((n, k), dtype=torch.int64, device=root)
        ok = torch.empty(n, dtype=torch.bool, device=root)
        vals = (torch.empty((n, k), dtype=torch.float32, device=root)
                if "dil_vals" in g["shards"][0] else None)
        lo = 0
        for s, (shard, m) in enumerate(zip(g["shards"], counts)):
            rows, lo = order[lo:lo + m], lo + m
            if m == 0:
                continue
            dev = shard["device"]
            out = self._shard_grid_select(
                queries[rows].to(dev), (flat[rows] - s * rpd).to(dev),
                margin_sq[rows].to(dev), shard, k)
            sq[rows], idx[rows], ok[rows] = (out[0].to(root),
                                             out[1].to(root),
                                             out[3].to(root))
            if vals is not None:
                vals[rows] = out[2].to(root)
        return sq, idx, vals, ok

    # ------------------------------------------------------------------ #
    # public API (that of ``KNNIndex``)                                  #
    # ------------------------------------------------------------------ #
    _queries_f32 = KNNIndex._queries_f32
    _check_k = KNNIndex._check_k

    def _uses_grid(self, n_queries: int, k: int) -> bool:
        g = self._grid
        return (g is not None and n_queries > 0
                and k <= min((3 ** self.n_dim) * g["C"], _topk.MAX_K))

    def _full_run(self, queries_centered: np.ndarray, k: int):
        # re-centred through the absolute coordinates, as the
        # single-device full scan does
        return self.full_select(self._queries_f32(
            (queries_centered + self._shift) - self._shift), k)

    def _spatial_run(self, queries, k: int, mode: str):
        """The grid route where it can hold k (rows it cannot certify go
        to the full route), else the full route: ``(sq, idx)`` (sorted
        positions) or, for ``"predict"``, the IDW prediction, on the
        root."""
        qc = np.asarray(queries, dtype=np.float64) - self._shift
        if self._uses_grid(qc.shape[0], k):
            qf = self._queries_f32(qc)
            chunk = self.GRID_CHUNK[self.n_dim]
            outs = [self.grid_select(qf[lo:lo + chunk], k)
                    for lo in range(0, qf.shape[0], chunk)]
            sq = torch.cat([o[0] for o in outs])
            idx = torch.cat([o[1] for o in outs])
            bad = torch.nonzero(~torch.cat([o[3] for o in outs])).flatten()
            self.last_fallback = int(bad.numel())
            if bad.numel():
                sq[bad], idx[bad] = self._full_run(qc[bad.cpu().numpy()], k)
        else:
            self.last_fallback = qc.shape[0] if self._grid is not None else 0
            sq, idx = self._full_run(qc, k)
        if mode == "predict":
            return _weighted_sum(_idw(sq), self._values[idx])
        return sq, idx

    def query(self, queries, k: int):
        """Exact k-NN: ``(dists [Q, k], idx [Q, k])`` as numpy, ``idx`` in
        original point order (``KNNIndex.query``'s answer)."""
        self._check_k(k)
        sq, idx = self._spatial_run(queries, k, "query")
        dists = _sqrt(torch.clamp_min(sq, 0.0))
        return dists.cpu().numpy(), self._perm_dev[idx].cpu().numpy()

    def weights_device(self, queries, k: int):
        """Normalised inverse-distance weights and neighbour indices
        (original point order) as tensors on the root."""
        self._check_k(k)
        sq, idx = self._spatial_run(queries, k, "query")
        return _idw(sq), self._perm_dev[idx]

    def weights(self, queries, k: int):
        """Normalised inverse-distance weights and neighbour indices
        (original point order) as numpy ``(w [Q, k] f32, idx [Q, k])``:
        the JAX package's sharded weights (its ``parallel/knn.py:237-285``).
        The mesh selects the neighbours; their distances are recomputed in
        numpy from the cloud cast to f32 and centred on its f32 mean, the
        queries cast to f32 and centred alike, as the JAX package's
        sharded index holds its cloud.  Off exact distance ties the
        weights are the JAX package's bit for bit; they are not the
        single-device :meth:`KNNIndex.weights`, whose cloud is centred in
        f64."""
        self._check_k(k)
        _, idx = self._spatial_run(queries, k, "query")
        idx = self._perm_dev[idx].cpu().numpy()
        centered, shift = self._host32
        q = np.asarray(queries, dtype=np.float32) - shift
        delta = q[:, None, :] - centered[idx]
        dists = np.sqrt(np.maximum((delta * delta).sum(-1), 0.0))
        w = 1.0 / np.clip(dists, 1e-12, None)
        w /= w.sum(axis=1, keepdims=True)
        return w, idx

    def predict(self, queries, k: int) -> np.ndarray:
        """Inverse-distance-weighted regression of the attached values."""
        if self._values is None:
            raise RuntimeError("No values attached; call set_values() first.")
        self._check_k(k)
        return self._spatial_run(queries, k, "predict").cpu().numpy()

    predict_host = KNNIndex.predict_host


def sharded_index_from_reference(arrays: dict, mesh: Mesh
                                 ) -> ShardedKNNIndex:
    """A :class:`ShardedKNNIndex` over the arrays of a sharded index the
    JAX package built (numpy copies; its cloud is in original order, so
    the sorted position is the point index): ``_points`` and
    ``_points_sq`` (padded to ``_n_padded``), ``_shift``, ``_points_host``
    and, where it has a grid, ``dil_pts``, ``dil_cand``, ``dil_ovf``,
    ``dil_vals`` (optional), ``origin``, ``inv_h``, ``dims``, ``C``,
    ``n_cells`` and ``rows``; ``_values_host`` (optional) for
    :meth:`~ShardedKNNIndex.predict`.  The counterpart of
    ``ops.knn.index_from_reference``: the query side runs on a layout
    built elsewhere, so a query fault shows apart from a build fault."""
    pts = np.asarray(arrays["_points"], dtype=np.float32)
    sq = np.asarray(arrays["_points_sq"], dtype=np.float32)
    if pts.shape[0] != int(arrays["_n_padded"]) or pts.shape[0] % mesh.size:
        raise ValueError(f"{pts.shape[0]} padded points do not split over "
                         f"{mesh.size} shards")
    idx = ShardedKNNIndex.__new__(ShardedKNNIndex)
    idx.n_points = int(np.isfinite(sq).sum())
    idx.n_dim = pts.shape[1]
    idx._shift = np.asarray(arrays["_shift"], dtype=np.float64)
    idx._setup(mesh, torch.from_numpy(pts.copy()),
               torch.from_numpy(sq.copy()),
               _pad_perm(torch.arange(idx.n_points)),
               np.asarray(arrays["_points_host"])[:idx.n_points],
               DEFAULT_TILE_N, DEFAULT_TILE_Q)
    idx._host32 = (np.asarray(arrays["_points_host"],
                              dtype=np.float32)[:idx.n_points],
                   np.asarray(arrays["_shift"], dtype=np.float32))
    if "dil_pts" in arrays:
        rows = int(arrays["rows"])
        rpd = rows // mesh.size
        consts = {
            "origin": torch.from_numpy(np.array(arrays["origin"],
                                                dtype=np.float32)),
            "inv_h": torch.tensor(float(np.asarray(arrays["inv_h"])),
                                  dtype=torch.float32),
            "dims": torch.from_numpy(np.array(arrays["dims"],
                                              dtype=np.int64))}
        names = {"dil_pts": np.float32, "dil_cand": np.int32,
                 "dil_ovf": np.float32, "dil_vals": np.float32}
        shards = []
        for s, dev in enumerate(mesh.devices):
            shards.append({"device": dev,
                           **{k: v.to(dev) for k, v in consts.items()}})
            for name, dtype in names.items():
                if name in arrays:
                    block = np.asarray(arrays[name])[s * rpd:(s + 1) * rpd]
                    shards[-1][name] = torch.from_numpy(
                        np.array(block, dtype=dtype)).to(dev)
        idx._grid = {"C": int(arrays["C"]), "n_cells": int(arrays["n_cells"]),
                     "rows": rows, "shards": shards,
                     **{k: v.to(mesh.root) for k, v in consts.items()}}
    if "_values_host" in arrays:
        values = np.asarray(arrays["_values_host"], dtype=np.float32)
        idx._values_host = values
        padded = np.zeros((max(idx._n_padded, idx.n_points + 1),)
                          + values.shape[1:], dtype=np.float32)
        padded[:idx.n_points] = values
        idx._values = torch.from_numpy(padded).to(idx.device)
    return idx
