"""Exact k-nearest-neighbour search and inverse-distance weights, in torch.

Port of the JAX package's ``ops/knn.py``.  Two paths answer a query, and
both emit the canonical ascending ``(distance², index)`` order, so their
results are bitwise equal wherever both are exact:

- **Full scan** (:func:`_search`): every point is scored by
  ``|p|² − 2 q·p``, the ``k + 8`` best by score of each point tile and then
  of all tiles are kept (ties to the lower index) by the ``topk_smallest``
  kernel, then re-ranked by the plain f32 delta-sum distance and sorted
  canonically.  The score's dot product is written as
  ``d`` elementwise products, so no matrix unit (and no TF32 rounding) is
  involved, and the result is the same on every device.
- **Dilated bucket grid** (``_build_grid`` / :func:`_dilated_topk`): each
  grid cell stores its whole 3^d neighbourhood as one row, sorted by
  candidate index and compacted to ``keep_w`` columns; a query's row of
  its own cell is scored by the plain delta-sum and selected in one
  launch of the hand-written ``grid_select`` kernel (:mod:`.grid_select`),
  whose lowest-slot tie rule is the canonical order on these rows.  A row
  is accepted only when its k-th distance lies inside the covered
  neighbourhood and no overflowing cell's box reaches its k-ball; every
  other row is re-answered by the full scan.
- **Blocked bucket grid** (:func:`_blocked_topk`): the members of each
  cell as one ``[C, d]`` slab; a query's (2r+1)^d slabs around its cell,
  whose candidates are not sorted by index, are scored and their ``k + 8``
  nearest sorted canonically by the same kernel's blocked entry.  It
  answers when the dilated layout is over ``KNNIndex.DIL_MAX_BYTES`` or
  narrower than k, and at radius 4 it is the engine's ring rescue.

Selections wider than the kernels' queue (``k + 8 > 256``, where the JAX
package calls ``lax.top_k``) keep the unfused chain: the distances as
eager operators and one stable sort (:func:`_select_sorted`).

Sums over the coordinate axis and over the k neighbours run in a fixed
order (:func:`_sqsum`, :func:`_rowsum`): the distances then equal XLA's
``jnp.sum(dd * dd, axis=-1)`` on the CPU bit for bit (a chain of fused
multiply-adds), and the CPU and the card give the same numbers.

XLA clamps out-of-bounds gathers and drops out-of-bounds scatters; torch
raises instead, so the pad index ``n_points`` gathers from an explicit zero
pad row of the values, and the grid fill masks the members beyond a cell's
capacity.
"""
import numpy as np
import torch

from .. import trace
from .._device import resolve_device
from . import grid_select as _gs
from . import morton
from . import topk as _topk
from .grid_select import _fma, _sort_neighbors, _sqsum

DEFAULT_TILE_N = 16384
DEFAULT_TILE_Q = 1024
# rows of the dilated-layout build processed at once (bounds the
# [block, 3^d·C, d] sort transients)
_DILATE_BLOCK = 8192


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root: torch's vectorised f32 ``sqrt`` on
    the CPU is not (about 0.5 % of results sit one ulp off), while the f64
    root rounded to f32 is exact on every device."""
    return torch.sqrt(x.double()).to(x.dtype)


def _rowsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (the same order on every
    device)."""
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out


def _weighted_sum(w: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``Σ_k w[q, k] · vals[q, k, ...]`` left to right over k."""
    def term(j):
        wj = w[:, j]
        return wj.reshape(wj.shape + (1,) * (vals.dim() - 2)) * vals[:, j]
    out = term(0)
    for j in range(1, w.shape[1]):
        out = out + term(j)
    return out


def _idw(sq: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalised inverse-distance weights from squared distances
    (``w = 1 / clamp(dist, 1e-12)``, reference ``export.py:428-429``).
    The normalisation is ``1 / (c · Σ 1/c)`` with ``c`` the clamped
    distance: XLA folds the JAX package's ``w / w.sum()`` into that one
    division, so with it the 2D (k = 8) predictions equal the JAX
    package's bit for bit."""
    c = torch.clamp_min(_sqrt(torch.clamp_min(sq, 0.0)), eps)
    return 1.0 / (c * _rowsum(1.0 / c)[:, None])


def _select_sorted(x: torch.Tensor, kk: int):
    """The ``kk`` smallest of each row, ascending, ties to the lowest
    column, through one stable sort: the selections wider than
    ``topk_smallest``'s queue, where the JAX package calls ``lax.top_k``
    (which has no cap).  Returns ``(vals [Q, kk], sel [Q, kk] int64)``."""
    vals, order = torch.sort(x, dim=1, stable=True)
    return vals[:, :kk], order[:, :kk]


def _selector(kk: int):
    """The selection for ``kk`` columns: the kernel up to its queue size,
    else :func:`_select_sorted`.  Each call site calls what this returns
    itself, so a launch is counted at the site that made it."""
    return _topk.topk_smallest if kk <= _topk.MAX_K else _select_sorted


def _tile_select(q, points, points_sq, t0: int, tile_n: int, kk: int):
    """The ``kk`` best points of the tile at ``t0`` for each query by the
    ranking score ``|p|² − 2 q·p`` (monotone in the distance per query),
    ascending, ties to the lower index: ``(score [Q, kk], idx [Q, kk]
    int64)``.  Entries scored +inf (pad rows) carry the tile's column 0
    (the selection kernel's caveat); :func:`_search` maps them to a pad."""
    p = points[t0:t0 + tile_n]
    dot = q[:, None, 0] * p[None, :, 0]
    for a in range(1, p.shape[1]):
        dot = dot + q[:, None, a] * p[None, :, a]
    score = points_sq[None, t0:t0 + tile_n] - 2.0 * dot
    kk = min(kk, score.shape[1])
    s, sel = _selector(kk)(score, kk)
    return s, sel.long() + t0


def _score_candidates(q, points, points_sq, kk: int, tile_n: int):
    """The ``kk`` best of ``points [N, d]`` for each query of ``q`` by the
    ranking score, over tiles of ``tile_n`` points (the last may be
    partial): ``(score [Q, kk], idx [Q, kk] int64)``, ascending, ties to
    the lower index (``kk <= N``).  Entries scored +inf carry some tile's
    column 0 (:func:`_tile_select`)."""
    cand_s, cand_i = [], []
    for t0 in range(0, points.shape[0], tile_n):
        s, i = _tile_select(q, points, points_sq, t0, tile_n, kk)
        cand_s.append(s)
        cand_i.append(i)
    if len(cand_s) == 1:
        return cand_s[0], cand_i[0]
    # the kk best of the tiles' candidates; tiles are in ascending order,
    # so equal scores keep the lower index
    s, sel = _selector(kk)(torch.cat(cand_s, dim=1), kk)
    return s, torch.gather(torch.cat(cand_i, dim=1), 1, sel.long())


def _search(queries, points, points_sq, k: int, tile_n: int, tile_q: int):
    """Exact top-k of ``queries [Q, d]`` over ``points [N, d]`` (N a multiple
    of ``tile_n``; pad rows carry ``points_sq = +inf``).  Returns
    ``(sq [Q, k] f32, idx [Q, k] int64)`` in canonical order."""
    n = points.shape[0]
    kk = min(k + 8, n)
    # the last row is always a pad: +inf-scored candidates point there, so
    # their exact distance is +inf too and they rank after every real point
    pad = n - 1
    sq_out, idx_out = [], []
    for lo in range(0, queries.shape[0], tile_q):
        q = queries[lo:lo + tile_q]
        s, best = _score_candidates(q, points, points_sq, kk, tile_n)
        best = best.masked_fill(s == float("inf"), pad)
        # exact distances of the widened set, canonical re-rank, keep k
        sq = _sqsum(q[:, None, :] - points[best])
        sq, best = _sort_neighbors(sq, best)
        sq_out.append(sq[:, :k])
        idx_out.append(best[:, :k])
    if not sq_out:
        return (torch.empty((0, k), dtype=points.dtype, device=points.device),
                torch.empty((0, k), dtype=torch.int64, device=points.device))
    return torch.cat(sq_out), torch.cat(idx_out)


# ---------------------------------------------------------------------- #
# bucket grid: plan and layout on the index's device                     #
# ---------------------------------------------------------------------- #
def _neighbor_offsets(d: int, radius: int = 1) -> np.ndarray:
    """All (2r+1)^d offsets in {-r..r}^d (the query cell's neighbourhood)."""
    rng = np.arange(-radius, radius + 1)
    return np.stack(np.meshgrid(*([rng] * d), indexing="ij"),
                    axis=-1).reshape(-1, d).astype(np.int32)


def _neighbor_offsets_on(d: int, radius: int, like: torch.Tensor):
    """:func:`_neighbor_offsets` built on ``like``'s device in its dtype,
    with no host-to-device copy (a copy from host memory waits for the
    device, which a query inside the device-resident loop must not)."""
    rng = torch.arange(-radius, radius + 1, device=like.device)
    return torch.stack(torch.meshgrid(*([rng] * d), indexing="ij"),
                       dim=-1).reshape(-1, d).to(like.dtype)


def _plan_grid(points: torch.Tensor, n_points: int, occupancy: int,
               capacity: int, shrink_target: int = 32) -> dict:
    """Bucket-grid plan over a (centred, Morton-sorted) cloud ``[N, d]``,
    on its device: the JAX package's host plan, bit for bit.

    Chooses the cell size ``h`` (≈ (occupancy/density)^(1/d), grown to a
    ~8·N storage cap, then shrunk until no cell exceeds ``shrink_target``
    members while the budget allows) and the per-cell capacity ``C`` (the
    pow2 covering the largest occupancy when that fits, else the 99.9th
    percentile, the rest overflowing into the exact fallback).  The scalar
    loop runs on the host from the cloud's bounds; each cell-count pass
    (``(p - lo) / h`` truncated and clipped, flat ids, ``bincount``) runs
    on the device and reads back its largest count (``passes`` counts
    them); only the over-capacity branch reads the counts back, for
    numpy's percentile.  Returns the scalars ``h``, ``C``, ``n_cells``,
    ``passes``, ``dims`` (numpy int64) and, on the device, ``origin``
    (``lo``, the cloud's dtype), ``overflow`` (``[n_cells + 1]`` f32 0/1),
    ``counts`` and the per-point ``flat_ids`` (int64, in ``points``' row
    order)."""
    dev, d = points.device, points.shape[1]
    lo_dev = points.amin(dim=0)
    lo, hi = torch.stack([lo_dev, points.amax(dim=0)]).cpu().numpy()
    extent = np.maximum(hi - lo, 1e-30)
    density = n_points / float(np.prod(extent))
    h = (occupancy / density) ** (1.0 / d)
    passes = 0

    def build_cells(h_val):
        nonlocal passes
        passes += 1
        dims_v = np.maximum(np.ceil(extent / h_val).astype(np.int64), 1)
        # divided by a device scalar: the card divides by a host scalar
        # through its reciprocal, which rounds otherwise
        t = ((points - lo_dev) / torch.full((), h_val, dtype=points.dtype,
                                            device=dev)).long()
        flat_v = t[:, 0].clamp(0, int(dims_v[0]) - 1)
        for ax in range(1, d):
            flat_v = (flat_v * int(dims_v[ax])
                      + t[:, ax].clamp(0, int(dims_v[ax]) - 1))
        del t
        counts_v = torch.bincount(flat_v, minlength=int(np.prod(dims_v)))
        return dims_v, flat_v, counts_v, int(counts_v.max())

    store_c = min(capacity, 2 * shrink_target)

    def storage_ok(h_val):
        dims_v = np.maximum(np.ceil(extent / h_val).astype(np.int64), 1)
        return np.prod(dims_v) * store_c <= 8 * n_points + 4096

    while not storage_ok(h):
        h *= 1.26
    dims, flat, counts, maxc = build_cells(h)
    for _ in range(8):
        if maxc <= shrink_target or not storage_ok(h / 1.15):
            break
        h /= 1.15
        del flat, counts
        dims, flat, counts, maxc = build_cells(h)
    n_cells = int(np.prod(dims))

    if maxc <= capacity:
        C = max(16, 1 << int(max(maxc, 2) - 1).bit_length())
    else:
        host = counts.cpu().numpy()
        occupied = host[host > 0]
        c999 = int(np.percentile(occupied, 99.9)) if occupied.size else 1
        C = 1 << int(max(c999, 2, occupancy) - 1).bit_length()
        C = int(min(capacity, max(16, C)))
    overflow = torch.zeros(n_cells + 1, dtype=torch.float32, device=dev)
    overflow[:n_cells] = counts > C
    return {"h": float(h), "C": C, "n_cells": n_cells, "passes": passes,
            "origin": lo_dev, "dims": dims, "overflow": overflow,
            "counts": counts, "flat_ids": flat}


def _grid_neighbor_table(dims: torch.Tensor, n_cells: int) -> torch.Tensor:
    """``[n_cells+1, 3^d]`` int64 on ``dims``' device (``dims`` an integer
    tensor ``[d]``): each cell's 3^d neighbourhood as flat cell ids;
    out-of-range neighbours and the sentinel row map to the all-pad
    sentinel row ``n_cells``.  Built one offset at a time, so its
    transients are ``[n_cells]`` columns."""
    d = dims.shape[0]
    dims = dims.long()
    rem = torch.arange(n_cells, device=dims.device)
    coords = [None] * d
    for ax in range(d - 1, 0, -1):
        coords[ax] = rem % dims[ax]
        rem = rem // dims[ax]
    coords[0] = rem
    out = torch.full((n_cells + 1, 3 ** d), n_cells, dtype=torch.int64,
                     device=dims.device)
    for j, off in enumerate(_neighbor_offsets(d).tolist()):
        flat = None
        valid = torch.ones(n_cells, dtype=torch.bool, device=dims.device)
        for ax in range(d):
            c = coords[ax] + off[ax]
            if off[ax]:
                valid &= (c >= 0) & (c < dims[ax])
            flat = c if flat is None else flat * dims[ax] + c
        out[:n_cells, j] = torch.where(valid, flat, n_cells)
    return out


def _max_dilated_occupancy(counts: torch.Tensor, dims, C: int) -> int:
    """Exact largest number of real (non-pad) candidates in any 3^d
    dilated row, from the per-cell member counts (on their device) capped
    at ``C``."""
    dims = tuple(int(x) for x in dims)
    d = len(dims)
    cgp = counts.new_zeros(tuple(s + 2 for s in dims))
    cgp[(slice(1, -1),) * d] = torch.clamp_max(counts, C).reshape(dims)
    acc = counts.new_zeros(dims)
    for off in np.ndindex(*(3,) * d):
        acc += cgp[tuple(slice(o, o + s) for o, s in zip(off, dims))]
    return int(acc.max()) if acc.numel() else 0


def _fill_from_flat(flat: torch.Tensor):
    """Fill triplet ``(cells, pos, order)`` from per-point flat cell ids:
    points grouped by cell (stable), ``pos`` = rank inside the cell."""
    n = flat.shape[0]
    iota = torch.arange(n, device=flat.device)
    flat_s, order = torch.sort(flat, stable=True)
    is_start = torch.ones(n, dtype=torch.bool, device=flat.device)
    is_start[1:] = flat_s[1:] != flat_s[:-1]
    seg_start = torch.cummax(torch.where(is_start, iota, 0), dim=0).values
    return flat_s, iota - seg_start, order


def _cell_list(cells, pos, order, n_rows: int, C: int, pad_idx: int):
    """Blocked member-index layout ``[n_rows, C]`` int32 (pad slots hold
    ``pad_idx``); members past the capacity are masked out, which is what
    XLA's dropped out-of-bounds scatter did."""
    out = torch.full((n_rows, C), pad_idx, dtype=torch.int32,
                     device=cells.device)
    keep = pos < C
    out[cells[keep], pos[keep]] = order[keep].to(torch.int32)
    return out


def _dilate_sorted(cell_pts, cell_list, nb, keep: int):
    """Dilated layout: each cell's 3^d neighbourhood rows concatenated,
    stably sorted by candidate index (pads, index ``n_points``, last) and
    compacted to ``keep`` columns.  Returns ``(dil_pts [n_rows, keep·d]
    f32, dil_cand [n_rows, keep] int32)``."""
    n_rows, _, d = cell_pts.shape
    out_pts = torch.empty((n_rows, keep * d), dtype=cell_pts.dtype,
                          device=cell_pts.device)
    out_cand = torch.empty((n_rows, keep), dtype=torch.int32,
                           device=cell_pts.device)
    for s in range(0, n_rows, _DILATE_BLOCK):
        rows = nb[s:s + _DILATE_BLOCK]
        b = rows.shape[0]
        pts_u = cell_pts[rows].reshape(b, -1, d)
        cand_u = cell_list[rows].reshape(b, -1)
        cand_s, o = torch.sort(cand_u, dim=1, stable=True)
        pts_s = torch.gather(pts_u, 1, o[:, :keep, None].expand(-1, -1, d))
        out_pts[s:s + b] = pts_s.reshape(b, keep * d)
        out_cand[s:s + b] = cand_s[:, :keep]
    return out_pts, out_cand


# ---------------------------------------------------------------------- #
# grid query                                                             #
# ---------------------------------------------------------------------- #
def _covered_margin_sq(t, cc, dims, inv_h, radius: int):
    """Squared exactness margin of the covered neighbourhood box, aware of
    the grid boundary (a face on the boundary imposes no constraint, and
    an anchor outside the bbox earns the cap-shaped allowance of the JAX
    package's ``_covered_margin_sq``).  Capped at 9e28, below the
    1e30-scale squared distances of the 1e15 pad slots, so a row whose
    top-k ran out of real candidates is always rejected.  The sum of
    squares, ``sum − out²`` and ``face² + oth`` are fused multiply-adds,
    as XLA's CPU backend compiles them, so the margins equal the JAX
    package's bit for bit."""
    h = 1.0 / inv_h
    out = torch.clamp_min(torch.maximum(t - dims, -t), 0.0) * h      # [Q, d]
    oth = _fma(-out, out, _sqsum(out)[:, None])                      # [Q, d]
    dlo = t - torch.clamp_min(cc - radius, 0)
    dhi = torch.minimum(cc + radius + 1, dims) - t
    dlo = torch.where(cc - radius <= 0, float("inf"), dlo)
    dhi = torch.where(cc + radius + 1 >= dims, float("inf"), dhi)
    face = torch.minimum(dlo, dhi) * h
    margin_sq = (_fma(face, face, oth) * (1.0 - 1e-4)).min(dim=1).values
    return torch.clamp_max(margin_sq, 9e28)


def _grid_query_margin(queries, origin, inv_h, dims):
    """Flat id of each query's (clamped) home cell and its exactness
    margin; queries outside the bbox map to the nearest boundary cell."""
    d = queries.shape[1]
    t = (queries - origin) * inv_h
    cc = torch.minimum(torch.clamp_min(torch.floor(t).long(), 0),
                       dims[None, :] - 1)
    margin_sq = _covered_margin_sq(t, cc, dims[None, :], inv_h, radius=1)
    flat = cc[:, 0]
    for ax in range(1, d):
        flat = flat * dims[ax] + cc[:, ax]
    return flat, margin_sq


def _overflow_contaminated(queries, ovf_nb, sq_max, origin, inv_h, dims,
                           radius: int = 1):
    """True where an OVERFLOWING neighbourhood cell's box intersects the
    query's k-ball (members beyond a cell's capacity can only live inside
    that box).  ``ovf_nb [Q, R]`` f32 0/1 flags in `_neighbor_offsets`
    order; the home cell is clamped to the grid like the flags' boxes."""
    d = queries.shape[1]
    offs = _neighbor_offsets_on(d, radius, queries)
    h = 1.0 / inv_h
    hi = dims.to(queries.dtype) - 1.0
    cc = torch.minimum(torch.clamp_min(
        torch.floor((queries - origin) * inv_h), 0.0), hi)
    lo_box = (cc[:, None, :] + offs[None, :, :]) * h + origin
    q3 = queries[:, None, :]
    gap = torch.clamp_min(torch.maximum(lo_box - q3, q3 - (lo_box + h)), 0.0)
    dist2 = _sqsum(gap)                                               # [Q, R]
    return ((ovf_nb > 0.5) & (dist2 <= sq_max[:, None])).any(dim=1)


def _dilated_select(queries, dil_pts, dil_cand, flat, k: int,
                    sorted_rows: bool = True):
    """Plain f32 delta-sum distances to the candidates of dilated rows
    ``flat`` and the canonical top-k, fused in the ``grid_select`` kernel
    (the JAX package's ``_dilated_select``): on rows sorted by index the k
    smallest, else the ``k + 8`` re-sorted by ``(sq, idx)``, through the
    unfused chain where that is wider than the kernel's queue.  Returns
    ``(sq [Q, k] f32, idx [Q, k] int64, sel [Q, k])``."""
    if sorted_rows or min(k + 8, dil_cand.shape[1]) <= _gs.MAX_K:
        return _gs.grid_select_dilated(queries, dil_pts, dil_cand, flat, k,
                                       sorted_rows)
    q, d = queries.shape
    sq = _sqsum(queries[:, None, :] - dil_pts[flat].reshape(q, -1, d))
    return _topk_canonical(sq, dil_cand[flat], k)


def _dilated_topk(queries, grid: dict, k: int):
    """Dilated-grid kNN of ``queries [Q, d]`` (centred f32): ``(sq, idx, sel,
    ok, flat)``, canonical order; ``ok`` marks rows provably exact."""
    origin, inv_h, dims = grid["origin"], grid["inv_h"], grid["dims"]
    flat, margin_sq = _grid_query_margin(queries, origin, inv_h, dims)
    sq, idx, sel = _dilated_select(queries, grid["dil_pts"],
                                   grid["dil_cand"], flat, k)
    sq_max = sq.max(dim=1).values
    ok = ((sq_max <= margin_sq)
          & ~_overflow_contaminated(queries, grid["dil_ovf"][flat], sq_max,
                                    origin, inv_h, dims))
    return sq, idx, sel, ok, flat


def _grid_neighborhood(anchors, n_cells_total: int, origin, inv_h, dims,
                       radius: int = 1):
    """Flat ids of each anchor's (2r+1)^d neighbourhood cells in
    `_neighbor_offsets` order (cells outside the grid map to the all-pad
    sentinel row ``n_cells_total - 1``) and the squared exactness margin of
    the covered box (:func:`_covered_margin_sq`).  Anchors outside the bbox
    are clamped to their nearest boundary cell.  Returns ``(flat [Q, R]
    int64, margin_sq [Q])``."""
    d = anchors.shape[1]
    offs = _neighbor_offsets_on(d, radius, dims)
    t = (anchors - origin) * inv_h
    cc = torch.minimum(torch.clamp_min(torch.floor(t).long(), 0),
                       dims[None, :] - 1)
    margin_sq = _covered_margin_sq(t, cc, dims[None, :], inv_h, radius)
    nb = cc[:, None, :] + offs[None, :, :]                            # [Q, R, d]
    valid = ((nb >= 0) & (nb < dims[None, None, :])).all(dim=-1)
    flat = nb[..., 0]
    for ax in range(1, d):
        flat = flat * dims[ax] + nb[..., ax]
    return torch.where(valid, flat, n_cells_total - 1), margin_sq


def _grid_candidates(queries, grid: dict, radius: int):
    """The (2r+1)^d blocked slabs around each query's cell as eager
    operators (the unfused chain of selections wider than the kernel's
    queue): plain f32 distances ``d2 [Q, R·C]`` (:func:`_sqsum`, the same
    rounding as the dilated rows), candidate ids ``cand [Q, R·C]``,
    ``margin_sq [Q]``, the per-cell overflow flags ``[Q, R]``."""
    cell_list = grid["cell_list"]
    flat, margin_sq = _grid_neighborhood(queries, cell_list.shape[0],
                                         grid["origin"], grid["inv_h"],
                                         grid["dims"], radius)
    q = queries.shape[0]
    cpts = grid["cell_pts"][flat]                           # [Q, R, C, d]
    d2 = _sqsum(queries[:, None, None, :] - cpts).reshape(q, -1)
    cand = cell_list[flat].reshape(q, -1)
    return d2, cand, margin_sq, grid["overflow"][flat]


def _topk_canonical(d2, cand, k: int):
    """:func:`.grid_select.canonical_topk` of given distances through the
    selection kernel up to its queue, else the stable sort (the JAX
    package's ``_topk_canonical``): the merge of a mesh's full route and
    the unfused chains.  Returns ``(sq, idx, sel)``, ``[Q, k]`` int64
    ids and slots."""
    return _gs.canonical_topk(d2, cand, k, _selector(min(k + 8, d2.shape[1])))


def _blocked_topk(queries, grid: dict, k: int, radius: int = 1, mask=None):
    """Blocked-grid kNN of ``queries [Q, d]`` (centred f32) over the
    (2r+1)^d neighbourhood of each query's cell: ``(sq, idx, ok)`` in
    canonical order, ``ok`` marking rows provably exact (the k-th distance
    inside the covered box, no overflowing cell's box inside the k-ball).
    Radius 1 is the JAX package's ``_grid_query_kernel``; radius 4 its
    ring rescue.  Rows ``mask [Q]`` leaves out are not scored: they get
    ``sq = +inf``, idx 0 and ``ok`` False."""
    cell_list = grid["cell_list"]
    r_cells = (2 * radius + 1) ** queries.shape[1]
    if min(k + 8, r_cells * grid["C"]) <= _gs.MAX_K:
        flat, margin_sq = _grid_neighborhood(queries, cell_list.shape[0],
                                             grid["origin"], grid["inv_h"],
                                             grid["dims"], radius)
        sq, idx, _ = _gs.grid_select_blocked(queries, grid["cell_pts"],
                                             cell_list, flat, k, mask)
        ovf_nb = grid["overflow"][flat]
    else:
        d2, cand, margin_sq, ovf_nb = _grid_candidates(queries, grid, radius)
        sq, idx, sel = _topk_canonical(d2, cand, k)
        sq, idx, _ = _gs.fill_unmarked(mask, sq, idx, sel)
    sq_max = sq.max(dim=1).values
    ok = ((sq_max <= margin_sq)
          & ~_overflow_contaminated(queries, ovf_nb, sq_max, grid["origin"],
                                    grid["inv_h"], grid["dims"], radius))
    return sq, idx, ok


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _morton_order(cloud: torch.Tensor) -> torch.Tensor:
    """Stable Morton order of a (centred) cloud ``[N, d]`` on its device:
    sorted position → original point index (int64).  The lattice
    coordinates and codes are the JAX package's numpy ones bit for bit
    (the same IEEE operations in the same order, truncating casts), and a
    stable sort of the int64 codes is numpy's stable argsort of the
    uint64 ones.  In 1D or above 3D the order is lexicographic on the
    first axis: a stable float sort, left on the host (a device sort may
    order +0.0 and -0.0 otherwise)."""
    depth = morton.MAX_DEPTH.get(cloud.shape[1])
    if depth is None:
        first = cloud[:, 0].cpu().numpy()
        return torch.from_numpy(np.argsort(first, kind="stable")).to(
            cloud.device)
    lo = cloud.amin(dim=0)
    extent = torch.clamp_min(cloud.amax(dim=0) - lo, 1e-30)
    top = (1 << depth) - 1
    lattice = torch.clamp(((cloud - lo) / extent * top).long(), 0, top)
    return torch.sort(morton.encode_tensor(lattice), stable=True).indices


def _padded_points(cloud: torch.Tensor, n_pad: int):
    """The sorted cloud's padded f32 copy ``[n_pad, d]`` (pad rows 1e30)
    and its squared norms ``[n_pad]`` f32 (pad rows +inf), on its device.
    Each norm is the f64 sum ``x·x + y·y (+ z·z)`` left to right, as numpy
    sums a row, rounded to f32."""
    n, d = cloud.shape
    pts = torch.full((n_pad, d), 1e30, dtype=torch.float32,
                     device=cloud.device)
    pts[:n] = cloud
    c = cloud.double()
    norm = c[:, 0] * c[:, 0]
    for a in range(1, d):
        norm = norm + c[:, a] * c[:, a]
    sq = torch.full((n_pad,), float("inf"), dtype=torch.float32,
                    device=cloud.device)
    sq[:n] = norm
    return pts, sq


def _pad_perm(perm: torch.Tensor) -> torch.Tensor:
    """The permutation with one more entry, 0, for the pad index."""
    return torch.cat([perm, perm.new_zeros(1)])


def _sorted_values(values: np.ndarray, perm_pad: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """Per-point ``values`` (f32, the caller's order) in sorted-point order
    on ``perm_pad``'s device, zero from row N to ``n_rows``: uploaded as
    given and gathered there through the permutation."""
    n = values.shape[0]
    out = torch.zeros((n_rows,) + values.shape[1:], dtype=torch.float32,
                      device=perm_pad.device)
    out[:n] = torch.from_numpy(np.ascontiguousarray(values)).to(
        perm_pad.device).index_select(0, perm_pad[:n])
    return out


class KNNIndex:
    """Point cloud on the device answering exact k-NN queries and
    inverse-distance-weighted regression (sklearn ``weights="distance"``
    semantics).  ``device=None`` means the card."""

    # the bucket-grid path is built for clouds of at least this many points
    GRID_MIN_POINTS = 32768
    # target mean points per grid cell (sets the cell size h)
    GRID_OCCUPANCY = 16
    # upper bound on the per-cell member capacity
    GRID_CAPACITY = 64
    # shrink the cell size until no cell holds more than this many members
    GRID_SHRINK_TARGET = 32
    # queries per grid pass; doubled when the capacity is <= 32
    GRID_CHUNK = 32768
    # the dilated layout is built only when its persistent bytes, (n_cells
    # + 1)·keep_w·(d + 3)·4, stay within this (the JAX package's
    # S3_TPU_DIL_MAX_BYTES default); above it the blocked layout answers
    DIL_MAX_BYTES = 4e9

    @property
    def _grid_chunk(self) -> int:
        if self._grid is not None and self._grid["C"] <= 32:
            return 2 * self.GRID_CHUNK
        return self.GRID_CHUNK

    def __init__(self, points, values=None, device=None,
                 tile_n: int = DEFAULT_TILE_N, tile_q: int = DEFAULT_TILE_Q):
        """The build is the span ``knn.build`` (its seconds: ``build_s``),
        with the children ``knn.upload`` (the host's centring and the
        centred cloud to the device, and after the grid the values),
        ``knn.order`` (the Morton order on the device, the permutation back
        to the host, the sorted cloud's padded f32 copy and norms), and on
        the grid path ``knn.plan`` (the bucket-grid plan: its cell-count
        passes on the device, its scalar loop on the host) and
        ``knn.layout`` (the blocked and dilated layouts, on the device)."""
        self.device = dev = resolve_device(device)
        points = np.asarray(points)
        self.n_points, self.n_dim = points.shape
        self._tile_q = tile_q
        self._tile_n = min(tile_n, _round_up(self.n_points, 128))
        with trace.span("knn.build", dev, points=self.n_points) as sp:
            with trace.span("knn.upload", dev) as up:
                # centring improves the f32 accuracy of the expanded score
                self._shift = points.mean(axis=0)
                centered = points - self._shift
                self._points_host = centered  # predict_host's exact f64 pass
                cloud = torch.from_numpy(centered).to(dev)
                up.count(bytes=centered.nbytes)

            with trace.span("knn.order", dev) as order:
                # Morton order: grid cells hold contiguous index ranges and
                # the full-scan tiles stay spatially coherent; ``_perm``
                # maps sorted position → original point index
                perm = _morton_order(cloud)
                self._perm = perm.cpu().numpy()
                order.count(readback_bytes=self._perm.nbytes)
                cloud = cloud.index_select(0, perm)
                # +1 guarantees a pad row: the index ``n_points`` always
                # exists
                self._points, self._points_sq = _padded_points(
                    cloud, _round_up(self.n_points + 1, self._tile_n))
                self._perm_dev = _pad_perm(perm)
                del perm
                self._pad_idx = self.n_points

            self._grid = None
            # exact-fallback row count of the most recent grid query
            self.last_fallback = 0
            plan = None
            if self.n_points >= self.GRID_MIN_POINTS and self.n_dim in (2, 3):
                with trace.span("knn.plan", dev) as pl:
                    plan = _plan_grid(cloud, self.n_points,
                                      self.GRID_OCCUPANCY, self.GRID_CAPACITY,
                                      self.GRID_SHRINK_TARGET)
                    plan["occ"] = _max_dilated_occupancy(
                        plan.pop("counts"), plan["dims"], plan["C"])
                    pl.count(cells=plan["n_cells"], passes=plan["passes"])
            # the sorted cloud goes before the layouts' transients
            del cloud
            if plan is not None:
                self._build_grid(plan)

            # the values after the grid, whose build transients they would
            # otherwise add to
            self._values = None
            if values is not None:
                with trace.span("knn.upload", dev) as up:
                    self.set_values(values)
                    up.count(bytes=self._values_host.nbytes)
        self.build_s = sp.seconds

    def _build_grid(self, plan: dict) -> None:
        """Bucket grid of :func:`_plan_grid`'s ``plan`` (with the dilated
        rows' largest occupancy ``occ``): the blocked layout (each cell's
        members as one ``[C, d]`` slab) and, within ``DIL_MAX_BYTES``, the
        dilated layout: each cell's row lists the members of its whole 3^d
        neighbourhood, ascending by index, compacted to the widest occupied
        row (a multiple of 64, at least 128).  The span ``knn.layout``;
        the plan's flat ids go once the fill has them."""
        dev = self.device
        d = self.n_dim
        C, n_cells = plan["C"], plan["n_cells"]
        n_rows = n_cells + 1
        with trace.span("knn.layout", dev, cells=n_cells):
            cells, pos, order = _fill_from_flat(plan.pop("flat_ids"))
            cell_list = _cell_list(cells, pos, order, n_rows, C, self._pad_idx)
            # pad slots read the 1e30 pad row, clamped to 1e15 so squared pad
            # distances stay finite (~3e30) yet never rank
            cell_pts = torch.clamp_max(self._points[cell_list.long()], 1e15)
            overflow = plan["overflow"]
            self._grid = {
                "C": C,
                "origin": plan["origin"].float(),
                "inv_h": torch.tensor(1.0 / plan["h"], dtype=torch.float32,
                                      device=dev),
                "dims": torch.from_numpy(plan["dims"]).to(dev),
                "cell_list": cell_list,
                "cell_pts": cell_pts,
                # f32 0/1 flags (the overflow verdict compares > 0.5)
                "overflow": overflow,
            }
            keep_w = int(min((3 ** d) * C,
                             max(128, -(-plan["occ"] // 64) * 64)))
            if n_rows * keep_w * (d + 3) * 4 > self.DIL_MAX_BYTES:
                return
            nb = _grid_neighbor_table(self._grid["dims"], n_cells)
            dil_pts, dil_cand = _dilate_sorted(cell_pts, cell_list, nb, keep_w)
            self._grid.update(dil_pts=dil_pts, dil_cand=dil_cand,
                              dil_ovf=overflow[nb], _dil_keep=keep_w)

    def set_values(self, values) -> None:
        """Attach per-point values for :meth:`predict` (``[N]`` or
        ``[N, C]``), sorted like the points on the device, plus one zero
        pad row that the pad index ``n_points`` gathers."""
        values = np.asarray(values, dtype=np.float32)
        if values.shape[0] != self.n_points:
            raise ValueError(f"{values.shape[0]} values for "
                             f"{self.n_points} points")
        self._values = _sorted_values(values, self._perm_dev,
                                      self.n_points + 1)
        self._values_host = values

    # ------------------------------------------------------------------ #
    # search paths (sorted-point indexing)                               #
    # ------------------------------------------------------------------ #
    def _queries_f32(self, queries_centered: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            queries_centered, dtype=np.float32)).to(self.device)

    def _full_scan(self, queries_centered: np.ndarray, k: int, mode: str):
        """Full scan on centred f64 queries: ``pred`` for "predict", else
        ``(sq, idx)`` with ``sq = sqrt(sq)²`` as the JAX package rounds it
        (its full scan returns distances and squares them again)."""
        # re-centre through the absolute coordinates, as the JAX package's
        # chunk runner does (an ulp-level difference in rare f64 cases)
        q = self._queries_f32((queries_centered + self._shift) - self._shift)
        sq, idx = _search(q, self._points, self._points_sq, k, self._tile_n,
                          self._tile_q)
        if mode == "predict":
            return _weighted_sum(_idw(sq), self._values[idx])
        dists = _sqrt(torch.clamp_min(sq, 0.0))
        return dists * dists, idx

    def _grid_run(self, queries: np.ndarray, k: int, mode: str):
        """Grid path with per-query exactness verification; rejected rows
        are re-answered by the full scan (``last_fallback`` counts them)."""
        g = self._grid
        qf = self._queries_f32(queries)
        use_dil = "dil_pts" in g and k <= g["_dil_keep"]
        outs, oks = [], []
        for lo in range(0, qf.shape[0], self._grid_chunk):
            chunk = qf[lo:lo + self._grid_chunk]
            if use_dil:
                sq, idx, _, ok, _ = _dilated_topk(chunk, g, k)
            else:
                sq, idx, ok = _blocked_topk(chunk, g, k)
            outs.append(_weighted_sum(_idw(sq), self._values[idx])
                        if mode == "predict" else (sq, idx))
            oks.append(ok)
        ok = torch.cat(oks)
        bad = torch.nonzero(~ok).flatten()
        self.last_fallback = int(bad.numel())
        if mode == "predict":
            pred = torch.cat(outs)
            if bad.numel():
                pred[bad] = self._full_scan(queries[bad.cpu().numpy()], k,
                                            "predict")
            return pred
        sq = torch.cat([o[0] for o in outs])
        idx = torch.cat([o[1] for o in outs])
        if bad.numel():
            sq[bad], idx[bad] = self._full_scan(queries[bad.cpu().numpy()],
                                                k, "query")
        return sq, idx

    def _uses_grid(self, n_queries: int, k: int) -> bool:
        """The grid answers when its 3^d·C candidates can hold k, as in the
        JAX package, and k fits the selection kernel's queue (a larger k
        goes to the full scan, which gives the same canonical answer)."""
        g = self._grid
        return (g is not None and n_queries > 0
                and k <= min((3 ** self.n_dim) * g["C"], _topk.MAX_K))

    def _spatial_run(self, queries, k: int, mode: str):
        """Grid path when it can hold k candidates (the dilated layout
        where it exists and is at least k wide, else the blocked one),
        else the full scan.  Returns ``(sq, idx)`` (sorted-point indexing)
        or ``pred``, as tensors on the device."""
        queries = np.asarray(queries, dtype=np.float64) - self._shift
        if self._uses_grid(queries.shape[0], k):
            return self._grid_run(queries, k, mode)
        return self._full_scan(queries, k, mode)

    def _check_k(self, k: int) -> None:
        if not 1 <= k <= self.n_points:
            raise ValueError(f"k={k} must lie in [1, {self.n_points}] (the "
                             f"number of indexed points).")

    # ------------------------------------------------------------------ #
    # public API                                                         #
    # ------------------------------------------------------------------ #
    def query(self, queries, k: int):
        """Exact k-NN: ``(dists [Q, k], idx [Q, k])`` as numpy, ``idx`` in
        original point order."""
        self._check_k(k)
        sq, idx = self._spatial_run(queries, k, "query")
        dists = _sqrt(torch.clamp_min(sq, 0.0))
        return dists.cpu().numpy(), self._perm_dev[idx].cpu().numpy()

    def weights_device(self, queries, k: int):
        """Normalised inverse-distance weights and neighbour indices
        (original point order) as device tensors ``(w [Q, k] f32,
        idx [Q, k] int64)``: the export's device route (the JAX package's
        ``weights_device``)."""
        self._check_k(k)
        sq, idx = self._spatial_run(queries, k, "query")
        return _idw(sq), self._perm_dev[idx]

    def weights(self, queries, k: int):
        """Normalised inverse-distance weights and neighbour indices
        (original point order) as numpy ``(w [Q, k] f32, idx [Q, k])``:
        the JAX package's host weights (its ``ops/knn.py:1296-1330``).

        The device selects the neighbours; where the JAX package's grid
        could hold k (``k <= 3^d·C``, whichever search answered here) only
        the indices come back and the distances are recomputed in numpy
        from the f32 centred cloud, fallback rows included; else the full
        scan's squared distances come back.  The arithmetic is numpy's
        (its pairwise row sums), so the weights are the JAX package's bit
        for bit on every device."""
        self._check_k(k)
        q64 = np.asarray(queries, dtype=np.float64) - self._shift
        sq, idx = self._spatial_run(queries, k, "query")
        idx = self._perm_dev[idx].cpu().numpy()
        if (self._grid is not None and q64.shape[0] > 0
                and k <= (3 ** self.n_dim) * self._grid["C"]):
            nbr = self._points_host32[idx]
            diff = nbr - q64[:, None, :].astype(np.float32)
            dists = np.sqrt(np.maximum((diff * diff).sum(-1), 0.0))
        else:
            dists = np.sqrt(np.maximum(sq.cpu().numpy(), 0.0))
        w = 1.0 / np.clip(dists, 1e-12, None)
        w /= w.sum(axis=1, keepdims=True)
        return w.astype(np.float32), idx

    @property
    def _points_host32(self) -> np.ndarray:
        """The f32 centred cloud in original point order, cached (the
        host distances of :meth:`weights`)."""
        if getattr(self, "_points_host32_cache", None) is None:
            self._points_host32_cache = self._points_host.astype(np.float32)
        return self._points_host32_cache

    def predict(self, queries, k: int) -> np.ndarray:
        """Inverse-distance-weighted regression of the attached values at
        the query points (sklearn ``KNeighborsRegressor(k,
        weights="distance")``)."""
        if self._values is None:
            raise RuntimeError("No values attached; call set_values() first.")
        self._check_k(k)
        return self._spatial_run(queries, k, "predict").cpu().numpy()

    def predict_host(self, queries, k: int) -> np.ndarray:
        """Exact f64 numpy variant for a handful of queries (the root
        cell's 1 + 2^d gain queries): an f32 Gram-score pre-filter over
        all points, then exact f64 distances on a 4k+16 candidate slack."""
        if self._values is None:
            raise RuntimeError("No values attached; call set_values() first.")
        q = np.asarray(queries, dtype=np.float64) - self._shift
        p = self._points_host
        n = p.shape[0]
        p32 = p.astype(np.float32)
        m = min(4 * k + 16, n)
        if m < n:
            s = (-2.0 * q.astype(np.float32)) @ p32.T
            s += np.einsum("nd,nd->n", p32, p32)[None, :]
            cand = np.argpartition(s, m - 1, axis=1)[:, :m]
        else:
            cand = np.broadcast_to(np.arange(n), (q.shape[0], n))
        d2 = np.square(p[cand] - q[:, None, :]).sum(-1)
        sel = np.argpartition(d2, k - 1, axis=1)[:, :k]
        idx = np.take_along_axis(cand, sel, axis=1)
        dists = np.sqrt(np.take_along_axis(d2, sel, axis=1))
        w = 1.0 / np.clip(dists, 1e-12, None)
        w /= w.sum(axis=1, keepdims=True)
        vals = self._values_host[idx]
        if vals.ndim == 3:
            return (w[..., None] * vals).sum(axis=1)
        return (w * vals).sum(axis=1)


def index_from_reference(arrays: dict, device=None) -> KNNIndex:
    """A :class:`KNNIndex` over the arrays of an index the JAX package built
    (numpy copies): ``_points``, ``_points_sq``, ``_perm``, ``_shift`` and,
    where the cloud has a grid, ``origin``, ``inv_h``, ``dims``, ``C``,
    ``cell_list``, ``overflow`` and, where it has a dilated layout,
    ``dil_pts``, ``dil_cand``, ``dil_ovf`` and ``_dil_keep`` (the blocked
    slabs are gathered from ``_points`` and ``cell_list`` as
    ``_build_grid`` gathers them).  Lets the query side run on a layout
    built elsewhere, so
    a query fault shows apart from a build fault.  ``_points_host`` (the
    centred f64 cloud, original order) is optional; without it
    :meth:`KNNIndex.predict_host` works from the f32 points."""
    dev = resolve_device(device)
    idx = KNNIndex.__new__(KNNIndex)
    idx.device = dev
    perm = np.asarray(arrays["_perm"]).astype(np.int64)
    points = np.asarray(arrays["_points"], dtype=np.float32)
    idx.n_points = perm.shape[0]
    idx.n_dim = points.shape[1]
    idx._tile_q = DEFAULT_TILE_Q
    idx._tile_n = min(DEFAULT_TILE_N, _round_up(idx.n_points, 128))
    if points.shape[0] % idx._tile_n:
        raise ValueError(f"{points.shape[0]} padded points are not a "
                         f"multiple of the tile {idx._tile_n}")
    idx._shift = np.asarray(arrays["_shift"], dtype=np.float64)
    idx._perm = perm
    idx._points = torch.from_numpy(points.copy()).to(dev)
    idx._points_sq = torch.from_numpy(np.asarray(
        arrays["_points_sq"], dtype=np.float32).copy()).to(dev)
    host = arrays.get("_points_host")
    if host is None:
        host = np.empty((idx.n_points, idx.n_dim), dtype=np.float64)
        host[perm] = points[:idx.n_points]
    idx._points_host = np.asarray(host, dtype=np.float64)
    idx._pad_idx = idx.n_points
    idx._perm_dev = torch.from_numpy(
        np.concatenate([perm, np.zeros(1, np.int64)])).to(dev)
    idx.last_fallback = 0
    idx._values = None
    idx._grid = None
    if "cell_list" in arrays:
        def t(name, dtype):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(arrays[name]).astype(dtype))).to(dev)
        cell_list = t("cell_list", np.int32)
        idx._grid = {
            "C": int(arrays["C"]),
            "origin": t("origin", np.float32),
            "inv_h": torch.tensor(float(np.asarray(arrays["inv_h"])),
                                  dtype=torch.float32, device=dev),
            "dims": t("dims", np.int64),
            "cell_list": cell_list,
            "cell_pts": torch.clamp_max(idx._points[cell_list.long()], 1e15),
            "overflow": t("overflow", np.float32),
        }
        if "dil_pts" in arrays:
            idx._grid.update(dil_pts=t("dil_pts", np.float32),
                             dil_cand=t("dil_cand", np.int32),
                             dil_ovf=t("dil_ovf", np.float32),
                             _dil_keep=int(arrays["_dil_keep"]))
    return idx
