"""The numbers that decide ``correct``: what the program produced against
the reference.

- ``cells_unmatched_pct``: the program's leaves against the reference's,
  by level and lattice position, as a share of the reference's leaves:
  leaves only one side has, plus the program's leaves whose centre is off
  its lattice position or whose face does not name the cell's corner
  nodes, in the published corner order.
- ``metric_trace_gap``: the largest relative gap between the program's
  captured-metric trace and the reference's, entry by entry; 1 where the
  two traces differ in length (a different number of iterations).
- ``field_gap``: the exported field against the reference's inverse-
  distance interpolation at the program's cell centres, the largest
  absolute gap over every cell and snapshot as a share of the largest
  reference value.  Where a centre's k-th and (k+1)-th nearest points lie
  within ``TIE_TOL`` of each other, the program's float32 distances may
  rank them either way: that cell's gap is the smaller of the two
  neighbour sets'.
"""
import numpy as np
import torch

from .knn import ExactKNN
from .s3 import DIRECTIONS, grid_keys

# a near-tie of the k-th neighbour, in coordinate units: the program takes
# its distances in float32 of coordinates centred on the cloud (a rounding
# of up to about 5e-7 at |x| = 4), so two candidates closer than this may
# swap ranks
TIE_TOL = 4e-6


def port_grid_check(levels, centers, faces, vertices, lo, width: float):
    """``(lattice coords [M, d] int64, levels [M] int64, bad [M] bool)``
    of the program's grid: a cell is bad where its centre is off the
    lattice or its face's nodes are not its corners in the reference's
    corner order."""
    levels = np.asarray(levels, dtype=np.int64).ravel()
    centers = np.asarray(centers, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    vertices = np.asarray(vertices, dtype=np.float64)
    d = centers.shape[1]
    h = width / np.exp2(levels.astype(np.float64))[:, None]
    coords = np.rint((centers - lo) / h - 0.5).astype(np.int64)
    tol = 1e-9 * width
    bad = np.abs(lo + (coords + 0.5) * h - centers).max(1) > tol
    offsets = ((np.asarray(DIRECTIONS[d]) + 1) // 2).astype(np.int64)
    if faces.shape != (centers.shape[0], 2 ** d):
        return coords, levels, np.ones(centers.shape[0], dtype=bool)
    corners = lo + (coords[:, None, :] + offsets[None]) * h[:, :, None]
    ok_ids = (faces >= 0) & (faces < vertices.shape[0])
    nodes = vertices[np.where(ok_ids, faces, 0)]
    bad |= ~ok_ids.all(1)
    bad |= np.abs(nodes - corners).max((1, 2)) > tol
    return coords, levels, bad


def cells_unmatched_pct(port: tuple, ref) -> float:
    """See the module's docstring; ``port`` is :func:`port_grid_check`'s
    result, ``ref`` a reference :class:`~.s3.Grid`."""
    coords, levels, bad = port
    depth = int(max(levels.max(initial=0), ref.levels.max(initial=0)))
    pk = grid_keys(levels, coords, depth)
    rk = grid_keys(ref.levels, ref.coords, depth)
    good = pk[~bad]
    only_port = np.setdiff1d(good, rk).size + int(bad.sum())
    only_ref = np.setdiff1d(rk, good).size
    return 100.0 * (only_port + only_ref) / max(rk.size, 1)


def metric_trace_gap(port_trace, ref_trace) -> float:
    a = np.asarray(port_trace, dtype=np.float64)
    b = np.asarray(ref_trace, dtype=np.float64)
    if a.shape != b.shape or a.size == 0:
        return 1.0
    return float(np.max(np.abs(a - b) / np.abs(b)))


def reference_field(knn: ExactKNN, centers: torch.Tensor,
                    snaps: torch.Tensor, k: int, dtype=torch.float64,
                    rows: int = 8192):
    """Yields ``(lo, hi, field [rows, S], alt [rows, S] or None)``: the
    inverse-distance field at ``centers[lo:hi]`` from the ``k`` nearest
    points, and where the k-th and (k+1)-th are a near-tie the field with
    the (k+1)-th in the k-th's place (None where no row of the block has
    one).  ``snaps [N, S]``; every operation in ``dtype``."""
    for lo in range(0, centers.shape[0], rows):
        q = centers[lo:lo + rows]
        d2, idx = knn.query(q, k + 1)
        dist = torch.sqrt(d2)
        tie = (dist[:, k] - dist[:, k - 1]) <= TIE_TOL
        field = _idw_rows(d2[:, :k], idx[:, :k], snaps, dtype)
        alt = None
        if bool(tie.any()):
            d2b = torch.cat([d2[:, :k - 1], d2[:, k:]], 1)
            idxb = torch.cat([idx[:, :k - 1], idx[:, k:]], 1)
            alt = torch.where(tie[:, None],
                              _idw_rows(d2b, idxb, snaps, dtype), field)
        yield lo, lo + q.shape[0], field, alt


def _idw_rows(d2, idx, snaps, dtype):
    w = 1.0 / torch.clamp_min(torch.sqrt(d2.to(dtype)), 1e-12)
    w = w / w.sum(1, keepdim=True)
    out = None
    for j in range(idx.shape[1]):
        term = w[:, j:j + 1] * snaps[idx[:, j]].to(dtype)
        out = term if out is None else out + term
    return out


def field_gap(knn: ExactKNN, centers, snaps, field, k: int) -> float:
    """``field_gap`` of the program's ``field [M, S]`` (host) at its
    ``centers [M, d]``; ``snaps [N, S]`` on the reference's device."""
    dev = knn.device
    c = torch.as_tensor(np.asarray(centers), dtype=torch.float64,
                        device=dev)
    worst, scale = 0.0, 0.0
    for lo, hi, ref, alt in reference_field(knn, c, snaps, k):
        got = torch.as_tensor(np.asarray(field[lo:hi]), device=dev).to(
            torch.float64)
        gap = (got - ref).abs().amax(1)
        if alt is not None:
            gap = torch.minimum(gap, (got - alt).abs().amax(1))
        worst = max(worst, float(gap.max()))
        scale = max(scale, float(ref.abs().max()))
    return worst / max(scale, 1e-300)
