"""STL surfaces (3D) as geometry objects.

Port of the JAX package's ``geometry/stl.py``.  A point is inside the
surface when its generalized winding number (the triangles' solid angles
summed, over 4π) is above 0.5: exact for watertight meshes, and graceful for
meshes with small holes.  Most queries never pay for that sum:

- a voxel **sign grid** (:func:`build_sign_grid`), built once on the host,
  answers every point in a voxel that no triangle touches with one int8
  lookup (0 outside, 1 inside); its far voxels are classified by the
  cluster-dipole winding estimate on the geometry's device, the free shell
  around the surface by flood fill;
- the points in the near-surface band (state 2) are compacted in ascending
  index and take the exact winding number, through the hand-written kernel
  ``csrc/winding_number.cu`` on the card (:mod:`..ops.winding`), or, for
  meshes of ``_FW_MIN_TRIS`` triangles or more, the two-level fast winding
  number (:func:`build_fast_winding`: exact near field, dipole far field;
  plain PyTorch).

Tables, voxel arithmetic and bounds are the JAX package's: points are tested
in f32 against the f32 casts of the sign grid's origin and inverse voxel
size and of the bounding box, so the port routes each point as the JAX
package does.  The host tables are numpy; the device copies are made at a
query's first use on a device and kept per device, and never pickled.

Includes the binary/ASCII STL reader, the writer and the vertex-clustering
decimator (``reduce_by``), numpy only.
"""
import logging
import math
import struct

import numpy as np
import torch

from .._device import resolve_device
from ..ops import winding
from ..ops.knn import _sqrt
from .base import GeometryObject

logger = logging.getLogger(__name__)


def read_stl(path: str) -> np.ndarray:
    """Parse a binary or ASCII STL file into triangles ``[T, 3, 3]`` (float64)."""
    with open(path, "rb") as fh:
        header = fh.read(80)
        rest = fh.read()

    # binary STL: 80-byte header, uint32 triangle count, 50 bytes per triangle
    if len(rest) >= 4:
        (n_tri,) = struct.unpack("<I", rest[:4])
        if len(rest) == 4 + 50 * n_tri and not header[:5].lower().startswith(b"solid"):
            return _parse_binary(rest, n_tri)
        # some binary files do start with "solid"; trust the byte count
        if len(rest) == 4 + 50 * n_tri:
            try:
                return _parse_ascii(header + rest)
            except ValueError:
                return _parse_binary(rest, n_tri)
    return _parse_ascii(header + rest)


def _parse_binary(body: bytes, n_tri: int) -> np.ndarray:
    raw = np.frombuffer(body[4:4 + 50 * n_tri], dtype=np.uint8).reshape(n_tri, 50)
    floats = raw[:, :48].copy().view("<f4").reshape(n_tri, 4, 3)
    return floats[:, 1:4, :].astype(np.float64)  # drop the normal row


def _parse_ascii(data: bytes) -> np.ndarray:
    tokens = data.decode("ascii", errors="ignore").split()
    verts = []
    i = 0
    while i < len(tokens):
        if tokens[i] == "vertex":
            verts.append([float(tokens[i + 1]), float(tokens[i + 2]), float(tokens[i + 3])])
            i += 4
        else:
            i += 1
    verts = np.asarray(verts, dtype=np.float64)
    if len(verts) == 0 or len(verts) % 3 != 0:
        raise ValueError("Could not parse STL file as ASCII.")
    return verts.reshape(-1, 3, 3)


def write_stl(path: str, triangles: np.ndarray) -> None:
    """Write triangles ``[T, 3, 3]`` as a binary STL file."""
    tri = np.asarray(triangles, dtype=np.float32)
    n = tri.shape[0]
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norms = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(norms == 0, 1.0, norms)
    body = np.zeros((n, 50), dtype=np.uint8)
    packed = np.concatenate([normals[:, None, :], tri], axis=1).astype("<f4")  # [n, 4, 3]
    body[:, :48] = packed.reshape(n, 48 // 4).view(np.uint8).reshape(n, 48)
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80)
        fh.write(struct.pack("<I", n))
        fh.write(body.tobytes())


def decimate(triangles: np.ndarray, reduce_by: float) -> np.ndarray:
    """Vertex-clustering decimation: quantize vertices onto a uniform grid and
    collapse triangles that become degenerate. The grid resolution is searched
    so the output has roughly ``(1 - reduce_by) * T`` triangles."""
    if reduce_by <= 0:
        return triangles
    target = max(16, int(round(triangles.shape[0] * (1.0 - reduce_by))))
    lo = triangles.reshape(-1, 3).min(axis=0)
    hi = triangles.reshape(-1, 3).max(axis=0)
    extent = np.where(hi - lo == 0, 1.0, hi - lo)

    best = triangles
    # bisection over the clustering resolution
    res_lo, res_hi = 2, 1024
    for _ in range(12):
        res = (res_lo + res_hi) // 2
        q = np.round((triangles - lo) / extent * res)
        snapped = lo + q / res * extent
        a, b, c = snapped[:, 0], snapped[:, 1], snapped[:, 2]
        ok = (np.linalg.norm(np.cross(b - a, c - a), axis=1) > 1e-30)
        cand = snapped[ok]
        if cand.shape[0] >= target:
            best = cand
            res_hi = res
        else:
            res_lo = res + 1
        if res_lo >= res_hi:
            break
    return best


# --------------------------------------------------------------------- #
# fast winding number (meshes of _FW_MIN_TRIS triangles or more)        #
# --------------------------------------------------------------------- #
# The JAX package measured the crossover on a TPU, where the two-level
# structure's per-point triangle gathers are slow; the port keeps its
# threshold so that a mesh gets the JAX package's flags.
_FW_MIN_TRIS = 262144
_FW_RADIUS = 2     # 5^3 cells around a point's cell are summed exactly
_FW_CHUNK = 1024   # points a near-field gather serves at once


def build_fast_winding(triangles: np.ndarray) -> dict:
    """Two-level acceleration structure for the generalized winding number
    (first-order fast winding, Barill et al. 2018): triangles bucketed by
    centroid on a uniform grid sized ≥ 2× the largest triangle radius; a
    query sums EXACT solid angles over its (2r+1)^3 neighborhood's
    triangles and the area-weighted normal dipole term over all other
    occupied clusters.  Host numpy tables, the JAX package's bit for bit."""
    tris = np.asarray(triangles, dtype=np.float64)
    t_count = tris.shape[0]
    cent = tris.mean(axis=1)
    area_n = 0.5 * np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    r_tri = np.linalg.norm(tris - cent[:, None, :], axis=-1).max(axis=1)
    r_max = float(r_tri.max())

    lo = cent.min(axis=0)
    extent = np.maximum(cent.max(axis=0) - lo, 1e-12)
    # h ≥ 2·r_max keeps every triangle that can graze a neighborhood inside
    # it; the upper sweep bounds total cells (dense [cells] arrays)
    h = max(2.0 * r_max, float(extent.max()) / 256.0, 1e-12)
    while True:
        dims = np.maximum(np.ceil(extent / h).astype(np.int64) + 1, 1)
        if np.prod(dims) <= 2e6:
            break
        h *= 1.26

    cc = np.clip((cent - lo) / h, 0, dims - 1).astype(np.int64)
    flat = cc[:, 0]
    for ax in range(1, 3):
        flat = flat * dims[ax] + cc[:, ax]
    n_cells = int(np.prod(dims))
    counts = np.bincount(flat, minlength=n_cells)
    # capacity cap: the spill-over triangles of pathologically clustered
    # patches (lat-lon pole fans) go to a global RESIDUAL list evaluated
    # exactly for every query
    C = min(64, 1 << int(max(int(counts.max()), 2) - 1).bit_length())

    order = np.argsort(flat, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(t_count) - starts[flat[order]]
    keep = pos < C
    cell_tris = np.full((n_cells + 1, C), t_count, dtype=np.int32)
    cell_tris[flat[order][keep], pos[keep]] = order[keep].astype(np.int32)
    resid = order[~keep]
    r_pad = 1 << int(max(len(resid), 1) - 1).bit_length()
    resid_idx = np.full(r_pad, t_count, dtype=np.int32)
    resid_idx[:len(resid)] = resid

    # sentinel triangle (index T): far away and degenerate → zero solid angle
    pad_tri = np.full((1, 3, 3), 1e6, dtype=np.float64)
    tris_pad = np.concatenate([tris, pad_tri]).astype(np.float32)

    # dense occupied-cluster table for the far-field dipole sweep, built
    # from the KEPT triangles only (residuals are always summed exactly)
    kept_mask = np.zeros(t_count, dtype=bool)
    kept_mask[order[keep]] = True
    flat_k, cent_k, an_k = flat[kept_mask], cent[kept_mask], area_n[kept_mask]
    cw = np.maximum(np.abs(an_k).sum(axis=1), 1e-30)
    sums = np.zeros((n_cells, 3))
    wsum = np.zeros(n_cells)
    an_sum = np.zeros((n_cells, 3))
    np.add.at(sums, flat_k, cent_k * cw[:, None])
    np.add.at(wsum, flat_k, cw)
    np.add.at(an_sum, flat_k, an_k)
    occ = np.nonzero(wsum > 0)[0]
    k_pad = 1 << int(max(len(occ), 1) - 1).bit_length()
    clus_cell = np.full((k_pad, 3), -10 ** 6, dtype=np.int32)  # never "near"
    clus_cent = np.zeros((k_pad, 3), dtype=np.float32)
    clus_an = np.zeros((k_pad, 3), dtype=np.float32)
    clus_cell[:len(occ)] = np.stack(np.unravel_index(occ, dims), axis=1)
    clus_cent[:len(occ)] = (sums[occ] / wsum[occ, None]).astype(np.float32)
    clus_an[:len(occ)] = an_sum[occ].astype(np.float32)

    return {
        "cell_tris": cell_tris,
        "v0": np.ascontiguousarray(tris_pad[:, 0]),
        "v1": np.ascontiguousarray(tris_pad[:, 1]),
        "v2": np.ascontiguousarray(tris_pad[:, 2]),
        "resid": resid_idx,
        "clus_cell": clus_cell,
        "clus_cent": clus_cent,
        "clus_an": clus_an,
        "origin": lo.astype(np.float32),
        "inv_h": np.float32(1.0 / h),
        "dims": dims.astype(np.int32),
    }


def _dipole_terms(pts, clus_cent, clus_an) -> torch.Tensor:
    """``[q, K]`` f32 dipole terms ``(c − p)·n / |c − p|³`` of clusters
    (centroids ``clus_cent``, summed area normals ``clus_an``, ``[K, 3]``)
    seen from ``pts [q, 3]``; products and sums round alone, in axis
    order, so every device gives the same terms."""
    dx = clus_cent[None, :, 0] - pts[:, 0:1]
    dy = clus_cent[None, :, 1] - pts[:, 1:2]
    dz = clus_cent[None, :, 2] - pts[:, 2:3]
    d2 = (dx * dx + dy * dy + dz * dz).clamp_min(1e-20)
    d3 = d2 * _sqrt(d2)
    return (dx * clus_an[None, :, 0] + dy * clus_an[None, :, 1]
            + dz * clus_an[None, :, 2]) / d3


def _fast_winding(points: torch.Tensor, fw: dict) -> torch.Tensor:
    """Fast winding number ``[M]`` f32 of ``points [M, 3]`` f32 from the
    device copy ``fw`` of :func:`build_fast_winding`'s tables: near field
    and residual triangles exact (:func:`..ops.winding.half_angles`), far
    clusters by their dipoles, all summed in f64 (the JAX package's
    ``_fw_one_chunk``, in chunks of ``_FW_CHUNK`` points)."""
    v0, v1, v2 = fw["v0"], fw["v1"], fw["v2"]
    resid, cell_tris, dims = fw["resid"], fw["cell_tris"], fw["dims"]
    rv0, rv1, rv2 = v0[resid][None], v1[resid][None], v2[resid][None]
    offs = fw["offs"]
    out = []
    for lo in range(0, points.shape[0], _FW_CHUNK):
        pts = points[lo:lo + _FW_CHUNK]
        q = pts.shape[0]
        cc = torch.floor((pts - fw["origin"]) * fw["inv_h"]).to(torch.int64)
        nb = cc[:, None, :] + offs[None]                        # [q, R, 3]
        valid = ((nb >= 0) & (nb < dims)).all(-1)
        flat = (nb[..., 0] * dims[1] + nb[..., 1]) * dims[2] + nb[..., 2]
        flat = torch.where(valid, flat, cell_tris.shape[0] - 1)
        cand = cell_tris[flat].reshape(q, -1)                   # [q, R·C]
        p = pts[:, None, :]
        acc = _chunked_half_angle_sum(p, v0, v1, v2, cand)
        acc += winding.half_angles(p, rv0, rv1, rv2).sum(dim=1)
        # far field: the occupied clusters outside the exact neighborhood
        near = ((fw["clus_cell"][None] - cc[:, None, :]).abs()
                <= _FW_RADIUS).all(-1)                          # [q, K]
        dip = _dipole_terms(pts, fw["clus_cent"], fw["clus_an"])
        acc += torch.where(near, 0.0, dip).double().sum(dim=1) / 2.0
        out.append((acc / (2.0 * math.pi)).to(torch.float32))
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=points.device)
    return torch.cat(out)


def _chunked_half_angle_sum(p, v0, v1, v2, cand) -> torch.Tensor:
    """``Σ_j half_angles`` over the gathered triangles ``cand [q, n]`` of
    each point ``p [q, 1, 3]``, in f64, rows in chunks of at most
    ``winding._PAIRS_PER_CHUNK`` pairs."""
    q, n = cand.shape
    rows = max(1, winding._PAIRS_PER_CHUNK // max(n, 1))
    parts = []
    for lo in range(0, q, rows):
        c = cand[lo:lo + rows]
        parts.append(winding.half_angles(p[lo:lo + rows], v0[c], v1[c],
                                         v2[c]).sum(dim=1))
    return torch.cat(parts)


# --------------------------------------------------------------------- #
# voxel sign grid: O(1) inside-tests away from the surface              #
# --------------------------------------------------------------------- #
# The sign grid classifies every voxel ONCE at construction (far voxels by
# the cluster dipole, the free shell by flood fill) so a query costs one
# int8 lookup; only the thin near-surface band pays the exact sweep.
_SG_MAX_VOX = 2_000_000
_SG_SEED_CD = 3      # seeds: Chebyshev ≥ _SG_SEED_CD+1 voxels from occupancy
_SG_CHUNK = 8192     # seed voxels a dipole sweep step takes
_SG_CLUSTER_CHUNK = 4096  # clusters a dipole sweep step takes


def _dilate_box(a: np.ndarray) -> np.ndarray:
    """One-step 26-connectivity (Chebyshev) box dilation of a 3D bool array
    (separable per axis, no wraparound)."""
    for ax in range(3):
        out = a.copy()
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[ax] = slice(1, None)
        sl_hi[ax] = slice(None, -1)
        out[tuple(sl_lo)] |= a[tuple(sl_hi)]
        out[tuple(sl_hi)] |= a[tuple(sl_lo)]
        a = out
    return a


def _dipole_winding(points: np.ndarray, clus_cent: np.ndarray,
                    clus_an: np.ndarray, device) -> np.ndarray:
    """First-order (cluster dipole) winding estimate of ``points [M, 3]``
    f32 on ``device``, summed in f64 in chunks of ``_SG_CHUNK`` points by
    ``_SG_CLUSTER_CHUNK`` clusters; valid because callers only pass points
    ≥ ~2.5h from every triangle (error O((r/d)^2), Barill et al. 2018)."""
    pts = torch.from_numpy(points).to(device)
    cent = torch.from_numpy(clus_cent).to(device)
    an = torch.from_numpy(clus_an).to(device)
    out = []
    for lo in range(0, pts.shape[0], _SG_CHUNK):
        p = pts[lo:lo + _SG_CHUNK]
        acc = torch.zeros(p.shape[0], dtype=torch.float64, device=device)
        for k0 in range(0, cent.shape[0], _SG_CLUSTER_CHUNK):
            acc += _dipole_terms(p, cent[k0:k0 + _SG_CLUSTER_CHUNK],
                                 an[k0:k0 + _SG_CLUSTER_CHUNK]
                                 ).double().sum(dim=1)
        out.append(acc / (4.0 * math.pi))
    return torch.cat(out).cpu().numpy()


def _flood_fill(state3: np.ndarray, free: np.ndarray) -> None:
    """Give every ``free`` voxel still at 2 the sign of a face-adjacent
    decided voxel, repeatedly (at most 64 sweeps), in place: band voxels
    carry 2 and never propagate, and ``min`` is conflict-free since a
    connected free region has one sign."""
    for _ in range(64):
        unknown = free & (state3 == 2)
        if not unknown.any():
            break
        best = np.full(state3.shape, 2, dtype=np.int8)
        for ax in range(3):
            sl_lo = [slice(None)] * 3
            sl_hi = [slice(None)] * 3
            sl_lo[ax] = slice(1, None)
            sl_hi[ax] = slice(None, -1)
            np.minimum(best[tuple(sl_lo)], state3[tuple(sl_hi)],
                       out=best[tuple(sl_lo)])
            np.minimum(best[tuple(sl_hi)], state3[tuple(sl_lo)],
                       out=best[tuple(sl_hi)])
        adopt = unknown & (best < 2)
        if not adopt.any():
            break
        state3[adopt] = best[adopt]


def build_sign_grid(triangles: np.ndarray, device="cpu") -> dict:
    """Per-voxel inside/outside classification of the space around an STL
    surface: int8 ``state`` per voxel (flat), 0 = outside, 1 = inside,
    2 = near-surface (query needs exact winding), with the f32 ``origin``
    and ``inv_h`` and the int32 ``dims`` a query indexes it by — the JAX
    package's tables bit for bit.

    Voxels are sized so a triangle reaches at most one voxel beyond its
    centroid's (``h ≥ 2·r_max``): any voxel NOT 26-adjacent to a
    centroid-occupied voxel is surface-free, hence uniformly inside or
    outside.  Far free voxels (Chebyshev ≥ ``_SG_SEED_CD+1`` from
    occupancy) are classified by the cluster-dipole winding sum on
    ``device``; the remaining free shell inherits its sign by flood fill
    through face-adjacent free voxels.  Free voxels unreachable from any
    seed stay ``2``.  A finer grid whose occupancy marks every voxel a
    triangle's bounding box touches then thins the band, where it is
    meaningfully finer."""
    tris = np.asarray(triangles, dtype=np.float64)
    cent = tris.mean(axis=1)
    area_n = 0.5 * np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    r_max = float(np.linalg.norm(tris - cent[:, None, :], axis=-1).max())
    lo_c = cent.min(axis=0)
    extent = np.maximum(cent.max(axis=0) - lo_c, 1e-12)
    h = max(2.0 * r_max, float(extent.max()) / 256.0, 1e-12)
    while np.prod(np.ceil(extent / h).astype(np.int64) + 3) > _SG_MAX_VOX:
        h *= 1.26
    dims = np.ceil(extent / h).astype(np.int64) + 3   # +1 round, +2 pad rings
    origin = lo_c - h

    cc = np.floor((cent - origin) / h).astype(np.int64)
    occ3 = np.zeros(dims, dtype=bool)
    occ3[cc[:, 0], cc[:, 1], cc[:, 2]] = True
    band = _dilate_box(occ3)                    # voxels a triangle can touch
    nearz = band
    for _ in range(_SG_SEED_CD - 1):
        nearz = _dilate_box(nearz)
    seeds3 = ~_dilate_box(nearz)                # cd ≥ _SG_SEED_CD+1 from occ

    # per-occupied-voxel dipole clusters (area-weighted centroid + summed
    # area normals)
    n_vox = int(np.prod(dims))
    flat = (cc[:, 0] * dims[1] + cc[:, 1]) * dims[2] + cc[:, 2]
    cw = np.maximum(np.abs(area_n).sum(axis=1), 1e-30)
    sums = np.zeros((n_vox, 3))
    wsum = np.zeros(n_vox)
    an_sum = np.zeros((n_vox, 3))
    np.add.at(sums, flat, cent * cw[:, None])
    np.add.at(wsum, flat, cw)
    np.add.at(an_sum, flat, area_n)
    occ_ids = np.nonzero(wsum > 0)[0]
    clus_cent = (sums[occ_ids] / wsum[occ_ids, None]).astype(np.float32)
    clus_an = an_sum[occ_ids].astype(np.float32)

    # classify the far seeds by the dipole sweep
    state3 = np.full(tuple(dims), 2, dtype=np.int8)
    seed_idx = np.nonzero(seeds3.ravel())[0]
    if seed_idx.size:
        si = np.stack(np.unravel_index(seed_idx, dims), axis=1)
        pts = (origin + (si + 0.5) * h).astype(np.float32)
        w = _dipole_winding(pts, clus_cent, clus_an, device)
        state3.ravel()[seed_idx] = (w > 0.5).astype(np.int8)

    # flood-fill the free shell between seeds and band (6-connectivity)
    _flood_fill(state3, ~band)

    # ---- fine level: AABB-rasterized occupancy shrinks the near band ----
    # the surface lies inside the union of triangle AABBs, so a face
    # shared by two free fine voxels is provably not crossed; fine voxels
    # whose centre lies in a decided coarse voxel inherit its sign, the
    # rest flood-fill from them
    tri_lo = tris.min(axis=1)
    tri_hi = tris.max(axis=1)
    max_ext = float((tri_hi - tri_lo).max())
    h_f = max(float(extent.max()) / 124.0, max_ext / 6.0, 1e-12)
    while np.prod(np.ceil(extent / h_f).astype(np.int64) + 3) > _SG_MAX_VOX:
        h_f *= 1.26
    if h_f < 0.5 * h:  # only pays when meaningfully finer than the coarse grid
        dims_f = np.ceil(extent / h_f).astype(np.int64) + 3
        origin_f = lo_c - h_f
        lo_v = np.clip(np.floor((tri_lo - origin_f) / h_f).astype(np.int64),
                       0, dims_f - 1)
        hi_v = np.clip(np.floor((tri_hi - origin_f) / h_f).astype(np.int64),
                       0, dims_f - 1)
        span = hi_v - lo_v
        occ_f = np.zeros(tuple(dims_f), dtype=bool)
        smax = span.max(axis=0)
        for dx in range(int(smax[0]) + 1):
            mx = span[:, 0] >= dx
            for dy in range(int(smax[1]) + 1):
                mxy = mx & (span[:, 1] >= dy)
                for dz in range(int(smax[2]) + 1):
                    m = mxy & (span[:, 2] >= dz)
                    if m.any():
                        occ_f[lo_v[m, 0] + dx, lo_v[m, 1] + dy,
                              lo_v[m, 2] + dz] = True

        def axis_map(n_f, ax):
            c = origin_f[ax] + (np.arange(n_f) + 0.5) * h_f
            return np.clip(np.floor((c - origin[ax]) / h).astype(np.int64),
                           0, dims[ax] - 1)
        ix, iy, iz = (axis_map(dims_f[0], 0), axis_map(dims_f[1], 1),
                      axis_map(dims_f[2], 2))
        state_f = state3[ix[:, None, None], iy[None, :, None],
                         iz[None, None, :]].copy()
        state_f[occ_f] = 2
        _flood_fill(state_f, ~occ_f)

        state3, origin, h, dims = state_f, origin_f, h_f, dims_f
        n_vox = int(np.prod(dims))

    return {"state": state3.ravel(),
            "origin": origin.astype(np.float32),
            "inv_h": np.float32(1.0 / h),
            "dims": dims.astype(np.int32),
            "n_near_vox": int((state3 == 2).sum()), "n_vox": n_vox}


class GeometrySTL3D(GeometryObject):
    __short_description__ = "usage of STL files for geometries (3D)"

    def __init__(self, name: str, keep_inside: bool, path_stl_file: str,
                 refine: bool = False, min_refinement_level: int = None,
                 reduce_by=0, device=None):
        """
        :param path_stl_file: binary or ASCII STL file of a closed surface
        :param reduce_by: fraction of triangles to remove by vertex
            clustering (0 <= reduce_by < 1); the reduced surface is also
            written beside the input file
        :param device: torch device of the construction-time dipole sweep
            of the sign grid; None means ``cuda``
        """
        if reduce_by < 0:
            logger.warning(f"Found invalid negative value for 'reduce_by' of {reduce_by}. "
                           f"Disabling compression.")
            reduce_by = 0
        elif reduce_by >= 1:
            logger.warning(f"Found invalid value for 'reduce_by' of {reduce_by}. Compression "
                           f"factor needs to be 0 <= reduce_by < 1. Correcting to 0.99.")
            reduce_by = 0.99

        super().__init__(name, keep_inside, refine, min_refinement_level)
        self._type = "STL"
        self._pwd = path_stl_file
        self._triangles = read_stl(path_stl_file)

        if reduce_by > 0:
            self._triangles = decimate(self._triangles, reduce_by)
            reduced_path = ".".join([self._pwd.split(".stl")[0], "_reduced_by_Scube.stl"])
            logger.info(f"Saving reduced STL file to disk: {reduced_path}")
            write_stl(reduced_path, self._triangles)

        pts = self._triangles.reshape(-1, 3)
        self._lower_bound = pts.min(axis=0)
        self._upper_bound = pts.max(axis=0)
        self._main_width = float(np.max(np.abs(self._upper_bound
                                               - self._lower_bound)))
        self._center = (self._lower_bound + self._upper_bound) / 2.0
        self._check_geometry()

        # above _FW_MIN_TRIS the exact sweep is O(M·T) per near-band point;
        # the two-level structure answers the near field exactly and the
        # far field by cluster dipoles
        self._fw = (build_fast_winding(self._triangles)
                    if self._triangles.shape[0] >= _FW_MIN_TRIS else None)
        self._sg = build_sign_grid(self._triangles, resolve_device(device))
        logger.info(
            f"STL sign grid for geometry {name}: "
            f"{self._sg['n_near_vox']}/{self._sg['n_vox']} voxels need "
            f"exact winding evaluation.")
        # host tables of the exact route: the f32 vertex arrays
        self._exact = ({} if self._fw is not None else {
            f"v{i}": np.ascontiguousarray(self._triangles[:, i],
                                          dtype=np.float32)
            for i in range(3)})
        # bytes of every table a query reads (the JAX package's count):
        # the engine routes a geometry above its budget
        # (``engine/tree._FUSED_GEO_BYTES``) through host-built nodes
        self._device_table_bytes = int(
            sum(int(v.nbytes) for v in self._sg.values()
                if hasattr(v, "nbytes"))
            + sum(int(a.nbytes) for a in (self._fw or self._exact).values()))
        self._device_tables = {}

    def _tables(self, device: torch.device) -> dict:
        """The query tables on ``device``, copied at first use there."""
        key = str(device)
        tab = self._device_tables.get(key)
        if tab is None:
            def put(a):
                return torch.from_numpy(np.asarray(a)).to(device)
            sg = self._sg
            tab = {"state": put(sg["state"]), "origin": put(sg["origin"]),
                   "inv_h": put(sg["inv_h"]),
                   "dims": put(sg["dims"].astype(np.int64)),
                   "dims_f": put(sg["dims"].astype(np.float32)),
                   "lower": put(self._lower_bound.astype(np.float32)),
                   "upper": put(self._upper_bound.astype(np.float32))}
            if self._fw is not None:
                fw = {k: put(v) for k, v in self._fw.items()}
                for k in ("cell_tris", "resid", "clus_cell", "dims"):
                    fw[k] = fw[k].to(torch.int64)
                rng = torch.arange(-_FW_RADIUS, _FW_RADIUS + 1, device=device)
                fw["offs"] = torch.stack(torch.meshgrid(rng, rng, rng,
                                                        indexing="ij"),
                                         dim=-1).reshape(-1, 3)
                tab["fw"] = fw
            else:
                tab.update({k: put(v) for k, v in self._exact.items()})
            self._device_tables[key] = tab
        return tab

    def _winding(self, points: torch.Tensor, count: torch.Tensor,
                 tab: dict) -> torch.Tensor:
        """Winding number ``[M]`` f32 of the first ``count`` (a device
        int32) of ``points [M, 3]`` f32, 0 at the rest, by the geometry's
        route: the exact sweep (the hand-written kernel on the card, which
        reads the count there), or the fast winding number, plain PyTorch
        over the first ``count`` rows, which it reads back (its tables, from
        ``_FW_MIN_TRIS`` triangles, exceed the engine's
        ``_FUSED_GEO_BYTES``, so it never runs inside a loop's window)."""
        if "fw" not in tab:
            return winding.winding_number(points, tab["v0"], tab["v1"],
                                          tab["v2"], count)
        n = int(count)
        w = torch.zeros(points.shape[0], dtype=torch.float32,
                        device=points.device)
        w[:n] = _fast_winding(points[:n], tab["fw"])
        return w

    def _inside(self, points):
        """The sign-grid inside test (the JAX package's
        ``_make_sign_mask_fn``) in f32: one int8 lookup per point (0 outside
        the grid), the near-band points (state 2) compacted in ascending
        index to the front of a batch of all ``M`` rows, their count kept
        on the device, through :meth:`_winding` and ``w > 0.5``, then the
        f32 bounding-box test.  Nothing waits for the device (no
        ``nonzero``), so the test runs inside a captured CUDA graph."""
        pts = points.to(torch.float32)
        tab = self._tables(pts.device)
        cell = torch.floor((pts - tab["origin"]) * tab["inv_h"])
        in_grid = ((cell >= 0) & (cell < tab["dims_f"])).all(-1)
        # voxel 0 for the points outside the grid (NaN included), whose
        # state is 0 whatever the voxel holds
        cell = torch.where(in_grid[:, None], cell, 0.0).to(torch.int64)
        dims = tab["dims"]
        flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        state = torch.where(in_grid, tab["state"][flat],
                            torch.zeros((), dtype=torch.int8,
                                        device=pts.device))
        near = state == 2
        m = pts.shape[0]
        # the near rows' places in the compacted batch; the others write
        # to the spare last slot
        pos = torch.cumsum(near, 0) - 1
        rows = torch.zeros(m + 1, dtype=torch.int64, device=pts.device)
        rows[torch.where(near, pos, m)] = torch.arange(m, device=pts.device)
        count = near.sum(dtype=torch.int32).reshape(1)
        w = self._winding(pts[rows[:m]], count, tab)
        inside = torch.where(near, w[pos.clamp(min=0)] > 0.5, state == 1)
        in_box = ((pts >= tab["lower"]) & (pts <= tab["upper"])).all(-1)
        return inside & in_box

    def bounding_box(self):
        return self._lower_bound, self._upper_bound

    def _trace_constants(self):
        # every table is made from the (possibly decimated) triangles
        return [self._triangles]

    def __getstate__(self):
        """Checkpoints pickle the geometry with its host tables only: the
        device copies are made again at first use."""
        state = self.__dict__.copy()
        state["_device_tables"] = {}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._device_tables = {}

    def _check_geometry(self) -> None:
        if self._triangles.shape[0] == 0:
            raise ValueError(f"STL file {self._pwd} contains no triangles.")
        if self._triangles.shape[0] > 5e4:
            logger.warning(
                f"STL file for geometry {self.name} has {self._triangles.shape[0]} "
                f"triangles. Consider using 'reduce_by' to decimate it for faster checks.")
        # watertightness diagnostic: every edge of a closed manifold appears twice
        verts = self._triangles.reshape(-1, 3)
        _, inv = np.unique(np.round(verts, decimals=9), axis=0, return_inverse=True)
        f = inv.reshape(-1, 3)
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        _, counts = np.unique(edges, axis=0, return_counts=True)
        if not np.all(counts == 2):
            logger.warning(
                f"STL surface for geometry {self.name} is not closed/manifold. The "
                f"winding-number inside-test degrades gracefully, but results near the "
                f"defects may be inaccurate.")

    @property
    def device_table_bytes(self) -> int:
        return self._device_table_bytes

    @property
    def type(self) -> str:
        return self._type

    @property
    def main_width(self) -> float:
        return self._main_width

    @property
    def center(self):
        return self._center

    @property
    def triangles(self) -> np.ndarray:
        return self._triangles
