"""The grid kNN's fused scoring and selection (``ops/grid_select.py``)
against the JAX package's functions.

On the CPU the wrapper runs its plain version, which must equal, on the
same seeded inputs, what the JAX package's XLA programs compute (run on
CPU XLA):

- ``grid_select_dilated`` against ``_dilated_select`` with sorted rows
  (the single-device layout) and unsorted rows (a shard's: each cell's
  3^d slabs concatenated), ``(sq, idx)`` bitwise, and the slots;
- ``grid_select_blocked`` (through ``_blocked_topk``) against
  ``_grid_query_kernel`` at radius 1, and against the ring's composition
  at radius 4 (``_grid_neighborhood`` + ``cell_pts[flat]`` delta-sum +
  ``_topk_canonical``);
- at d = 2 and 3, on random clouds with a void (queries up to 0.3 outside
  the bbox, rows with pad slots and the sentinel row) and on lattices
  (a distance tie at every k-th place); on a pad-heavy layout of capacity
  4, where ``k + 8`` is above the row width.

The mask leaves rows out with the filler ``(+inf, 0, 0)``; the CPU wrapper
counts no launch; bad input raises.  The blocked kernel shares a staged
slab between consecutive rows with equal neighbourhoods: rows whose centre
slabs (home cells) are equal have equal rows of ``_grid_neighborhood``, at
radius 1 and 4, for anchors inside the grid, on cell faces and outside the
bbox, and the port's cell ids are the JAX package's.  The CUDA kernel is
held against the plain version on the card (``cuda`` marker; skips here).
"""
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sparsespatialsampling_tpu.ops import knn as jknn  # noqa: E402
from sparsespatialsampling_torch import _build  # noqa: E402
from sparsespatialsampling_torch.ops import grid_select as gs  # noqa: E402
from sparsespatialsampling_torch.ops import knn as tknn  # noqa: E402

_jax_dilated = jax.jit(jknn._dilated_select,
                       static_argnames=("k", "sorted_rows"))


def _random_cloud(d, rng):
    pts = rng.uniform(0, 1, size=(3000 if d == 2 else 2500, d))
    pts = pts[np.linalg.norm(pts - 0.5, axis=1) > 0.12]
    return pts, rng.uniform(-0.3, 1.3, size=(300, d))


def _lattice_cloud(d, rng):
    """The unit lattice (48² or 12³ points) with queries on lattice points,
    where the k-th distance (k = 8 / 26) ties the next, and some outside."""
    n = 48 if d == 2 else 12
    xs = np.arange(n, dtype=np.float64)
    pts = np.stack(np.meshgrid(*([xs] * d), indexing="ij"), -1).reshape(-1, d)
    q = np.concatenate([pts[rng.choice(pts.shape[0], 250, replace=False)],
                        rng.uniform(-3.0, n + 2.0, (50, d)).round()])
    return pts, q


CLOUDS = {"random": _random_cloud, "lattice": _lattice_cloud}


@pytest.fixture(params=[(d, c) for d in (2, 3) for c in CLOUDS],
                ids=[f"{d}d-{c}" for d in (2, 3) for c in CLOUDS])
def layout(request, monkeypatch):
    """The JAX package's grid of a seeded cloud (``GRID_MIN_POINTS``
    lowered to 1000 on both packages), its arrays in numpy, centred f32
    queries, k and the port's index of the same cloud."""
    d, cloud = request.param
    monkeypatch.setattr(jknn.KNNIndex, "GRID_MIN_POINTS", 1000)
    monkeypatch.setattr(tknn.KNNIndex, "GRID_MIN_POINTS", 1000)
    pts, q = CLOUDS[cloud](d, np.random.default_rng(d))
    j = jknn.KNNIndex(pts)
    t = tknn.KNNIndex(pts, device="cpu")
    g = {key: np.asarray(v) for key, v in j._grid.items()
         if key not in ("C", "_dil_keep")}
    g["C"] = int(j._grid["C"])
    g["cloud"] = cloud
    qc = (q - j._shift).astype(np.float32)
    return g, qc, (8 if d == 2 else 26), j.n_points, t


def _t(a):
    return torch.from_numpy(np.array(a))


def _dil_flat(g, qc):
    return np.asarray(jknn._grid_query_margin(
        jnp.asarray(qc), g["origin"], g["inv_h"], g["dims"])[0]).astype(
            np.int64)


@pytest.mark.parametrize("sorted_rows", [True, False],
                         ids=["sorted-rows", "unsorted-rows"])
def test_dilated_plain_matches_jax(layout, sorted_rows):
    g, qc, k, pad, _ = layout
    if sorted_rows:
        pts, cand = g["dil_pts"], g["dil_cand"]
    else:
        # a shard's rows: each cell's 3^d slabs as they come
        nb = tknn._grid_neighbor_table(
            _t(g["dims"]), g["cell_list"].shape[0] - 1).numpy()
        rows = nb.shape[0]
        pts = g["cell_pts"][nb].reshape(rows, -1)
        cand = g["cell_list"][nb].reshape(rows, -1)
    flat = _dil_flat(g, qc)
    jsq, jidx, jsel = (np.asarray(a) for a in _jax_dilated(
        jnp.asarray(qc), jnp.asarray(pts), jnp.asarray(cand),
        jnp.asarray(flat.astype(np.int32)), k=k, sorted_rows=sorted_rows))
    tsq, tidx, tsel = gs.grid_select_dilated(_t(qc), _t(pts), _t(cand),
                                             _t(flat), k, sorted_rows)
    assert tsq.dtype == torch.float32 and tidx.dtype == torch.int64
    assert tsel.dtype == torch.int32
    np.testing.assert_array_equal(tsq.numpy(), jsq)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    # slots: equal wherever they are determined (pad slots share an index)
    real = jidx != pad
    np.testing.assert_array_equal(tsel.numpy()[real], jsel[real])
    # the rows hold pad slots (index n_points, coordinates 1e15)
    assert (cand[flat] == pad).any()


def _dilated_pad_heavy(d, w, sorted_rows, seed):
    """Dilated rows of width ``w`` as a grid's are, many with fewer real
    candidates than a selection takes: row r holds 0 to w members
    (ids below 1000, distinct in a row, on a small integer lattice, the
    rest the pad index 1000 at coordinates 1e15), ascending by id with
    the pads last (sorted rows) or shuffled (a shard's); the first row is
    full and the last two have no real candidate.  200 queries, most on
    lattice points, where equal distances tie at every place, the k-th
    included."""
    rng = np.random.default_rng(seed)
    n_rows = 40
    pts = np.full((n_rows, w, d), 1e15, np.float32)
    ids = np.full((n_rows, w), 1000, np.int32)
    counts = rng.integers(0, w + 1, n_rows)
    counts[0], counts[-2:] = w, 0
    for row, m in enumerate(counts):
        ids[row, :m] = np.sort(rng.choice(1000, m, replace=False))
        pts[row, :m] = rng.integers(0, 4, (m, d))
        if not sorted_rows:
            o = rng.permutation(w)
            ids[row], pts[row] = ids[row, o], pts[row, o]
    q = np.where(rng.uniform(size=(200, 1)) < 0.8,
                 rng.integers(-1, 5, (200, d)),
                 rng.uniform(-1.0, 5.0, (200, d))).astype(np.float32)
    flat = rng.integers(0, n_rows, 200).astype(np.int64)
    return q, pts.reshape(n_rows, w * d), ids, flat, counts


@pytest.mark.parametrize("sorted_rows", [True, False],
                         ids=["sorted-rows", "unsorted-rows"])
@pytest.mark.parametrize("d,w,k", [(2, 16, 1), (2, 16, 8), (2, 16, 16),
                                   (3, 32, 1), (3, 32, 26), (3, 32, 32)],
                         ids=["2d-k1", "2d-k8", "2d-kW", "3d-k1", "3d-k26",
                              "3d-kW"])
def test_dilated_pad_heavy_matches_jax(d, w, k, sorted_rows):
    """Rows on which a selection's threshold could undercut its kk-th key:
    fewer real candidates than kk (the kk-th key a pad's 1e30-scale
    distance, pads tied at equal (sq, idx)), no real candidate at all,
    k = 1, k = W (every slot selected) and exact ties at the k-th place.
    The plain version equals the JAX package's ``_dilated_select``."""
    q, pts, ids, flat, counts = _dilated_pad_heavy(d, w, sorted_rows,
                                                   seed=10 * d + k)
    kk = k if sorted_rows else min(k + 8, w)
    # the rows the queries read include short ones and empty ones
    assert (counts[flat] < kk).any() and (counts[flat] == 0).any()
    assert (counts[flat] >= kk).any()
    jsq, jidx, jsel = (np.asarray(a) for a in _jax_dilated(
        jnp.asarray(q), jnp.asarray(pts), jnp.asarray(ids),
        jnp.asarray(flat.astype(np.int32)), k=k, sorted_rows=sorted_rows))
    tsq, tidx, tsel = gs.grid_select_dilated(_t(q), _t(pts), _t(ids),
                                             _t(flat), k, sorted_rows)
    np.testing.assert_array_equal(tsq.numpy(), jsq)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    real = jidx != 1000
    np.testing.assert_array_equal(tsel.numpy()[real], jsel[real])
    assert (~real).any() and np.isfinite(tsq.numpy()).all()
    if 1 < k < w:
        # exact ties at the k-th place, among real candidates
        g = pts.reshape(-1, w, d)[flat]
        diff = (q[:, None, :] - g).astype(np.float64)
        srt = np.sort((diff * diff).sum(-1), axis=1)
        full = counts[flat] > k
        assert (srt[full, k - 1] == srt[full, k]).any()


def _jax_blocked(queries, cell_pts, cell_list, flat, k):
    """The JAX package's blocked scoring and selection over given slabs
    ``flat [Q, R]``, as ``_grid_candidates`` and the ring compose it."""
    q = queries.shape[0]
    delta = queries[:, None, None, :] - cell_pts[flat]
    d2 = jnp.sum(delta * delta, axis=-1).reshape(q, -1)
    return jknn._topk_canonical(d2, cell_list[flat].reshape(q, -1), k)


def test_blocked_radius1_matches_grid_query_kernel(layout):
    g, qc, k, _, t = layout
    jsq, jidx, jok = (np.asarray(a) for a in jknn._grid_query_kernel(
        jnp.asarray(qc), g["cell_pts"], g["cell_list"], g["overflow"],
        g["origin"], g["inv_h"], g["dims"], k))
    tsq, tidx, tok = tknn._blocked_topk(_t(qc), t._grid, k)
    np.testing.assert_array_equal(tsq.numpy(), jsq)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tok.numpy(), jok)
    if g["cloud"] == "lattice":
        # on lattice points the k-th distance ties the (k+1)-th
        d2, _, _, _ = tknn._grid_candidates(_t(qc[:250]), t._grid, 1)
        srt = np.sort(d2.numpy(), axis=1)
        assert (srt[:, k - 1] == srt[:, k]).mean() > 0.5


def test_blocked_radius4_matches_ring_composition(layout):
    g, qc, k, pad, _ = layout
    q = qc[:96]
    flat = np.asarray(jknn._grid_neighborhood(
        jnp.asarray(q), g["cell_list"].shape[0], jnp.asarray(g["origin"]),
        jnp.asarray(g["inv_h"]), jnp.asarray(g["dims"]), radius=4)[0])
    # neighbourhoods reach past the grid: the sentinel row's pad slots
    assert (flat == g["cell_list"].shape[0] - 1).any()
    jsq, jidx, jsel = (np.asarray(a) for a in jax.jit(
        partial(_jax_blocked, k=k))(jnp.asarray(q), g["cell_pts"],
                                     g["cell_list"], jnp.asarray(flat)))
    tsq, tidx, tsel = gs.grid_select_blocked(
        _t(q), _t(g["cell_pts"]), _t(g["cell_list"]),
        _t(flat.astype(np.int64)), k)
    np.testing.assert_array_equal(tsq.numpy(), jsq)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    real = jidx != pad
    np.testing.assert_array_equal(tsel.numpy()[real], jsel[real])


def _anchors(d, where, rng):
    """Seeded anchors of a small grid (origin and cell size multiples of
    1/8, so lattice coordinates are exact in f32), several a home cell:
    inside the cells, on cell faces (bbox faces included), or outside the
    bbox.  Returns ``(anchors [n, d] f32, origin, inv_h, dims)``."""
    dims = np.array([6, 5, 4][:d])
    origin = np.array([0.125, -0.375, 0.25][:d], np.float32)
    inv_h = np.float32(4.0)
    cells = rng.integers(0, dims, (60, d))
    if where == "inside":
        t = np.repeat(cells, 5, 0) + rng.uniform(0.05, 0.95, (300, d))
    elif where == "faces":
        t = np.repeat(cells, 5, 0) + rng.uniform(0.05, 0.95, (300, d))
        on = rng.uniform(size=(300, d)) < 0.5
        t = np.where(on, rng.integers(0, dims + 1, (300, d)), t)
    else:
        t = rng.uniform(-3.0, dims + 3.0, (300, d))
        axis = rng.integers(0, d, 300)
        t[np.arange(300), axis] = np.where(
            rng.uniform(size=300) < 0.5, rng.uniform(-3.0, -0.01, 300),
            dims[axis] + rng.uniform(0.01, 3.0, 300))
        t = np.repeat(t[::5], 5, 0)
    return (origin + t / inv_h).astype(np.float32), origin, inv_h, dims


@pytest.mark.parametrize("where", ["inside", "faces", "outside"])
@pytest.mark.parametrize("radius", [1, 4])
@pytest.mark.parametrize("d", [2, 3])
def test_equal_home_cells_give_equal_neighbourhoods(d, radius, where):
    """What the blocked kernel's sharing rests on: a row of ``flat`` is a
    function of its centre slab ``flat[q, (R - 1) / 2]``, the anchor's
    clamped home cell, never the sentinel; and the port's
    ``_grid_neighborhood`` gives the JAX package's cell ids."""
    a, origin, inv_h, dims = _anchors(d, where, np.random.default_rng(
        10 * d + radius))
    n_total = int(np.prod(dims)) + 1
    flat, _ = tknn._grid_neighborhood(
        _t(a), n_total, _t(origin), torch.tensor(inv_h), _t(dims), radius)
    jflat, _ = jknn._grid_neighborhood(
        jnp.asarray(a), n_total, jnp.asarray(origin), jnp.asarray(inv_h),
        jnp.asarray(dims), radius=radius)
    flat = flat.numpy()
    np.testing.assert_array_equal(flat, np.asarray(jflat).astype(np.int64))
    r = (2 * radius + 1) ** d
    assert flat.shape == (a.shape[0], r)
    centre = flat[:, (r - 1) // 2]
    home = np.clip(np.floor((a - origin) * inv_h).astype(np.int64), 0,
                   dims - 1)
    np.testing.assert_array_equal(
        centre, np.ravel_multi_index(tuple(home.T), tuple(dims)))
    assert (centre != n_total - 1).all()
    # several rows a home cell, and each such row equal to its first
    assert np.unique(centre).size < centre.size / 2
    first = {}
    for row, c in enumerate(centre):
        np.testing.assert_array_equal(flat[row], flat[first.setdefault(c,
                                                                       row)])
    if radius == 4 or where == "outside":
        assert (flat == n_total - 1).any()


def _pad_heavy(d, c, seed):
    """A blocked layout of 40 cells of capacity ``c`` plus the all-pad
    sentinel row 40: each cell holds 0 to c members (distinct ids below
    1000, the pad index 1000 elsewhere at coordinates 1e15), and each
    query's 3^d slabs are the sentinel's seven times in ten."""
    rng = np.random.default_rng(seed)
    pts = np.full((41, c, d), 1e15, np.float32)
    ids = np.full((41, c), 1000, np.int32)
    members = rng.permutation(1000)[:40 * c].reshape(40, c)
    for cell, m in enumerate(rng.integers(0, c + 1, 40)):
        pts[cell, :m] = rng.uniform(0.0, 1.0, (m, d))
        ids[cell, :m] = members[cell, :m]
    r = 3 ** d
    flat = np.where(rng.uniform(size=(200, r)) < 0.7, 40,
                    rng.integers(0, 40, (200, r))).astype(np.int64)
    q = rng.uniform(-2.0, 3.0, (200, d)).astype(np.float32)
    return q, pts, ids, flat


@pytest.mark.parametrize("d,k", [(2, 30), (3, 104)], ids=["2d-k30", "3d-k104"])
def test_blocked_pad_heavy_small_capacity(d, k):
    """Capacity 4: R·C (36 / 108) is below k + 8, so every slot is
    selected; pads rank by their finite 1e30-scale distances, and their
    ties at equal (sq, idx) keep the lower slot first."""
    q, pts, ids, flat = _pad_heavy(d, 4, seed=d)
    assert k + 8 > flat.shape[1] * 4
    jsq, jidx, jsel = (np.asarray(a) for a in jax.jit(
        partial(_jax_blocked, k=k))(jnp.asarray(q), jnp.asarray(pts),
                                     jnp.asarray(ids), jnp.asarray(flat)))
    tsq, tidx, tsel = gs.grid_select_blocked(_t(q), _t(pts), _t(ids),
                                             _t(flat), k)
    np.testing.assert_array_equal(tsq.numpy(), jsq)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    pads = tidx.numpy() == 1000
    assert pads.any() and np.isfinite(tsq.numpy()).all()
    # among the pads of a row, the slots ascend
    sel = np.where(pads, tsel.numpy(), -1)
    for row in range(sel.shape[0]):
        s = sel[row][sel[row] >= 0]
        assert (np.diff(s) > 0).all()


@pytest.mark.parametrize("d", [2, 3])
def test_mask_leaves_rows_out_with_the_filler(d):
    q, pts, ids, flat = _pad_heavy(d, 16, seed=10 + d)
    k = 8 if d == 2 else 26
    mask = torch.from_numpy(np.random.default_rng(d).uniform(size=200) < 0.5)
    args = (_t(q), _t(pts), _t(ids), _t(flat), k)
    whole = gs.grid_select_blocked(*args)
    masked = gs.grid_select_blocked(*args, mask=mask)
    assert 0 < int(mask.sum()) < 200
    for a, b in zip(whole, masked):
        assert a.dtype == b.dtype
        assert torch.equal(a[mask], b[mask])
    assert torch.isinf(masked[0][~mask]).all()
    assert not masked[1][~mask].any() and not masked[2][~mask].any()


def test_masked_ring_rows_are_not_exact(monkeypatch):
    """``_blocked_topk``'s ``mask``: the marked rows as without it, the
    others never proven exact."""
    monkeypatch.setattr(tknn.KNNIndex, "GRID_MIN_POINTS", 1000)
    pts, q = _random_cloud(3, np.random.default_rng(4))
    t = tknn.KNNIndex(pts, device="cpu")
    qt = _t((q - t._shift).astype(np.float32))
    mask = torch.arange(qt.shape[0]) % 2 == 0
    sq, idx, ok = tknn._blocked_topk(qt, t._grid, 26, 4)
    msq, midx, mok = tknn._blocked_topk(qt, t._grid, 26, 4, mask=mask)
    assert torch.equal(msq[mask], sq[mask])
    assert torch.equal(midx[mask], idx[mask])
    assert torch.equal(mok[mask], ok[mask]) and ok[mask].any()
    assert not mok[~mask].any()


def test_cpu_wrapper_is_plain_and_counts_no_launch():
    q, pts, ids, flat = _pad_heavy(3, 16, seed=7)
    before = gs.launches
    a = gs.grid_select_blocked(_t(q), _t(pts), _t(ids), _t(flat), 26)
    b = gs.grid_select_blocked_plain(_t(q), _t(pts), _t(ids), _t(flat), 26)
    rows = _t(pts.reshape(41, -1))
    c = gs.grid_select_dilated(_t(q), rows, _t(ids), _t(flat[:, 0]), 8)
    e = gs.grid_select_dilated_plain(_t(q), rows, _t(ids), _t(flat[:, 0]), 8)
    assert gs.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a + c, b + e))


def _bad_inputs():
    q, pts, ids, flat = (_t(a) for a in _pad_heavy(3, 16, seed=8))
    rows = pts.reshape(41, -1)
    blocked = partial(gs.grid_select_blocked, q, pts, ids, flat)
    return {
        "queries-dtype": (lambda: gs.grid_select_blocked(
            q.double(), pts, ids, flat, 8), TypeError),
        "cand-dtype": (lambda: gs.grid_select_blocked(
            q, pts, ids.long(), flat, 8), TypeError),
        "mask-dtype": (lambda: blocked(8, mask=torch.ones(200)), TypeError),
        "flat-rank": (lambda: gs.grid_select_blocked(q, pts, ids, flat[:, 0],
                                                     8), ValueError),
        "mask-shape": (lambda: blocked(8, mask=torch.ones(3, dtype=bool)),
                       ValueError),
        "dilated-width": (lambda: gs.grid_select_dilated(
            q, rows[:, :-1], ids, flat[:, 0], 8), ValueError),
        "four-dims": (lambda: gs.grid_select_dilated(
            torch.zeros(200, 4), torch.zeros(41, 64), ids, flat[:, 0], 8),
            ValueError),
        "k-zero": (lambda: blocked(0), ValueError),
        "k-above-width": (lambda: gs.grid_select_dilated(
            q, rows, ids, flat[:, 0], 17), ValueError),
        "kk-above-queue": (lambda: blocked(250), ValueError),
        "devices": (lambda: gs.grid_select_blocked(
            q, pts, ids, flat.to("meta"), 8), ValueError),
        "no-kernel-device": (lambda: gs.grid_select_dilated(
            q.to("meta"), rows.to("meta"), ids.to("meta"),
            flat[:, 0].to("meta"), 8), RuntimeError),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_rejects_bad_input(case):
    call, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        call()


class _CudaStandIn:
    """Quacks like a contiguous CUDA tensor without needing a card."""
    device = torch.device("cuda")
    is_cuda = True

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    def plain_called(*_, **__):
        raise AssertionError("plain version used for a CUDA tensor")
    for name in ("grid_select_dilated_plain", "grid_select_blocked_plain"):
        monkeypatch.setattr(gs, name, plain_called)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(gs, "_entries", {})
    monkeypatch.setattr(_build, "_library_path",
                        lambda src: Path("/nonexistent") / src.name)
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    before = gs.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        gs.grid_select_blocked(
            _CudaStandIn((8, 3), f32), _CudaStandIn((5, 32, 3), f32),
            _CudaStandIn((5, 32), i32), _CudaStandIn((8, 27), i64), 26,
            mask=_CudaStandIn((8,), torch.bool))
    with pytest.raises(RuntimeError, match="nvcc"):
        gs.grid_select_dilated(
            _CudaStandIn((8, 3), f32), _CudaStandIn((5, 384 * 3), f32),
            _CudaStandIn((5, 384), i32), _CudaStandIn((8,), i64), 26)
    assert gs.launches == before


def test_build_covers_the_headers(monkeypatch):
    """The kernel sources include ``csrc/warp_select.cuh``: an edited
    header must give a new library name."""
    headers = sorted(_build.SOURCE_DIR.glob("*.cuh"))
    assert "warp_select.cuh" in {h.name for h in headers}
    src = _build.SOURCE_DIR / "grid_select.cu"
    assert '#include "warp_select.cuh"' in src.read_text()
    name = _build._library_path(src)
    orig = Path.read_bytes

    def edited(path):
        data = orig(path)
        return data + b"\n" if path.suffix == ".cuh" else data
    monkeypatch.setattr(Path, "read_bytes", edited)
    assert _build._library_path(src) != name


def _main_order(index, n_cells, rng):
    """Ring rows in the main path's order: each of ``n_cells`` seeded cells
    (level 6 or 7 of the domain's 2.2 width) beside the cloud's hole, its
    centre then its 8 prospective children's centres, consecutive."""
    dirs = np.stack(np.meshgrid(*([[-1.0, 1.0]] * 3), indexing="ij"),
                    -1).reshape(-1, 3)
    rows = []
    for _ in range(n_cells):
        h = 2.2 / 2.0 ** rng.integers(6, 8)
        ang, rad = rng.uniform(0, 2 * np.pi), rng.uniform(0.05, 0.07)
        p = np.array([0.2 + rad * np.cos(ang), 0.2 + rad * np.sin(ang),
                      rng.uniform(0.0, 0.41)])
        centre = (np.floor(p / h) + 0.5) * h
        rows.append(centre)
        rows.extend(centre + dirs * 0.25 * h)
    return index._queries_f32(np.asarray(rows) - index._shift)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The kernel against its plain version at the ``grid_select``,
    ``shard_grid_select`` and ``ring_select`` shapes: a 3D cloud's dilated
    rows [65536, W] k=26, a shard's unsorted rows of its 27 slabs [65536,
    27·C] k=26 (the k + 8 slack), a 2D cloud's dilated rows [50000, W]
    k=8, 1024 radius-4 rows in random order, half of them masked, and
    2,304 rows in the main path's order (256 cells beside the cloud's
    hole, each cell's 9 centres consecutive), whole and with a quarter of
    them masked, which cuts runs of rows that share a home cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    xyz = rng.uniform([0.0, 0.0, 0.0], [2.2, 0.41, 0.41], (560_000, 3))
    pts = xyz[np.linalg.norm(xyz[:, :2] - 0.2, axis=1) > 0.05][:500_000]
    index = tknn.KNNIndex(pts, device="cuda")
    g = index._grid
    q = index._queries_f32(rng.uniform([0.0, 0.0, 0.0], [2.2, 0.41, 0.41],
                                       (65536, 3)) - index._shift)
    flat = tknn._grid_query_margin(q, g["origin"], g["inv_h"], g["dims"])[0]
    before = gs.launches
    args = (q, g["dil_pts"], g["dil_cand"], flat, 26)
    got, ref = gs.grid_select_dilated(*args), gs.grid_select_dilated_plain(
        *args)
    nb = tknn._grid_neighbor_table(g["dims"], g["cell_list"].shape[0] - 1)
    args = (q, g["cell_pts"][nb].reshape(nb.shape[0], -1).contiguous(),
            g["cell_list"][nb].reshape(nb.shape[0], -1).contiguous(), flat,
            26, False)
    got += gs.grid_select_dilated(*args)
    ref += gs.grid_select_dilated_plain(*args)
    xy = rng.uniform([-0.5, -0.5], [1.5, 0.5], (280_000, 2))
    xy = xy[np.linalg.norm(xy - [0.2, 0.0], axis=1) > 0.05][:250_000]
    index2 = tknn.KNNIndex(xy, device="cuda")
    g2 = index2._grid
    q2 = index2._queries_f32(rng.uniform([-0.5, -0.5], [1.5, 0.5],
                                         (50000, 2)) - index2._shift)
    args = (q2, g2["dil_pts"], g2["dil_cand"], tknn._grid_query_margin(
        q2, g2["origin"], g2["inv_h"], g2["dims"])[0], 8)
    got += gs.grid_select_dilated(*args)
    ref += gs.grid_select_dilated_plain(*args)

    def flat4(qs):
        return tknn._grid_neighborhood(qs, g["cell_list"].shape[0],
                                       g["origin"], g["inv_h"], g["dims"],
                                       4)[0]
    mq = _main_order(index, 256, rng)
    centre = flat4(mq)[:, 364]
    assert bool((centre[1:] == centre[:-1]).any())  # runs of a home cell
    for qs, mask in ((q[:1024], torch.from_numpy(
                          rng.uniform(size=1024) < 0.5).cuda()),
                     (mq, None),
                     (mq, torch.from_numpy(
                         rng.uniform(size=mq.shape[0]) >= 0.25).cuda())):
        args = (qs, g["cell_pts"], g["cell_list"], flat4(qs), 26, mask)
        got += gs.grid_select_blocked(*args)
        ref += gs.grid_select_blocked_plain(*args)
    torch.cuda.synchronize()
    assert gs.launches == before + 6
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
