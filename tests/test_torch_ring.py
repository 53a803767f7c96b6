"""The port's blocked grid layout and ring rescue against the JAX package.

- ``_grid_neighborhood`` at radius 1 and 4, anchors inside and outside the
  grid's bbox: the same flat cell ids, bitwise the same margins.
- ``_blocked_topk`` (the blocked candidates, ``_topk_canonical`` and the
  exactness test) on lattices, where every k boundary falls inside a
  distance tie: ``(sq, idx, ok)`` bitwise equal to the JAX functions, and
  no +inf reaches the selection from the 1e15 pad slots.
- ``KNNIndex`` without a dilated layout (``DIL_MAX_BYTES = 0`` here,
  ``S3_TPU_DIL_MAX_BYTES=0`` there): the same answers and fallback counts.
- The fused epoch's packed ``[M, 4]`` against the JAX ``_epoch_fn`` on the
  same cells of hole-heavy clouds, with the full-scan rescue off and on.
- Whole grids of the port's host loop (``SamplingTree.DEVICE_LOOP =
  False``) against the JAX host loop (``S3_TPU_DEVICE_LOOP=0``): the
  same cells, iterations and count of cells escalated to the host.
- The host loop's grid through the ring and the rescue against the grid
  whose bad cells all take the full scan: the same cells and metric
  trace.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sparsespatialsampling_tpu import CubeGeometry as JCube  # noqa: E402
from sparsespatialsampling_tpu import SphereGeometry as JSphere  # noqa: E402
from sparsespatialsampling_tpu.engine import tree as jtree  # noqa: E402
from sparsespatialsampling_tpu.ops import knn as jknn  # noqa: E402
from sparsespatialsampling_torch import CubeGeometry as TCube  # noqa: E402
from sparsespatialsampling_torch import SphereGeometry as TSphere  # noqa: E402
from sparsespatialsampling_torch.engine import tree as ttree  # noqa: E402
from sparsespatialsampling_torch.ops import knn as tknn  # noqa: E402


def _grid_pts(monkeypatch):
    monkeypatch.setattr(jknn.KNNIndex, "GRID_MIN_POINTS", 1000)
    monkeypatch.setattr(tknn.KNNIndex, "GRID_MIN_POINTS", 1000)


def _lattice(d):
    """Unit lattice, 64² in 2D and 16³ in 3D: a query at a lattice point
    has its k-th neighbour (k = 8 / 26) inside a tie of equal distances."""
    xs = np.arange(64 if d == 2 else 16, dtype=np.float64)
    return np.stack(np.meshgrid(*([xs] * d), indexing="ij"),
                    -1).reshape(-1, d)


def _pair(pts, vals=None):
    j = jknn.KNNIndex(pts, values=vals)
    t = tknn.KNNIndex(pts, values=vals, device="cpu")
    return j, t


@pytest.mark.parametrize("radius", [1, 4])
@pytest.mark.parametrize("d", [2, 3])
def test_grid_neighborhood_matches_jax(monkeypatch, d, radius):
    _grid_pts(monkeypatch)
    rng = np.random.default_rng(20 + d)
    j, t = _pair(rng.uniform(0, 1, size=(3000, d)))
    jg, tg = j._grid, t._grid
    # anchors inside the bbox and up to a third of it outside
    anchors = (rng.uniform(-0.3, 1.3, size=(400, d))
               - j._shift).astype(np.float32)
    n_total = int(jg["cell_list"].shape[0])
    nbhd = jax.jit(jknn._grid_neighborhood, static_argnums=(1, 5))
    jflat, jmargin = (np.asarray(a) for a in nbhd(
        jnp.asarray(anchors), n_total, jg["origin"], jg["inv_h"],
        jg["dims"], radius))
    tflat, tmargin = tknn._grid_neighborhood(
        torch.from_numpy(anchors), n_total, tg["origin"], tg["inv_h"],
        tg["dims"], radius)
    assert tflat.shape == ((400, (2 * radius + 1) ** d))
    np.testing.assert_array_equal(tflat.numpy(), jflat)
    np.testing.assert_array_equal(tmargin.numpy(), jmargin)
    # both the sentinel row and real cells are exercised
    assert (jflat == n_total - 1).any() and (jflat < n_total - 1).any()


def _jax_blocked(queries, cell_pts, cell_list, overflow, origin, inv_h,
                 dims, k, radius):
    """The JAX package's blocked query at any radius, as its ring kernel
    (``fn_grid_ring``) composes it."""
    flat, margin_sq = jknn._grid_neighborhood(
        queries, cell_list.shape[0], origin, inv_h, dims, radius=radius)
    q = queries.shape[0]
    delta = queries[:, None, None, :] - cell_pts[flat]
    d2 = jnp.sum(delta * delta, axis=-1).reshape(q, -1)
    sq, idx, _ = jknn._topk_canonical(d2, cell_list[flat].reshape(q, -1), k)
    ok = ((sq.max(axis=1) <= margin_sq)
          & ~jknn._overflow_contaminated(queries, overflow[flat],
                                         sq.max(axis=1), origin, inv_h, dims,
                                         radius=radius))
    return sq, idx, ok, d2


@pytest.mark.parametrize("radius", [1, 4])
@pytest.mark.parametrize("d", [2, 3])
def test_blocked_topk_on_lattice_ties(monkeypatch, d, radius):
    _grid_pts(monkeypatch)
    pts = _lattice(d)
    k = 8 if d == 2 else 26
    j, t = _pair(pts)
    jg, tg = j._grid, t._grid
    # lattice points, the grid's corners among them (neighbourhoods that
    # reach past the grid read the all-pad sentinel row)
    rng = np.random.default_rng(5)
    pick = np.concatenate([[0, pts.shape[0] - 1],
                           rng.choice(pts.shape[0], 126, replace=False)])
    qc = (pts[pick] - j._shift).astype(np.float32)
    fn = jax.jit(partial(_jax_blocked, k=k, radius=radius))
    jsq, jidx, jok, jd2 = (np.asarray(a) for a in fn(
        jnp.asarray(qc), jg["cell_pts"], jg["cell_list"], jg["overflow"],
        jg["origin"], jg["inv_h"], jg["dims"]))
    d2, cand, _, _ = tknn._grid_candidates(torch.from_numpy(qc), tg, radius)
    np.testing.assert_array_equal(d2.numpy(), jd2)
    # pad slots (index n_points, coordinates 1e15) score ~3e30: finite, so
    # the selection kernel's +inf caveat never applies on these rows
    assert (cand.numpy() == t.n_points).any()
    assert torch.isfinite(d2).all()
    # away from the lattice's edges the k-th distance ties the (k+1)-th
    srt = np.sort(jd2, axis=1)
    assert (srt[:, k - 1] == srt[:, k]).mean() > 0.9
    tsq, tidx, tok = tknn._blocked_topk(torch.from_numpy(qc), tg, k, radius)
    np.testing.assert_array_equal(tsq.numpy(), jsq)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tok.numpy(), jok)


def _void_cloud(d, n):
    rng = np.random.default_rng(d)
    pts = rng.uniform(0, 1, size=(n, d))
    pts = pts[np.linalg.norm(pts - 0.5, axis=1) > 0.12]
    vals = np.sin(4.0 * pts.sum(axis=1)) + 0.1 * pts[:, 0]
    q = rng.uniform(-0.05, 1.05, size=(900, d))
    return pts, vals, q


@pytest.mark.parametrize("d", [2, 3])
def test_knn_index_blocked_layout_matches_jax(monkeypatch, d):
    _grid_pts(monkeypatch)
    monkeypatch.setenv("S3_TPU_DIL_MAX_BYTES", "0")
    monkeypatch.setattr(tknn.KNNIndex, "DIL_MAX_BYTES", 0)
    pts, vals, q = _void_cloud(d, 6000 if d == 2 else 4000)
    k = 8 if d == 2 else 26
    j, t = _pair(pts, vals)
    assert "dil_pts" not in j._grid and "dil_pts" not in t._grid
    jd, ji = j.query(q, k)
    td, ti = t.query(q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    assert 0 < t.last_fallback == j.last_fallback < q.shape[0]
    # f32 sums over the k neighbours in another order (einsum there)
    np.testing.assert_allclose(t.predict(q, k), j.predict(q, k), rtol=1e-6,
                               atol=1e-6)
    assert t.last_fallback == j.last_fallback


def _hole_case(spec):
    """``device-loop-hole``: the cloud of ``tests/test_device_loop.py:
    224-232``, whose void and obstacle share the radius 0.12.
    ``void-wider-than-ring``: a void of radius 0.3 on the top wall around
    an obstacle of 0.05, so valid cells have queries beyond the ring's
    radius-4 reach (~4h, h ≈ 0.05) that only the full scan can answer; the
    root cell's queries (the JAX package's bucket padding) stay clear of
    it."""
    centre, void, obstacle = spec
    rng = np.random.default_rng(0)
    xy = rng.uniform([0, 0], [1, 1], size=(9000, 2))
    r = np.linalg.norm(xy - centre, axis=1)
    keep = r > void
    xy, r = xy[keep][:7000], r[keep][:7000]
    metric = np.exp(-np.maximum(r - void, 0) / 0.05) + 0.01
    geoms = {pkg: [cube("domain", True, [0, 0], [1, 1]),
                   sphere("hole", False, centre, obstacle)]
             for pkg, cube, sphere in (("jax", JCube, JSphere),
                                       ("torch", TCube, TSphere))}
    return xy, metric, geoms


# centre, void radius, obstacle radius
HOLES = {"device-loop-hole": ([0.3, 0.5], 0.12, 0.12),
         "void-wider-than-ring": ([0.5, 0.95], 0.3, 0.05)}


@pytest.mark.parametrize("rescue", [False, True], ids=["rescue-off",
                                                       "rescue-on"])
@pytest.mark.parametrize("hole", list(HOLES))
def test_epoch_packed_matches_jax(monkeypatch, hole, rescue):
    """Every cell of levels 4 and 5 through one fused epoch pass: gain,
    metric, invalid and bad bitwise (2D, k = 8).  The gain and metric of a
    cell still bad after the pass are never read (the host answers it
    again) and are compared only with the rescue on, where no cell is left
    bad: a bad query whose ring holds fewer than k points reads the pad
    index, which the JAX gather clamps to the last point's value and the
    port reads as its zero pad row."""
    _grid_pts(monkeypatch)
    xy, metric, geoms = _hole_case(HOLES[hole])
    jt = jtree.SamplingTree(xy, metric, geoms["jax"], uniform_level=3,
                            n_cells=1500)
    tt = ttree.SamplingTree(xy, metric, geoms["torch"], uniform_level=3,
                            n_cells=1500, device="cpu")
    coords = np.concatenate([
        np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                 -1).reshape(-1, 2) for n in (16, 32)])
    level = np.repeat(np.asarray([4, 5], dtype=np.int32), [256, 1024])
    jidx = jt._append_cells(coords, level)
    tidx = tt._append_cells(coords, level)
    jt._rescue_active = tt._rescue_active = rescue
    jt._build_epoch_fn()
    jout = np.asarray(jt._dispatch_epoch(jidx, jt._epoch_fn))[:jidx.size]
    tout = tt._epoch(tidx, "grid")
    st = tt._epoch_stats
    assert st["ring_queries"] > 0
    bad = jout[:, 3] > 0.5
    np.testing.assert_array_equal(tout[:, 2:], jout[:, 2:])
    np.testing.assert_array_equal(tout[~bad], jout[~bad])
    if rescue:
        assert not bad.any()
    if hole == "void-wider-than-ring":
        # queries the ring cannot prove exact exist; the rescue takes them
        assert (st["rescued_queries"] > 0) == rescue
        assert bad.any() != rescue


@pytest.mark.parametrize("hole", list(HOLES))
def test_grid_matches_jax_host_loop(monkeypatch, hole):
    _grid_pts(monkeypatch)
    monkeypatch.setenv("S3_TPU_DEVICE_LOOP", "0")
    monkeypatch.setattr(ttree.SamplingTree, "DEVICE_LOOP", False)
    xy, metric, geoms = _hole_case(HOLES[hole])
    jt = jtree.SamplingTree(xy, metric, geoms["jax"], uniform_level=3,
                            n_cells=1500)
    tt = ttree.SamplingTree(xy, metric, geoms["torch"], uniform_level=3,
                            n_cells=1500, device="cpu")
    jt.refine()
    tt.refine()

    def key(tree):
        c = np.asarray(tree.all_centers)
        lv = np.asarray(tree.all_levels).ravel()
        order = np.lexsort((lv,) + tuple(c.T))
        return c[order], lv[order]
    (jc, jl), (tc, tl) = key(jt), key(tt)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)
    assert (tt.data_final_mesh["iterations"]
            == jt.data_final_mesh["iterations"])
    st = tt._epoch_stats
    assert st["n_bad_cells"] == jt._epoch_stats["n_bad_cells"]
    assert st["n_calls_ring"] == jt._epoch_stats["n_calls_ring"]
    assert st["ring_queries"] > 0
    assert tt._rescue_active == jt._rescue_active


@pytest.mark.parametrize("hole", ["void-wider-than-ring", "void-over-root"])
def test_ring_and_rescue_change_no_cell(monkeypatch, hole):
    """The grid whose bad queries go through the ring and the rescue equals
    the grid whose bad cells all go to the full scan: every route emits the
    exact canonical answer, so only the counters differ.  The second cloud
    (a void of 0.25 around the root cell's centre) is where the JAX
    package's ring leaves this function: a pass that takes a row failed by
    an earlier pass as filler clears its bad mark, and the row keeps an
    answer that is not provably exact (``ROADMAP.md``, Queue 3)."""
    _grid_pts(monkeypatch)
    monkeypatch.setattr(ttree.SamplingTree, "DEVICE_LOOP", False)
    spec = HOLES.get(hole, ([0.3, 0.5], 0.25, 0.05))
    xy, metric, geoms = _hole_case(spec)

    def run():
        tree = ttree.SamplingTree(xy, metric, geoms["torch"],
                                  uniform_level=3, n_cells=1500,
                                  device="cpu")
        tree.refine()
        c = np.asarray(tree.all_centers)
        lv = np.asarray(tree.all_levels).ravel()
        order = np.lexsort((lv,) + tuple(c.T))
        return tree, c[order], lv[order]
    ring, rc, rl = run()
    with monkeypatch.context() as mp:
        mp.setattr(ttree.SamplingTree, "_ring", lambda *_: 0)
        mp.setattr(ttree.SamplingTree, "_maybe_enable_rescue", lambda _: None)
        full, fc, fl = run()
    np.testing.assert_array_equal(rl, fl)
    np.testing.assert_array_equal(rc, fc)
    np.testing.assert_array_equal(ring._metric, full._metric)
    rs, fs = ring._epoch_stats, full._epoch_stats
    assert rs["ring_queries"] > 0 and rs["rescued_queries"] > 0
    assert rs["n_bad_cells"] < fs["n_bad_cells"]
    assert fs["n_calls_full"] > 0
