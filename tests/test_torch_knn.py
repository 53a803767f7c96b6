"""The port's ``KNNIndex`` against the JAX package's on seeded clouds.

Both the bucket-grid path (``GRID_MIN_POINTS`` patched to 1000 on both
classes) and the full scan (``GRID_MIN_POINTS`` = 10**12) must return the
same neighbour indices and bitwise the same distances and weights;
predictions agree to f32 summation order (rtol 1e-6).  The dilated layout,
the per-query accept masks and the fallback counts must be equal, and the
port's query side must give the same answers on the layout the JAX package
built (``index_from_reference``).
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sparsespatialsampling_tpu.ops import knn as jknn  # noqa: E402
from sparsespatialsampling_torch import trace  # noqa: E402
from sparsespatialsampling_torch.ops import knn as tknn  # noqa: E402
from sparsespatialsampling_torch.ops import topk  # noqa: E402

CASES = [(2, 6000), (3, 4000)]
MODES = {"grid": 1000, "full-scan": 10 ** 12}


def _cloud(d, n):
    rng = np.random.default_rng(d)
    pts = rng.uniform(0, 1, size=(n, d))
    # a void the grid cannot answer near: exercises the exact fallback
    pts = pts[np.linalg.norm(pts - 0.5, axis=1) > 0.12]
    vals = np.sin(4.0 * pts.sum(axis=1)) + 0.1 * pts[:, 0]
    q = rng.uniform(-0.05, 1.05, size=(900, d))
    return pts, vals, q


def _pair(monkeypatch, d, n, mode):
    monkeypatch.setattr(jknn.KNNIndex, "GRID_MIN_POINTS", MODES[mode])
    monkeypatch.setattr(tknn.KNNIndex, "GRID_MIN_POINTS", MODES[mode])
    pts, vals, q = _cloud(d, n)
    j = jknn.KNNIndex(pts, values=vals)
    t = tknn.KNNIndex(pts, values=vals, device="cpu")
    assert (j._grid is None) == (t._grid is None) == (mode == "full-scan")
    return j, t, q, (8 if d == 2 else 26)


@pytest.fixture(params=[(d, n, m) for d, n in CASES for m in MODES],
                ids=[f"{d}d-{m}" for d, _ in CASES for m in MODES])
def pair(request, monkeypatch):
    return _pair(monkeypatch, *request.param)


@pytest.fixture(params=CASES, ids=[f"{d}d" for d, _ in CASES])
def grid_pair(request, monkeypatch):
    return _pair(monkeypatch, *request.param, "grid")


def test_query_bitwise(pair):
    j, t, q, k = pair
    jd, ji = j.query(q, k)
    td, ti = t.query(q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    assert t.last_fallback == j.last_fallback


def test_predict_and_weights(pair):
    j, t, q, k = pair
    jp, tp = j.predict(q, k), t.predict(q, k)
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
    jw, jwi = j.weights(q, k)
    tw, twi = t.weights(q, k)
    np.testing.assert_array_equal(twi, jwi)
    np.testing.assert_array_equal(tw, jw)


def _reference_arrays(j):
    g = j._grid
    arrays = {"_points": np.asarray(j._points),
              "_points_sq": np.asarray(j._points_sq),
              "_perm": j._perm, "_shift": j._shift,
              "_points_host": j._points_host}
    for key in ("origin", "inv_h", "dims", "C", "cell_list", "overflow",
                "dil_pts", "dil_cand", "dil_ovf", "_dil_keep"):
        arrays[key] = np.asarray(g[key])
    return arrays


def test_grid_layout_and_accept_masks(grid_pair):
    j, t, q, k = grid_pair
    jg, tg = j._grid, t._grid
    assert tg["C"] == jg["C"] and tg["_dil_keep"] == jg["_dil_keep"]
    for key in ("cell_list", "dil_cand", "dil_pts", "dil_ovf", "dims",
                "origin"):
        np.testing.assert_array_equal(tg[key].numpy(), np.asarray(jg[key]))
    qc = (q - j._shift).astype(np.float32)
    jsq, jidx, jok = (np.asarray(a) for a in jknn._grid_query_kernel_dil(
        jnp.asarray(qc), jg["dil_pts"], jg["dil_cand"], jg["dil_ovf"],
        jg["origin"], jg["inv_h"], jg["dims"], k))
    tsq, tidx, _, tok, _ = tknn._dilated_topk(torch.from_numpy(qc), tg, k)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert 0 < (~jok).sum() < jok.size   # both outcomes are exercised
    np.testing.assert_array_equal(tsq.numpy()[jok], jsq[jok])
    np.testing.assert_array_equal(tidx.numpy()[jok], jidx[jok])


def test_query_side_on_jax_built_layout(grid_pair):
    j, t, q, k = grid_pair
    r = tknn.index_from_reference(_reference_arrays(j), device="cpu")
    r.set_values(j._values_host)
    jd, ji = j.query(q, k)
    rd, ri = r.query(q, k)
    np.testing.assert_array_equal(ri, ji)
    np.testing.assert_array_equal(rd, jd)
    np.testing.assert_allclose(r.predict(q, k), j.predict(q, k), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("d", [2, 3])
def test_delta_sum_bitwise_equals_jitted_jnp_sum(d):
    """The equality of grid and full-scan rows rests on one distance
    formula: the port's must equal XLA's ``jnp.sum(dd * dd, -1)``."""
    rng = np.random.default_rng(d)
    delta = rng.uniform(-1.0, 1.0, size=(50_000, d)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jnp.sum(x * x, axis=-1))(delta))
    got = tknn._sqsum(torch.from_numpy(delta)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("d,n", [(2, 3000), (3, 3000), (2, 2 * 1024 + 5),
                                 (3, 26 + 3)],
                         ids=["2d", "3d", "2d-short-last-tile",
                              "3d-one-tile-k+3-points"])
def test_full_scan_search_matches_jax(d, n):
    """Tiles of 1024; the short-tile clouds hold fewer than k + 8 real
    points in a tile, so +inf pad scores reach the selection."""
    rng = np.random.default_rng(10 + d)
    k = 8 if d == 2 else 26
    n_pad = -(-(n + 1) // 1024) * 1024
    pts = np.full((n_pad, d), 1e30, dtype=np.float32)
    pts[:n] = rng.uniform(-1, 1, size=(n, d))
    sq = np.full(n_pad, np.inf, dtype=np.float32)
    sq[:n] = (pts[:n].astype(np.float64) ** 2).sum(1)
    q = rng.uniform(-1.1, 1.1, size=(256, d)).astype(np.float32)
    search = jax.jit(partial(jknn._search, k=k, tile_n=1024, tile_q=128))
    jsq, jidx = (np.asarray(a) for a in search(jnp.asarray(q),
                                               jnp.asarray(pts),
                                               jnp.asarray(sq)))
    tsq, tidx = tknn._search(torch.from_numpy(q), torch.from_numpy(pts),
                             torch.from_numpy(sq), k, 1024, 128)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tsq.numpy(), jsq)
    assert (tidx.numpy() < n).all()


def test_k_out_of_range_raises():
    t = tknn.KNNIndex(np.random.default_rng(0).uniform(size=(50, 2)),
                      device="cpu")
    with pytest.raises(ValueError):
        t.query(np.zeros((1, 2)), 51)


@pytest.mark.parametrize("mode", list(MODES))
def test_k_above_selection_limit_raises(monkeypatch, mode):
    """k = 300 is above what the selection kernel takes (its wrapper still
    raises), yet ``KNNIndex`` answers it as the JAX package does: the port
    sends it to the full scan, whose k + 8 selections take one stable sort;
    the JAX package answers it from its grid where one is built (3^3·C >=
    300), with the same canonical result."""
    k = 300
    with pytest.raises(ValueError, match=str(topk.MAX_K)):
        topk.topk_smallest(torch.zeros(4, 1000), k)
    j, t, q, _ = _pair(monkeypatch, 3, 4000, mode)
    jd, ji = j.query(q, k)
    td, ti = t.query(q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    # IDW sums of 300 terms in another order than the JAX einsum's
    np.testing.assert_allclose(t.predict(q, k), j.predict(q, k), rtol=1e-5,
                               atol=1e-6)


def _build_cloud(name):
    """Seeded clouds for the build's edge cases (a few thousand points)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "2d":
        return _cloud(2, 5000)[0]
    if name == "3d":
        return _cloud(3, 4000)[0]
    if name == "2d-dense-core":
        # a dense core in a sparse box: the cell size shrinks over passes
        return np.concatenate([rng.uniform(0, 1, (1000, 2)),
                               rng.normal(0.5, 0.03, (1000, 2))])
    if name == "3d-over-capacity":
        # 90 copies of one point: a cell no shrink can split, above the
        # capacity, so numpy's percentile picks C; equal codes leave the
        # order to the sort's stability
        return np.concatenate([rng.uniform(0, 1, (3000, 3)),
                               np.full((90, 3), 0.3)])
    if name == "2d-duplicates":
        pts = rng.uniform(-1, 2, (1500, 2))
        return np.concatenate([pts, pts[::-1], pts[::3]])
    if name == "3d-flat-gridless":
        # an axis of zero extent (the 1e-30 clamp) in the 3D order; too
        # few points for a grid (a 3D grid over it overflows the cell
        # count in both packages' plans)
        pts = rng.uniform(0, 1, (800, 3))
        pts[:, 2] = 0.25
        return pts
    if name == "2d-line":
        # an axis of zero extent in the order and the plan
        return np.stack([rng.uniform(0, 3, 4000), np.full(4000, -0.5)], 1)
    return rng.uniform(0, 1, (3000, 4))     # no grid, the host's order


BUILD_CLOUDS = ["2d", "3d", "2d-dense-core", "3d-over-capacity",
                "2d-duplicates", "3d-flat-gridless", "2d-line", "4d"]


@pytest.mark.parametrize("name", BUILD_CLOUDS)
def test_build_matches_jax(monkeypatch, name):
    """The port builds the order, the plan and the neighbour table on the
    index's device (here the CPU route); every output is the JAX package's
    host build bit for bit: the permutation, the padded points and norms,
    the centre, the plan (h, C, dims, per-point cell ids, overflow), the
    dilated width and the neighbour table.  A profiled build counts the
    permutation's bytes read back and one pass per cell-count pass."""
    monkeypatch.setattr(jknn.KNNIndex, "GRID_MIN_POINTS", 1000)
    monkeypatch.setattr(tknn.KNNIndex, "GRID_MIN_POINTS", 1000)
    pts = _build_cloud(name)
    n, d = pts.shape
    j = jknn.KNNIndex(pts)
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t = tknn.KNNIndex(pts, device="cpu")
    spans = {r["name"]: r["counts"] for r in trace.records()}
    trace.clear()
    np.testing.assert_array_equal(t._shift, j._shift)
    np.testing.assert_array_equal(t._perm, j._perm)
    np.testing.assert_array_equal(t._perm_dev.numpy()[:n], j._perm)
    np.testing.assert_array_equal(t._points.numpy(), np.asarray(j._points))
    np.testing.assert_array_equal(t._points_sq.numpy(),
                                  np.asarray(j._points_sq))
    assert spans["knn.order"]["readback_bytes"] == n * 8
    assert (t._grid is None) == (j._grid is None) == (
        d not in (2, 3) or n < 1000)
    if t._grid is None:
        assert "knn.plan" not in spans
        return

    sorted_pts = j._points_host[j._perm]
    jplan = jknn._plan_grid(sorted_pts, n, n, t.GRID_OCCUPANCY,
                            t.GRID_CAPACITY, host_arrays=False,
                            shrink_target=t.GRID_SHRINK_TARGET)
    tplan = tknn._plan_grid(torch.from_numpy(sorted_pts), n,
                            t.GRID_OCCUPANCY, t.GRID_CAPACITY,
                            t.GRID_SHRINK_TARGET)
    assert tplan["h"] == jplan["h"] and tplan["C"] == jplan["C"]
    assert tplan["n_cells"] == jplan["n_cells"]
    np.testing.assert_array_equal(tplan["dims"], jplan["dims"])
    np.testing.assert_array_equal(tplan["origin"].numpy(), jplan["origin"])
    np.testing.assert_array_equal(tplan["flat_ids"].numpy(),
                                  jplan["flat_ids"])
    np.testing.assert_array_equal(tplan["overflow"].numpy() > 0.5,
                                  jplan["overflow"])
    assert tknn._max_dilated_occupancy(
        tplan["counts"], tplan["dims"], tplan["C"]) == \
        jknn._max_dilated_occupancy(jplan)
    assert spans["knn.plan"]["passes"] == tplan["passes"]
    assert 1 <= tplan["passes"] <= 9
    if name == "2d-dense-core":
        assert tplan["passes"] >= 3
    if name == "3d-over-capacity":
        assert tplan["counts"].max() > t.GRID_CAPACITY
        assert tplan["overflow"].sum() > 0

    tg, jg = t._grid, j._grid
    assert tg["C"] == jg["C"] and tg["_dil_keep"] == jg["_dil_keep"]
    for key in ("cell_list", "overflow", "dims", "origin", "inv_h",
                "dil_pts", "dil_cand", "dil_ovf"):
        np.testing.assert_array_equal(tg[key].numpy(), np.asarray(jg[key]))
    np.testing.assert_array_equal(
        tknn._grid_neighbor_table(tg["dims"], tplan["n_cells"]).numpy(),
        np.asarray(jg["_nb"]))
