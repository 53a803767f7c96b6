"""The port's device-resident adaptive loop (``SamplingTree.DEVICE_LOOP``,
``engine/device_loop.py``) against its host loop and the JAX package.

- Whole grids of the device loop equal the port's host loop
  (``DEVICE_LOOP = False``) cell for cell, with the same iteration count
  and the captured-metric trace to rtol 1e-5, in the cases of
  ``tests/test_device_loop.py``: both stopping modes with and without the
  2:1 balance on the 8,000-point holed cloud (grid kNN forced on), the
  gridless full-scan core, and a budget of 2,500 cells an iteration (the
  width of the JAX package's stable-sort selection branch).
- The loop engages: fewer windows than iterations, one read back an
  iteration and one a window.
- Near a void wider than the ring, cells leave the loop's ring unproven:
  the window ends, the host escalation answers them, the next window
  re-enters with the corrected rows scattered in and an in-loop rescue,
  and the grid does not move.
- A 3D grid around an STL obstacle equals the host loop's.
- ``_bsearch_eq`` and ``_mdl_expand`` equal the JAX functions on seeded
  ``(level, coords)`` sets in 2D and 3D, the guard of a broken 2:1
  invariant included.
- Two grids against the JAX package's device loop
  (``S3_TPU_DEVICE_LOOP=1``): the same cells and iterations, the metric
  trace to rtol 1e-5.
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparsespatialsampling_tpu as jpkg  # noqa: E402
from sparsespatialsampling_tpu.engine import tree as jtree  # noqa: E402
from sparsespatialsampling_tpu.ops.knn import KNNIndex as JaxKNN  # noqa: E402
import sparsespatialsampling_torch as tpkg  # noqa: E402
from bench import synthetic_sphere_stl  # noqa: E402
from sparsespatialsampling_torch.engine import device_loop  # noqa: E402
from sparsespatialsampling_torch.engine.tree import SamplingTree  # noqa: E402
from sparsespatialsampling_torch.ops.knn import (  # noqa: E402
    KNNIndex as TorchKNN)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the loop issues many small tensor operations,
    which slow down many times over when the suite's workers share the
    cores and each operation waits for its thread team."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _holed_cloud():
    """The cloud of ``tests/test_device_loop.py:21-35``."""
    rng = np.random.default_rng(0)
    xy = rng.uniform([0, 0], [1, 1], size=(9000, 2))
    r = np.linalg.norm(xy - [0.3, 0.5], axis=1)
    xy = xy[r > 0.05][:8000]
    metric = np.exp(-((xy[:, 0] - .6) ** 2 + (xy[:, 1] - .5) ** 2)
                    / .05) + 0.01
    return xy, metric, lambda pkg: [
        pkg.CubeGeometry("domain", True, [0, 0], [1, 1]),
        pkg.SphereGeometry("hole", False, [0.3, 0.5], 0.05)]


def _gridless_cloud(n_points: int = 5000):
    """The 5,000-point cloud of ``tests/test_device_loop.py:138-150``,
    under ``GRID_MIN_POINTS``, or its first ``n_points``."""
    rng = np.random.default_rng(7)
    xy = rng.uniform([0, 0], [1, 1], size=(5000, 2))[:n_points]
    metric = np.exp(-((xy[:, 0] - .4) ** 2 + (xy[:, 1] - .6) ** 2)
                    / .03) + 0.02
    return xy, metric, lambda pkg: [
        pkg.CubeGeometry("domain", True, [0, 0], [1, 1])]


def _wide_void_cloud():
    """A void of radius 0.3 on the top wall around an obstacle of 0.05
    (``tests/test_torch_ring.py``'s ``void-wider-than-ring``): valid cells
    have queries beyond the ring's radius-4 reach."""
    rng = np.random.default_rng(0)
    xy = rng.uniform([0, 0], [1, 1], size=(9000, 2))
    r = np.linalg.norm(xy - [0.5, 0.95], axis=1)
    keep = r > 0.3
    xy, r = xy[keep][:7000], r[keep][:7000]
    metric = np.exp(-np.maximum(r - 0.3, 0) / 0.05) + 0.01
    return xy, metric, lambda pkg: [
        pkg.CubeGeometry("domain", True, [0, 0], [1, 1]),
        pkg.SphereGeometry("hole", False, [0.5, 0.95], 0.05)]


def _run(monkeypatch, pkg, cloud, grid=True, device_loop=True, **kwargs):
    """One grid of ``pkg`` (the grid kNN forced on where ``grid``); the
    JAX package's device loop is on unless ``device_loop`` is False."""
    monkeypatch.setattr(JaxKNN, "GRID_MIN_POINTS", 1000 if grid else 10 ** 9)
    monkeypatch.setattr(TorchKNN, "GRID_MIN_POINTS",
                        1000 if grid else 10 ** 9)
    monkeypatch.setattr(SamplingTree, "DEVICE_LOOP", device_loop)
    monkeypatch.setenv("S3_TPU_DEVICE_LOOP", "1" if device_loop else "0")
    pts, metric, geoms = cloud()
    extra = {"device": "cpu"} if pkg is tpkg else {}
    s3 = pkg.SparseSpatialSampling(pts, metric, geoms(pkg),
                                   save_path=tempfile.mkdtemp(),
                                   save_name="d", **kwargs, **extra)
    s3.execute_grid_generation()
    return s3


def _assert_same(a, b):
    """The same cells and levels, iterations and metric trace."""
    def key(s3):
        c = np.asarray(s3.centers)
        lv = np.asarray(s3.levels).ravel()
        order = np.lexsort((lv,) + tuple(c.T))
        return c[order], lv[order]
    (ca, la), (cb, lb) = key(a), key(b)
    np.testing.assert_array_equal(lb, la)
    np.testing.assert_array_equal(cb, ca)
    assert (a.data_final_mesh["iterations"]
            == b.data_final_mesh["iterations"])
    np.testing.assert_allclose(b.data_final_mesh["metric_per_iter"],
                               a.data_final_mesh["metric_per_iter"],
                               rtol=1e-5)


def _stats(s3):
    return s3.data_final_mesh["epoch_stats"]


MODES = {"cells-mode": {"n_cells_max": 2000},
         "metric-mode": {"min_metric": 0.9},
         "cells-mode-2to1": {"n_cells_max": 2000, "max_delta_level": True},
         "metric-mode-2to1": {"min_metric": 0.9, "max_delta_level": True}}


@pytest.mark.parametrize("mode", list(MODES))
def test_device_loop_matches_host_loop(monkeypatch, mode):
    kw = dict(uniform_levels=3, **MODES[mode])
    host = _run(monkeypatch, tpkg, _holed_cloud, device_loop=False, **kw)
    loop = _run(monkeypatch, tpkg, _holed_cloud, **kw)
    _assert_same(host, loop)
    assert _stats(host)["windows"] == 0
    # the loop engaged: windows batch iterations
    # (``tests/test_device_loop.py:121-135``)
    st = _stats(loop)
    iters = loop.data_final_mesh["adaptive_split"]["n_iter"]
    assert iters > 5 and st["windows"] < iters
    assert st["window_iters"] == iters == loop.data_final_mesh["iterations"]
    assert st["host_fallback"] == dict.fromkeys(st["host_fallback"], 0)
    # one read a window iteration and one a window, nothing else
    assert st["d2h_syncs"] == st["window_iters"] + st["windows"]


# (points, arguments): the metric modes run on the cloud's first points
# (the 2:1 case scans 4x the slots an iteration)
GRIDLESS = {"cells-mode": (5000, {"n_cells_max": 800}),
            "metric-mode": (3000, {"min_metric": 0.9}),
            "metric-mode-2to1": (2000, {"min_metric": 0.9,
                                        "max_delta_level": True})}


@pytest.mark.parametrize("mode", list(GRIDLESS))
def test_fullscan_core_matches_host_loop(monkeypatch, mode):
    """Gridless clouds run the loop with the full-scan epoch
    (``tests/test_device_loop.py:153-175``)."""
    n_points, kw = GRIDLESS[mode]

    def cloud():
        return _gridless_cloud(n_points)
    host = _run(monkeypatch, tpkg, cloud, grid=False, device_loop=False,
                uniform_levels=3, **kw)
    loop = _run(monkeypatch, tpkg, cloud, grid=False, uniform_levels=3, **kw)
    assert loop._knn_index._grid is None
    _assert_same(host, loop)
    iters = loop.data_final_mesh["iterations"]
    assert iters > 3 and _stats(loop)["windows"] < iters


def test_sort_sized_budget_matches_host_loop(monkeypatch):
    """A budget of 2,500 cells an iteration: a selection width of 4,096,
    where the JAX package sorts instead of ``lax.top_k``
    (``tests/test_device_loop.py:103-118``); the port always sorts."""
    kw = {"uniform_levels": 3, "n_cells_max": 6000,
          "n_cells_iter_start": 2500}
    host = _run(monkeypatch, tpkg, _holed_cloud, device_loop=False, **kw)
    loop = _run(monkeypatch, tpkg, _holed_cloud, **kw)
    _assert_same(host, loop)
    assert 0 < _stats(loop)["windows"] <= loop.data_final_mesh["iterations"]


def test_bad_rows_end_the_window_and_reenter(monkeypatch):
    """Cells whose queries reach into a void wider than the ring end their
    window; the host escalation answers them, the next window scatters
    the corrected rows into the kept state and rescues such queries in
    the loop, and the grid is the host loop's."""
    kw = {"uniform_levels": 3, "n_cells_max": 1500}
    host = _run(monkeypatch, tpkg, _wide_void_cloud, device_loop=False, **kw)
    loop = _run(monkeypatch, tpkg, _wide_void_cloud, **kw)
    _assert_same(host, loop)
    st = _stats(loop)
    assert st["window_exits"]["bad_rows"] > 0
    assert st["n_bad_cells"] > 0 and st["rows_reuploaded"] > 0
    assert st["rescued_queries"] > 0
    assert st["windows"] < loop.data_final_mesh["iterations"]


def test_stl_obstacle_matches_host_loop(monkeypatch, tmp_path):
    """3D around an STL obstacle (``tests/test_device_loop.py:286-325``):
    the sign-grid inside test in every epoch of the loop."""
    stl = str(tmp_path / "sphere.stl")
    synthetic_sphere_stl(stl, n_lat=16, n_lon=12)

    def cloud():
        rng = np.random.default_rng(3)
        xyz = rng.uniform([0, 0, 0], [0.6, 0.4, 0.4], size=(7000, 3))
        rr = np.linalg.norm(xyz - [0.2, 0.2, 0.2], axis=1)
        xyz, rr = xyz[rr > 0.05][:6000], rr[rr > 0.05][:6000]
        metric = np.exp(-np.maximum(rr - 0.05, 0) / 0.1) + 0.01
        return xyz, metric, lambda pkg: [
            pkg.CubeGeometry("domain", True, [0, 0, 0], [0.6, 0.4, 0.4]),
            pkg.GeometrySTL3D("sphere", False, stl, device="cpu")]
    # 32 cells an iteration: half the loop's narrowest selection, so few
    # of its slots are empty
    kw = {"uniform_levels": 2, "n_cells_max": 1500, "n_cells_iter_start": 32}
    host = _run(monkeypatch, tpkg, cloud, device_loop=False, **kw)
    loop = _run(monkeypatch, tpkg, cloud, **kw)
    _assert_same(host, loop)
    assert 0 < _stats(loop)["windows"] < loop.data_final_mesh["iterations"]


def _balanced_tree(d):
    """``(coords, level, alive)`` of a grid refined with the 2:1 balance on
    the host (3 uniform levels, then 12 adaptive iterations)."""
    rng = np.random.default_rng(5 + d)
    pts = rng.uniform(0, 1, size=(3000, d))
    metric = np.exp(-((pts - 0.6) ** 2).sum(1) / 0.02) + 0.01
    tree = SamplingTree(pts, metric,
                        [tpkg.CubeGeometry("domain", True, [0] * d, [1] * d)],
                        uniform_level=3 if d == 2 else 2, n_cells=400,
                        max_delta_level=True, n_cells_iter_start=12,
                        device="cpu")
    tree.DEVICE_LOOP = False
    tree.refine()
    n = tree._n_cells
    return (tree._coords[:n].copy(), tree._level[:n].copy(),
            tree._alive[:n].copy())


def _broken_tree():
    """2D leaves whose level-3 cell (4, 3) touches the level-1 cell (0, 1)
    at a corner: the 2:1 invariant is broken."""
    cells = [(1, 0, 0), (1, 0, 1), (1, 1, 1), (2, 2, 0), (2, 3, 0),
             (2, 3, 1), (3, 4, 2), (3, 4, 3), (3, 5, 2), (3, 5, 3)]
    level = np.asarray([c[0] for c in cells], dtype=np.int32)
    coords = np.asarray([c[1:] for c in cells], dtype=np.int64)
    return coords, level, np.ones(len(cells), dtype=bool)


def _nbdirs(d):
    dirs = np.stack(np.meshgrid(*([np.array([-1, 0, 1])] * d),
                                indexing="ij"), -1).reshape(-1, d)
    return dirs[(dirs != 0).any(axis=1)]


@pytest.mark.parametrize("case", ["2d", "3d", "2d-broken-invariant"])
def test_mdl_expand_matches_jax(case):
    coords, level, alive = (_broken_tree() if case.endswith("invariant")
                            else _balanced_tree(int(case[0])))
    d = coords.shape[1]
    n = coords.shape[0]
    cap = max(64, 1 << n.bit_length())
    rng = np.random.default_rng(11)
    rows = np.nonzero(alive)[0]
    k_seed, k_sel = 8, 64
    if case.endswith("invariant"):
        seed = np.full(k_seed, cap)
        seed[0] = 7                      # the level-3 cell (4, 3)
    else:
        seed = np.full(k_seed, cap)
        seed[:6] = np.sort(rng.choice(rows, 6, replace=False))

    def padded(a, dtype):
        out = np.zeros((cap + 1,) + a.shape[1:], dtype=dtype)
        out[:n] = a
        return out
    jout = jtree._mdl_expand(
        jnp.asarray(padded(coords, np.int32)), jnp.asarray(padded(level,
                                                                  np.int32)),
        jnp.asarray(padded(alive, bool)), jnp.asarray(seed, jnp.int32), cap,
        d, k_sel, int(cap).bit_length(), jnp.asarray(_nbdirs(d), jnp.int32),
        4)
    tout = device_loop._mdl_expand(
        torch.from_numpy(padded(coords, np.int64)),
        torch.from_numpy(padded(level, np.int64)),
        torch.from_numpy(padded(alive, bool)), torch.from_numpy(seed), cap,
        d, k_sel, torch.from_numpy(_nbdirs(d)), 4)
    parents, pvalid, guard = (np.asarray(x) for x in jout)
    np.testing.assert_array_equal(tout[0].numpy(), parents)
    np.testing.assert_array_equal(tout[1].numpy(), pvalid)
    assert bool(tout[2]) == bool(guard)
    if case.endswith("invariant"):
        assert bool(guard)
    else:
        # the closure added neighbours to the seeds and stayed exact
        assert not bool(guard) and pvalid.sum() > 6


@pytest.mark.parametrize("d", [2, 3])
def test_bsearch_eq_matches_jax(d):
    """Sorted ``(level << 22 | c0, c1[, c2])`` keys of seeded cells
    (levels 1-22, with repeated leading components), queried with present
    keys, absent ones and all-(-1) misses."""
    rng = np.random.default_rng(d)
    level = rng.integers(1, 23, size=4000)
    coords = rng.integers(0, 1 << 22, size=(4000, d)) >> (22 - level)[:, None]
    coords[::7, :d - 1] = coords[0, :d - 1]         # shared prefixes
    level[::7] = level[0]
    keys = np.unique(np.concatenate(
        [((level << 22) | coords[:, 0])[:, None], coords[:, 1:]], 1), axis=0)
    present = keys[rng.choice(keys.shape[0], 500)]
    absent = present.copy()
    absent[:, -1] += 1
    queries = np.concatenate([present, absent, np.full((50, d), -1)])
    jpos, jfound = jtree._bsearch_eq(
        tuple(jnp.asarray(k, jnp.int32) for k in keys.T),
        tuple(jnp.asarray(q, jnp.int32) for q in queries.T),
        keys.shape[0].bit_length() + 1)
    tpos, tfound = device_loop._bsearch_eq(
        tuple(torch.from_numpy(k.copy()) for k in keys.T),
        tuple(torch.from_numpy(q.copy()) for q in queries.T))
    jfound = np.asarray(jfound)
    np.testing.assert_array_equal(tfound.numpy(), jfound)
    assert jfound[:500].all() and not jfound[-50:].any()
    np.testing.assert_array_equal(tpos.numpy()[jfound],
                                  np.asarray(jpos)[jfound])


JAX_CASES = {
    "2d-metric-2to1": (_holed_cloud, True,
                       {"uniform_levels": 3, "min_metric": 0.9,
                        "max_delta_level": True}),
    "gridless-metric": (lambda: _gridless_cloud(3000), False,
                        {"uniform_levels": 3, "min_metric": 0.9}),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_matches_jax_device_loop(monkeypatch, case):
    cloud, grid, kw = JAX_CASES[case]
    ref = _run(monkeypatch, jpkg, cloud, grid=grid, **kw)
    loop = _run(monkeypatch, tpkg, cloud, grid=grid, **kw)
    _assert_same(ref, loop)
    assert _stats(loop)["windows"] > 0
