"""The port's device-resident geometry-refinement loop
(``SamplingTree._device_geometry_call``,
``engine/device_loop.geometry_level_body``) against the JAX package's
default geometry route and the port's own per-level host walk.

- Against the JAX package's default route (``S3_TPU_DEVICE_LOOP=1``,
  ``S3_TPU_GEO_MDL_LOOP`` unset), at the sizes of
  ``tests/test_device_loop.py``: a circle obstacle refined to level 9
  (``:178``), the same with ``max_delta_level`` (both packages walk the
  levels on the host there), the 60-vertex polygon with
  ``pre_select_cells`` refined to level 8 (``:248``; the loop tests it on
  device-built nodes), and the 360-triangle STL sphere refined to level 6
  (``:286``'s cloud; the winding number inside the loop).  Identical
  ``all_centers`` and ``all_levels`` row for row, the same iterations,
  and the target level reached; the loop carried the levels wherever the
  JAX package runs it.
- Against the port's host walk (``SamplingTree.DEVICE_LOOP = False``),
  grids identical row for row: the 2:1 variant with ``GEO_MDL_LOOP``
  (``:67``: the frontier holds cells of the adaptive phase at the target
  level 6, so the closure's at-target-seed rule decides), windows of two
  levels (re-entry), and a window whose next frontier outgrows a narrowed
  ``k_geo`` (the overflow exit, the frontier recomputed on the host, and
  the host levels after it).
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparsespatialsampling_tpu as jpkg  # noqa: E402
import sparsespatialsampling_torch as tpkg  # noqa: E402
from bench import synthetic_sphere_stl  # noqa: E402
from sparsespatialsampling_torch.engine.tree import SamplingTree  # noqa: E402
from sparsespatialsampling_torch.ops.knn import (  # noqa: E402
    KNNIndex as TorchKNN)
from sparsespatialsampling_tpu.ops.knn import KNNIndex as JaxKNN  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as ``tests/test_torch_device_loop.py`` runs:
    the loops issue many small tensor operations."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _circle(seed: int = 11, level: int = 9):
    """The cloud and obstacle of ``tests/test_device_loop.py:178-200``
    (``seed=0, level=6``: those of ``:67-90``)."""
    def case(pkg, stl):
        rng = np.random.default_rng(seed)
        xy = rng.uniform([0, 0], [1, 1], size=(9000, 2))
        xy = xy[np.linalg.norm(xy - [0.3, 0.5], axis=1) > 0.05][:8000]
        metric = np.exp(-((xy[:, 0] - .6) ** 2 + (xy[:, 1] - .5) ** 2)
                        / .05) + 0.01
        return xy, metric, [
            pkg.CubeGeometry("domain", True, [0, 0], [1, 1]),
            pkg.SphereGeometry("hole", False, [0.3, 0.5], 0.05, refine=True,
                               min_refinement_level=level)]
    return case


def _polygon(pkg, stl):
    """``tests/test_device_loop.py:248-276``."""
    t = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    poly = np.stack([0.4 + 0.12 * np.cos(t), 0.5 + 0.07 * np.sin(t)], 1)
    rng = np.random.default_rng(13)
    xy = rng.uniform([0, 0], [1, 1], size=(8000, 2))
    metric = np.exp(-((xy[:, 0] - .7) ** 2 + (xy[:, 1] - .5) ** 2)
                    / .05) + 0.01
    return xy, metric, [
        pkg.CubeGeometry("domain", True, [0, 0], [1, 1]),
        pkg.GeometryCoordinates2D("wing", False, poly, refine=True,
                                  min_refinement_level=8)]


def _stl(pkg, stl):
    """The cloud of ``tests/test_device_loop.py:304-309`` around the
    360-triangle sphere, refined at its surface to level 6."""
    rng = np.random.default_rng(3)
    xyz = rng.uniform([0, 0, 0], [0.6, 0.4, 0.4], size=(7000, 3))
    rr = np.linalg.norm(xyz - [0.2, 0.2, 0.2], axis=1)
    xyz, rr = xyz[rr > 0.05][:6000], rr[rr > 0.05][:6000]
    metric = np.exp(-np.maximum(rr - 0.05, 0) / 0.1) + 0.01
    extra = {"device": "cpu"} if pkg is tpkg else {}
    return xyz, metric, [
        pkg.CubeGeometry("domain", True, [0, 0, 0], [0.6, 0.4, 0.4]),
        pkg.GeometrySTL3D("sphere", False, stl, refine=True,
                          min_refinement_level=6, **extra)]


# name: (case, target level, grid arguments); every case forces the grid
# kNN on (``GRID_MIN_POINTS = 1000``), which changes no cell and spares the
# CPU the full scan
CASES = {
    "circle": (_circle(), 9, {"uniform_levels": 3, "n_cells_max": 1500}),
    "circle-2to1": (_circle(), 9, {"uniform_levels": 3, "n_cells_max": 1500,
                                   "max_delta_level": True}),
    "polygon-pre-select": (_polygon, 8, {"uniform_levels": 3,
                                         "n_cells_max": 1500,
                                         "pre_select_cells": True}),
    "stl": (_stl, 6, {"uniform_levels": 2, "n_cells_max": 1500}),
    "circle-2to1-level6": (_circle(0, 6), 6,
                           {"uniform_levels": 3, "n_cells_max": 1500,
                            "max_delta_level": True}),
}


@pytest.fixture(scope="module")
def stl_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("geo_loop") / "sphere.stl")
    assert synthetic_sphere_stl(path, n_lat=16, n_lon=12) == 360
    return path


def _run(pkg, name, stl, **switches):
    """One grid of case ``name``; ``switches`` are ``SamplingTree``
    attributes of the port set for the run.  The JAX package runs its
    default route (``S3_TPU_DEVICE_LOOP=1``, ``S3_TPU_GEO_MDL_LOOP``
    unset)."""
    case, _, kw = CASES[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxKNN, "GRID_MIN_POINTS", 1000)
        mp.setattr(TorchKNN, "GRID_MIN_POINTS", 1000)
        mp.setenv("S3_TPU_DEVICE_LOOP", "1")
        mp.delenv("S3_TPU_GEO_MDL_LOOP", raising=False)
        for key, value in switches.items():
            mp.setattr(SamplingTree, key, value)
        if name == "stl":
            # the port's adaptive iterations on its host loop: they grow
            # the loop's cells (tests/test_torch_device_loop.py), and in
            # 3D the loop's ring costs the CPU ten times as much
            mp.setattr(SamplingTree, "_adaptive_device_eligible",
                       lambda self: False)
        pts, metric, geoms = case(pkg, stl)
        extra = {"device": "cpu"} if pkg is tpkg else {}
        s3 = pkg.SparseSpatialSampling(pts, metric, geoms,
                                       save_path=tempfile.mkdtemp(),
                                       save_name="g", **kw, **extra)
        s3.execute_grid_generation()
    return s3


@pytest.fixture(scope="module")
def grids(stl_path):
    """Each grid once per module, by ``(package, case, switches)``."""
    cache = {}

    def get(pkg, name, **switches):
        key = (pkg.__name__, name, tuple(sorted(switches.items())))
        if key not in cache:
            cache[key] = _run(pkg, name, stl_path, **switches)
        return cache[key]
    return get


def _assert_identical(a, b):
    """The same cells row for row (the export's face ids follow the row
    order) and the same iterations."""
    np.testing.assert_array_equal(np.asarray(b.centers),
                                  np.asarray(a.centers))
    np.testing.assert_array_equal(np.asarray(b.levels),
                                  np.asarray(a.levels))
    assert (a.data_final_mesh["iterations"]
            == b.data_final_mesh["iterations"])


def _route(s3):
    return s3.data_final_mesh["epoch_stats"]["geometry_route"]


def _host_explained(route):
    """Every host level has its counted cause."""
    return route["host_levels"] == sum(route["host_fallback"].values())


@pytest.mark.parametrize("name", ["circle", "circle-2to1",
                                  "polygon-pre-select", "stl"])
def test_matches_jax_default_route(grids, name):
    ref = grids(jpkg, name)
    got = grids(tpkg, name)
    _assert_identical(ref, got)
    assert int(np.asarray(got.levels).max()) >= CASES[name][1]
    route = _route(got)
    assert _host_explained(route)
    if CASES[name][2].get("max_delta_level"):
        # the JAX package walks the 2:1 variant's levels on the host
        assert route["windows"] == 0
        assert route["host_levels"] == route["host_fallback"]["route"] > 0
    else:
        assert route["windows"] >= 1
        assert route["window_levels"] > route["host_levels"]
        assert route["host_fallback"]["route"] == 0
        # one read a level waited for and one a window
        assert route["d2h_syncs"] <= (route["window_levels"]
                                      + 2 * route["windows"])
        split = got.data_final_mesh["geometry_split"]
        assert split["t_window"] > 0.0


def test_host_walk_when_switched_off(grids):
    got = grids(tpkg, "circle", DEVICE_LOOP=False)
    _assert_identical(grids(tpkg, "circle"), got)
    route = _route(got)
    assert route["windows"] == 0
    assert route["host_levels"] == route["host_fallback"]["route"] >= 3


def test_mdl_loop_matches_host_walk(grids, monkeypatch):
    """The 2:1 variant in the loop (``tests/test_device_loop.py:67``)."""
    at_target = []
    call = SamplingTree._device_geometry_call

    def spy(self, g, surface, gmin, gmax):
        at_target.append(int((self._level[surface] >= gmax).sum()))
        return call(self, g, surface, gmin, gmax)
    monkeypatch.setattr(SamplingTree, "_device_geometry_call", spy)
    loop = _run(tpkg, "circle-2to1-level6", None, GEO_MDL_LOOP=True)
    _assert_identical(grids(tpkg, "circle-2to1-level6", DEVICE_LOOP=False),
                      loop)
    route = _route(loop)
    assert route["windows"] >= 1 and route["window_levels"] >= 1
    assert route["host_fallback"]["route"] == 0 and _host_explained(route)
    # the frontier held surface cells of the adaptive phase at the target
    # level: the closure splits such a seed only where a probe finds it
    assert at_target[0] > 0


def test_windows_reenter(grids):
    host = grids(tpkg, "circle", DEVICE_LOOP=False)
    loop = grids(tpkg, "circle", _GEO_LOOP_LEVELS=2)
    _assert_identical(host, loop)
    route = _route(loop)
    assert route["windows"] >= 2 and route["window_exits"]["window_full"] >= 1
    assert route["host_levels"] == 0


def test_frontier_overflow(grids, monkeypatch):
    """A ``k_geo`` narrowed to the entry surface: the first level's next
    frontier outgrows it, the level completes, the host recomputes the
    frontier, and the levels after it run on the host."""
    shape = SamplingTree._geometry_loop_shape

    def narrow(self, g, surface, gmin, gmax):
        if id(g) not in self._geo_loop_shapes:
            _, cap = shape(self, g, surface, gmin, gmax)
            self._geo_loop_shapes[id(g)] = (int(surface.size), cap)
        return self._geo_loop_shapes[id(g)]
    monkeypatch.setattr(SamplingTree, "_geometry_loop_shape", narrow)
    loop = _run(tpkg, "circle", None)
    _assert_identical(grids(tpkg, "circle", DEVICE_LOOP=False), loop)
    route = _route(loop)
    assert route["window_exits"]["overflow"] >= 1
    assert route["host_fallback"]["overflow"] >= 1
    assert route["window_levels"] >= 1 and _host_explained(route)
