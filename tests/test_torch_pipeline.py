"""The port's grid generation and export against the JAX package and the
pure-numpy oracle.

- ``SparseSpatialSampling(device="cpu")`` of the port and the JAX package
  grow identical grids — same lexsorted centres and levels, same iteration
  count, captured-metric trace to rtol 1e-5 — in both stopping modes,
  through the grid kNN's exact fallback and geometry refinement in 3D, with
  a cylinder obstacle, with a polygon obstacle under ``pre_select_cells``
  and with ``max_delta_level``.
- The port reproduces ``tests/oracle.py`` and the JAX package on the cases
  of ``tests/test_oracle_parity.py:91``, ``:98``, ``:107``, ``:116``,
  ``:125`` and ``:134``.
- With ``pre_select_cells`` the port's validity flags of the uniform
  sweeps and the geometry refinement equal the JAX package's
  ``BatchedValidity(..., pre_select=True).from_cells`` on cells whose
  device-built nodes give other flags.
- ``ExportData.export`` of both packages on the same grid (a 2D and a 3D
  case) writes the same HDF5 datasets bit for bit, dtype included — grid,
  constants, the f64 metric and the fields at centres and vertices — and
  an XDMF that parses; ``ExportData.interpolate`` returns the IDW field
  without writing a file.
"""
import tempfile
import xml.etree.ElementTree as ET
from os.path import join
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import h5py  # noqa: E402

import sparsespatialsampling_tpu as jpkg  # noqa: E402
from chip_smoke import (airfoil_polygon, synthetic_oat15,  # noqa: E402
                        unbalanced)
import sparsespatialsampling_torch as tpkg  # noqa: E402
from sparsespatialsampling_tpu.ops.knn import KNNIndex as JaxKNN  # noqa: E402
from sparsespatialsampling_torch.ops.knn import (  # noqa: E402
    KNNIndex as TorchKNN)
from tests.oracle import (OracleS3, OracleGeometry, cube_inside,  # noqa: E402
                          sphere_inside)
from tests.test_oracle_parity import (_cloud_2d, _cloud_3d,  # noqa: E402
                                      _assert_identical)


def _cloud_2d_hole():
    """The cloud of ``tests/test_device_loop.py:21-35``."""
    rng = np.random.default_rng(0)
    xy = rng.uniform([0, 0], [1, 1], size=(9000, 2))
    r = np.linalg.norm(xy - [0.3, 0.5], axis=1)
    xy = xy[r > 0.05][:8000]
    metric = np.exp(-((xy[:, 0] - .6) ** 2 + (xy[:, 1] - .5) ** 2)
                    / .05) + 0.01
    return xy, metric


def _geoms_2d(pkg):
    return [pkg.CubeGeometry("domain", True, [0, 0], [1, 1]),
            pkg.SphereGeometry("hole", False, [0.3, 0.5], 0.05)]


def _cloud_3d_void():
    """3D cloud whose void (r < 0.2) is wider than the obstacle (r = 0.12):
    cells between the two have valid queries the 3^d neighbourhood cannot
    answer, which exercises the ring rescue of bad queries."""
    rng = np.random.default_rng(3)
    xyz = rng.uniform(0, 1, size=(7000, 3))
    xyz = xyz[np.linalg.norm(xyz - 0.4, axis=1) > 0.2][:6000]
    metric = np.exp(-((xyz - [0.6, 0.5, 0.5]) ** 2).sum(1) / 0.05) + 0.01
    return xyz, metric


def _geoms_3d(pkg):
    return [pkg.CubeGeometry("domain", True, [0, 0, 0], [1, 1, 1]),
            pkg.SphereGeometry("ball", False, [0.4, 0.4, 0.4], 0.12,
                               refine=True, min_refinement_level=5)]


def _cloud_airfoil():
    """``chip_smoke.py``'s OAT15 cloud (``bench.py:233-272``) at 12,000
    points around the 240-vertex airfoil."""
    xy, metric, _ = synthetic_oat15(12_000)
    return xy, metric


def _geoms_airfoil(pkg):
    return [pkg.CubeGeometry("domain", True, [-0.5, -0.5], [1.5, 0.5]),
            pkg.GeometryCoordinates2D("airfoil", False, airfoil_polygon(),
                                      refine=True)]


def _cloud_3d_cylinder():
    """A 3D cloud with a cylindrical hole along z (r < 0.12) around the
    cylinder obstacle (r = 0.1)."""
    rng = np.random.default_rng(4)
    xyz = rng.uniform(0, 1, size=(8000, 3))
    xyz = xyz[np.linalg.norm(xyz[:, :2] - [0.4, 0.5], axis=1) > 0.12][:6000]
    metric = np.exp(-((xyz[:, :2] - [0.65, 0.5]) ** 2).sum(1) / 0.03) + 0.01
    return xyz, metric


def _geoms_3d_cylinder(pkg):
    return [pkg.CubeGeometry("domain", True, [0, 0, 0], [1, 1, 1]),
            pkg.CylinderGeometry3D("cylinder", False,
                                   [[0.4, 0.5, 0.0], [0.4, 0.5, 1.0]], 0.1,
                                   refine=True, min_refinement_level=5)]


def _geoms_2d_refined(pkg):
    return [pkg.CubeGeometry("domain", True, [0, 0], [1, 1]),
            pkg.SphereGeometry("hole", False, [0.3, 0.5], 0.05, refine=True,
                               min_refinement_level=7)]


CASES = {
    "2d-cells": (_cloud_2d_hole, _geoms_2d,
                 {"uniform_levels": 3, "n_cells_max": 2000}),
    "2d-metric": (_cloud_2d_hole, _geoms_2d,
                  {"uniform_levels": 3, "min_metric": 0.9}),
    "3d-void-sphere-refine": (_cloud_3d_void, _geoms_3d,
                              {"uniform_levels": 2, "n_cells_max": 1500}),
    "2d-airfoil-preselect-refine": (_cloud_airfoil, _geoms_airfoil,
                                    {"uniform_levels": 5,
                                     "n_cells_max": 3000,
                                     "pre_select_cells": True}),
    "3d-cylinder-refine": (_cloud_3d_cylinder, _geoms_3d_cylinder,
                           {"uniform_levels": 3, "n_cells_max": 1500}),
    "2d-max-delta-level-refine": (_cloud_2d_hole, _geoms_2d_refined,
                                  {"uniform_levels": 3, "n_cells_max": 2000,
                                   "max_delta_level": True}),
}


def _run(pkg, pts, metric, geoms, **kwargs):
    extra = {"device": "cpu"} if pkg is tpkg else {}
    s3 = pkg.SparseSpatialSampling(pts, metric, geoms(pkg),
                                   save_path=tempfile.mkdtemp(),
                                   save_name="g", **kwargs, **extra)
    s3.execute_grid_generation()
    return s3


def _grid_key(s3):
    c = np.asarray(s3.centers)
    lv = np.asarray(s3.levels).ravel()
    order = np.lexsort((lv,) + tuple(c.T))
    return c[order], lv[order]


@pytest.fixture(scope="module")
def grids():
    """Both packages' grids of every case, built once per module with the
    grid kNN path forced on (``GRID_MIN_POINTS`` = 1000)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxKNN, "GRID_MIN_POINTS", 1000)
        mp.setattr(TorchKNN, "GRID_MIN_POINTS", 1000)
        for name, (cloud, geoms, kwargs) in CASES.items():
            pts, metric = cloud()
            out[name] = (pts, metric, _run(jpkg, pts, metric, geoms, **kwargs),
                         _run(tpkg, pts, metric, geoms, **kwargs))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_grid_matches_jax(grids, case):
    _, _, a, b = grids[case]
    ca, la = _grid_key(a)
    cb, lb = _grid_key(b)
    assert ca.shape == cb.shape
    np.testing.assert_array_equal(lb, la)
    np.testing.assert_array_equal(cb, ca)
    np.testing.assert_array_equal(np.asarray(b.faces).shape,
                                  np.asarray(a.faces).shape)
    assert (b.data_final_mesh["iterations"]
            == a.data_final_mesh["iterations"])
    np.testing.assert_allclose(b.data_final_mesh["metric_per_iter"],
                               a.data_final_mesh["metric_per_iter"],
                               rtol=1e-5)
    if case == "3d-void-sphere-refine":
        # the ring re-answered the grid's bad queries and changed nothing
        assert b.data_final_mesh["epoch_stats"]["ring_queries"] > 0


def _oracle_case(points, metric, obstacle, max_delta_level=False,
                 **kwargs):
    """The port, the oracle and the JAX package on one case; the 2:1
    balance is on with ``max_delta_level``."""
    d = points.shape[1]
    lo, hi = [0.0] * d, [1.0] * d

    def geoms(pkg):
        out = [pkg.CubeGeometry("domain", True, lo, hi)]
        if obstacle is not None:
            center, radius, refine, min_level = obstacle
            out.append(pkg.SphereGeometry("hole", False, center, radius,
                                          refine=refine,
                                          min_refinement_level=min_level))
        return out
    o_geoms = [OracleGeometry("domain", True, cube_inside(lo, hi),
                              main_width=1.0, center=np.full(d, 0.5))]
    if obstacle is not None:
        center, radius, refine, min_level = obstacle
        o_geoms.append(OracleGeometry("hole", False,
                                      sphere_inside(center, radius),
                                      refine=refine,
                                      min_refinement_level=min_level))
    kwargs["max_delta_level"] = max_delta_level
    s3 = _run(tpkg, points, metric, geoms, **kwargs)
    return (s3, OracleS3(points, metric, o_geoms, **kwargs).refine(),
            _run(jpkg, points, metric, geoms, **kwargs))


@pytest.mark.parametrize("cloud,obstacle,kwargs", [
    (lambda: _cloud_2d(), None,
     dict(uniform_levels=2, min_metric=0.9, n_cells_iter_start=10)),
    (lambda: _cloud_2d(seed=2), ([0.35, 0.5], 0.08, True, 5),
     dict(uniform_levels=2, n_cells_max=400, n_cells_iter_start=12)),
    (lambda: _cloud_3d(), ([0.3, 0.3, 0.3], 0.1, False, None),
     dict(uniform_levels=1, min_metric=0.8, n_cells_iter_start=8)),
    (lambda: _cloud_2d(seed=3), ([0.35, 0.5], 0.08, True, 5),
     dict(uniform_levels=2, min_metric=0.85, max_delta_level=True,
          n_cells_iter_start=10)),
    (lambda: _cloud_2d(seed=5), ([0.35, 0.5], 0.08, True, 5),
     dict(uniform_levels=2, n_cells_max=500, max_delta_level=True,
          n_cells_iter_start=12)),
    (lambda: _cloud_3d(seed=9), ([0.3, 0.3, 0.3], 0.1, True, 3),
     dict(uniform_levels=1, n_cells_max=300, max_delta_level=True,
          n_cells_iter_start=8)),
], ids=["2d-metric", "2d-cells-geometry-refinement", "3d-metric",
        "2d-max-delta-level", "2d-cells-max-delta-level",
        "3d-max-delta-level-geometry"])
def test_oracle_parity(cloud, obstacle, kwargs):
    points, metric = cloud()
    s3, oracle, jax_s3 = _oracle_case(points, metric, obstacle, **kwargs)
    _assert_identical(s3, oracle)
    ca, la = _grid_key(jax_s3)
    cb, lb = _grid_key(s3)
    np.testing.assert_array_equal(lb, la)
    np.testing.assert_array_equal(cb, ca)
    assert (s3.data_final_mesh["iterations"]
            == jax_s3.data_final_mesh["iterations"])
    if kwargs.get("max_delta_level"):
        _assert_balanced(s3)


def _assert_balanced(s3):
    """No two leaves that share a face, an edge or a corner differ by more
    than one level: the 2:1 balance ``max_delta_level`` keeps (domain
    [0, 1]^d, so the lattice starts at 0)."""
    assert unbalanced(np.asarray(s3.centers), s3.levels, 0.0,
                      s3.size_initial_cell) == 0


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("case", ["2d-cells", "3d-void-sphere-refine"])
def test_export_matches_jax(grids, case):
    pts, metric, a, b = grids[case]
    n_snap = 3
    rng = np.random.default_rng(7)
    scalar = (metric[:, None] * (1 + 0.3 * rng.normal(size=n_snap))
              ).astype(np.float32)[:, None, :]
    vector = np.stack([np.sin(4 * pts[:, 0]), np.cos(3 * pts[:, 1])],
                      axis=1)[:, :, None] * np.ones(n_snap)
    times = [f"{0.1 * (i + 1):.1f}" for i in range(n_snap)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxKNN, "GRID_MIN_POINTS", 1000)
        mp.setattr(TorchKNN, "GRID_MIN_POINTS", 1000)
        for s3, extra in ((a, {}), (b, {"device": "cpu"})):
            pkg = tpkg if s3 is b else jpkg
            pkg.ExportData(s3, write_times=times,
                           interpolate_at_vertices=True, **extra).export(
                pts, scalar, "p", n_snapshots_total=n_snap)
            pkg.ExportData(s3, write_times=times, append_existing=True,
                           **extra).export(pts, vector, "u")
    ja = _h5_items(join(a.save_path, "g.h5"))
    tb = _h5_items(join(b.save_path, "g.h5"))
    assert sorted(tb) == sorted(ja)
    assert tb["constant/metric"].dtype == np.float64
    for key in ja:
        assert tb[key].dtype == ja[key].dtype, key
        np.testing.assert_array_equal(tb[key], ja[key], err_msg=key)
    root = ET.parse(join(b.save_path, "g.xdmf")).getroot()
    assert len(root.findall(".//Grid[@GridType='Uniform']")) == n_snap
    loaded = tpkg.Dataloader(b.save_path, "g.h5").load_snapshot("u")
    assert loaded.shape == (b.centers.shape[0], 2, n_snap)


def test_interpolate_returns_the_field_and_writes_nothing(grids):
    pts, metric, _, b = grids["2d-cells"]
    data = (metric[:, None, None] * [[1.0, 0.5]]).astype(np.float32)
    saved = {p.name for p in Path(b.save_path).iterdir()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TorchKNN, "GRID_MIN_POINTS", 1000)
        field = tpkg.ExportData(b, device="cpu").interpolate(pts, data)
        w, idx = TorchKNN(pts, device="cpu").weights(b.centers, 8)
    assert {p.name for p in Path(b.save_path).iterdir()} == saved
    assert field.shape == (b.centers.shape[0], 1, 2)
    np.testing.assert_allclose(field, np.einsum("mk,mkcs->mcs", w, data[idx]),
                               rtol=1e-6, atol=1e-7)


def test_checkpoint_round_trip(grids):
    b = grids["2d-cells"][3]
    s = tpkg.load_s_cube(join(b.save_path, "s_cube_g.pt"))
    np.testing.assert_array_equal(s.centers, b.centers)
    assert not hasattr(s, "_knn_index")
    info = torch.load(join(b.save_path, "mesh_info_g.pt"),
                      weights_only=False)
    assert info["n_cells"] == b.centers.shape[0]


