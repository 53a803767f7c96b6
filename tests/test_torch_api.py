"""The port's public API against the JAX package's.

- Every name in the JAX package's ``__all__`` is in the port's
  (``NOT_YET_PORTED`` is empty); the port exports no name the JAX package
  lacks.
- Each public function there, and each public method of a class there
  (``__init__`` included), takes the JAX package's parameters first, with
  the same names, kinds and defaults; the port may add a trailing
  ``device=None``.  Annotations are not compared.
- ``TriangleGeometry.check_triangle`` and
  ``TetrahedronGeometry3D.check_tetrahedron`` give ``mask_points`` and the
  JAX package's flags.
- ``ExportData.export(..., chunk_size=7)`` writes the HDF5 datasets of
  ``chunk_size=None`` bit for bit, and those of the JAX package's export
  with ``chunk_size=7`` on the same grid and data (the grid bitwise, the
  fields to rtol 1e-6, as ``tests/test_torch_pipeline.py`` compares).
"""
import inspect
import tempfile
from os.path import join
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparsespatialsampling_tpu as jpkg  # noqa: E402
import sparsespatialsampling_torch as tpkg  # noqa: E402
from tests.test_torch_pipeline import _h5_items  # noqa: E402

# names of the JAX package's __all__ that the port does not have yet
NOT_YET_PORTED = set()

NAMES = sorted(jpkg.__all__)
METHODS = sorted(
    (cls_name, name)
    for cls_name in jpkg.__all__ if inspect.isclass(getattr(jpkg, cls_name))
    for name, _ in inspect.getmembers(
        getattr(jpkg, cls_name),
        lambda m: inspect.isfunction(m) or inspect.ismethod(m))
    if not name.startswith("_") or name == "__init__")


def _assert_parameters_start_alike(jax_fn, port_fn):
    """The port's parameters begin with the JAX package's (name, kind,
    default); any further one is ``device=None``."""
    def key(p):
        return p.name, p.kind, p.default
    jp = list(inspect.signature(jax_fn).parameters.values())
    tp = list(inspect.signature(port_fn).parameters.values())
    assert [key(p) for p in tp[:len(jp)]] == [key(p) for p in jp]
    assert [(p.name, p.default) for p in tp[len(jp):]] in (
        [], [("device", None)])


def test_not_yet_ported_names_are_exactly_the_missing_ones():
    assert set(jpkg.__all__) - set(tpkg.__all__) == NOT_YET_PORTED
    assert set(tpkg.__all__) <= set(jpkg.__all__)


@pytest.mark.parametrize("name", NAMES)
def test_public_name(name):
    assert name in tpkg.__all__
    ours, theirs = getattr(tpkg, name), getattr(jpkg, name)
    if inspect.isfunction(theirs):
        _assert_parameters_start_alike(theirs, ours)
    else:
        assert inspect.isclass(ours) == inspect.isclass(theirs)


@pytest.mark.parametrize("cls_name,method", METHODS,
                         ids=[f"{c}.{m}" for c, m in METHODS])
def test_public_method(cls_name, method):
    ours = getattr(getattr(tpkg, cls_name), method, None)
    assert ours is not None, f"{cls_name}.{method} is not in the port"
    _assert_parameters_start_alike(
        getattr(getattr(jpkg, cls_name), method), ours)


@pytest.mark.parametrize("cls_name,method,corners,dims", [
    ("TriangleGeometry", "check_triangle",
     [[0.1, 0.2], [0.9, 0.3], [0.4, 0.8]], 2),
    ("TetrahedronGeometry3D", "check_tetrahedron",
     [[0.1, 0.1, 0.1], [0.9, 0.2, 0.1], [0.3, 0.8, 0.2], [0.4, 0.4, 0.9]], 3),
])
def test_single_shape_check_is_mask_points(cls_name, method, corners, dims):
    pts = np.random.default_rng(0).uniform(0, 1, size=(4000, dims))
    ours = getattr(tpkg, cls_name)("s", False, corners)
    theirs = getattr(jpkg, cls_name)("s", False, corners)
    got = getattr(ours, method)(pts)
    np.testing.assert_array_equal(got, ours.mask_points(pts))
    np.testing.assert_array_equal(got,
                                  np.asarray(getattr(theirs, method)(pts)))
    assert 0 < got.sum() < pts.shape[0]


def test_export_chunk_size():
    rng = np.random.default_rng(11)
    xy = rng.uniform(0, 1, size=(3000, 2))
    metric = np.exp(-((xy - [0.6, 0.4]) ** 2).sum(1) / 0.05) + 0.01
    s3 = tpkg.SparseSpatialSampling(
        xy, metric, [tpkg.CubeGeometry("domain", True, [0, 0], [1, 1])],
        save_path=tempfile.mkdtemp(), save_name="g", uniform_levels=3,
        n_cells_max=400, device="cpu")
    s3.execute_grid_generation()
    data = (metric[:, None, None] * [[1.0, 0.5, -2.0]]
            + rng.normal(size=(xy.shape[0], 1, 3))).astype(np.float32)
    times = ["0.1", "0.2", "0.3"]
    files = {}
    for label, pkg, chunk in (("none", tpkg, None), ("seven", tpkg, 7),
                              ("jax", jpkg, 7)):
        grid = SimpleNamespace(
            n_dimensions=2, faces=s3.faces, centers=s3.centers,
            vertices=s3.vertices, levels=s3.levels, metric=s3.metric,
            size_initial_cell=s3.size_initial_cell,
            save_path=tempfile.mkdtemp(), save_name="g", grid_name="g")
        extra = {"device": "cpu"} if pkg is tpkg else {}
        pkg.ExportData(grid, write_times=times, interpolate_at_vertices=True,
                       **extra).export(xy, data, "p", n_snapshots_total=3,
                                       chunk_size=chunk)
        files[label] = _h5_items(join(grid.save_path, "g.h5"))
    assert files["none"].keys() == files["seven"].keys() == files["jax"].keys()
    for key, want in files["none"].items():
        np.testing.assert_array_equal(files["seven"][key], want, err_msg=key)
        jax_value = files["jax"][key]
        assert jax_value.dtype == want.dtype, key
        if key.startswith(("grid/", "constant/levels",
                           "constant/size_initial_cell")):
            np.testing.assert_array_equal(want, jax_value, err_msg=key)
        else:
            np.testing.assert_allclose(want, jax_value, rtol=1e-6, atol=1e-7,
                                       err_msg=key)
    with pytest.raises(ValueError, match="chunk_size"):
        tpkg.ExportData(s3, write_times=times, device="cpu").interpolate(
            xy, data, chunk_size=0)
