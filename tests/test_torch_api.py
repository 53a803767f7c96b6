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
  with ``chunk_size=7`` on the same grid and data bit for bit, dtype
  included (as ``tests/test_torch_pipeline.py`` compares).
- Every public property and dunder of a class of the JAX package's
  ``__all__`` is in the port's class; ``SamplingTree``'s ``__len__``,
  ``n_dimensions``, ``width`` and ``geometry`` give the JAX package's
  values on one grid, and ``mesh_info`` holds every key of the JAX
  package's (``renumber_split`` among them).
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
from sparsespatialsampling_tpu.engine.tree import (  # noqa: E402
    SamplingTree as JaxTree)
from sparsespatialsampling_torch.engine.tree import (  # noqa: E402
    SamplingTree as TorchTree)
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


# the classes whose surface is compared: those of ``__all__`` and the engine
CLASSES = [(name, getattr(jpkg, name), getattr(tpkg, name))
           for name in jpkg.__all__ if inspect.isclass(getattr(jpkg, name))]
CLASSES.append(("SamplingTree", JaxTree, TorchTree))
# class attributes Python itself sets, not the package's surface
_NOT_SURFACE = {"__module__", "__doc__", "__dict__", "__weakref__",
                "__qualname__", "__firstlineno__", "__static_attributes__",
                "__init__", "__abstractmethods__", "__annotations__",
                "__slots__", "__parameters__", "__orig_bases__"}


def _surface(cls) -> set:
    """The public properties of ``cls`` and the dunders it or its bases
    define."""
    props = {name for name, value in inspect.getmembers(cls)
             if isinstance(value, property) and not name.startswith("_")}
    dunders = {name for base in cls.__mro__ if base is not object
               for name in vars(base)
               if name.startswith("__") and name.endswith("__")
               and name not in _NOT_SURFACE}
    return props | dunders


SURFACE = sorted((name, member) for name, jcls, _ in CLASSES
                 for member in _surface(jcls))


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


@pytest.mark.parametrize("cls_name,member", SURFACE,
                         ids=[f"{c}.{m}" for c, m in SURFACE])
def test_public_property_or_dunder(cls_name, member):
    theirs = dict((n, j) for n, j, _ in CLASSES)[cls_name]
    ours = dict((n, t) for n, _, t in CLASSES)[cls_name]
    assert hasattr(ours, member), f"{cls_name}.{member} is not in the port"
    if isinstance(inspect.getattr_static(theirs, member), property):
        assert isinstance(inspect.getattr_static(ours, member), property)


def _geometries(pkg):
    return [pkg.CubeGeometry("c", True, [0, 0], [1, 1]),
            pkg.SphereGeometry("s", False, [0.3, 0.5], 0.05),
            pkg.CylinderGeometry3D("y", False, [[0.4, 0.5, 0.0],
                                                [0.4, 0.5, 1.0]], [0.1, 0.2]),
            pkg.TriangleGeometry("t", False, [[0.1, 0.2], [0.9, 0.3],
                                              [0.4, 0.8]]),
            pkg.TetrahedronGeometry3D("te", True, [[0.1, 0.1, 0.1],
                                                   [0.9, 0.2, 0.1],
                                                   [0.3, 0.8, 0.2],
                                                   [0.4, 0.4, 0.9]]),
            pkg.PrismGeometry3D("p", False, [[[0.1, 0.2, 0.1], [0.5, 0.2, 0.1],
                                              [0.3, 0.6, 0.1]],
                                             [[0.1, 0.2, 0.9], [0.5, 0.2, 0.9],
                                              [0.3, 0.6, 0.9]]]),
            pkg.PyramidGeometry3D("py", False, [[0.1, 0.1, 0.1],
                                                [0.9, 0.1, 0.1],
                                                [0.9, 0.9, 0.1],
                                                [0.1, 0.9, 0.1],
                                                [0.5, 0.5, 0.9]]),
            pkg.GeometryCoordinates2D("g", False, [[0.1, 0.1], [0.9, 0.1],
                                                   [0.5, 0.9]])]


def test_geometry_cache_key_is_the_jax_digest():
    ours, theirs = _geometries(tpkg), _geometries(jpkg)
    for a, b in zip(ours, theirs):
        assert a.cache_key == b.cache_key is not None, type(a).__name__
        assert a.__short_description__ == b.__short_description__
    assert len({g.cache_key for g in ours}) == len(ours)


def test_sampling_tree_surface_and_mesh_info():
    """``len(tree)`` (the cells created, parents included), the
    properties and the ``mesh_info`` keys against the JAX package's on
    one small grid."""
    rng = np.random.default_rng(12)
    xy = rng.uniform(0, 1, size=(2500, 2))
    metric = np.exp(-((xy - [0.4, 0.6]) ** 2).sum(1) / 0.05) + 0.01
    out = {}
    for pkg in (jpkg, tpkg):
        extra = {"device": "cpu"} if pkg is tpkg else {}
        geo = [pkg.CubeGeometry("domain", True, [0, 0], [1, 1]),
               pkg.SphereGeometry("hole", False, [0.5, 0.5], 0.1)]
        s3 = pkg.SparseSpatialSampling(
            xy, metric, geo, save_path=tempfile.mkdtemp(), save_name="g",
            uniform_levels=3, n_cells_max=300, **extra)
        tree = s3._sampling
        s3.execute_grid_generation()
        out[pkg] = (tree, s3)
    (jt, js3), (tt, ts3) = out[jpkg], out[tpkg]
    assert len(tt) == len(jt) > ts3.centers.shape[0]
    assert tt.n_dimensions == jt.n_dimensions == 2
    assert tt.width == jt.width
    assert [g.name for g in tt.geometry] == [g.name for g in jt.geometry]
    assert set(js3.data_final_mesh) <= set(ts3.data_final_mesh)
    split = ts3.data_final_mesh["renumber_split"]
    assert set(split) == set(js3.data_final_mesh["renumber_split"]) == {
        "t_pre", "t_keys", "t_unique", "t_emit"}
    assert all(v >= 0.0 for v in split.values())


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
        np.testing.assert_array_equal(want, jax_value, err_msg=key)
    with pytest.raises(ValueError, match="chunk_size"):
        tpkg.ExportData(s3, write_times=times, device="cpu").interpolate(
            xy, data, chunk_size=0)
