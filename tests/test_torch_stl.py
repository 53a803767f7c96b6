"""The port's STL geometry against the JAX package's.

- ``read_stl``/``write_stl`` (binary and ASCII) and ``decimate`` give the
  JAX package's bytes and arrays; ``reduce_by`` writes the same reduced file.
- ``build_sign_grid`` (state, origin, inverse voxel size, dims) and
  ``build_fast_winding`` tables are the JAX package's bit for bit, on the
  5,664-triangle sphere.
- The plain winding number and the fast winding number agree with the JAX
  package's ``_winding_number`` and ``_fast_winding`` to 1e-4, flags equal.
- ``mask_points`` and ``check_cells`` (both modes, both polarities, exact
  and fast-winding routes) equal the JAX package's on the point sets of
  ``tests/test_geometry.py:389-395`` and ``:517-524``; the unit-cube truth
  table and the holed-sphere contract of ``tests/test_geometry.py`` hold.
- A geometry pickled through ``torch.save`` carries no tensor and answers
  the same after ``torch.load``.
- Grids of the port's host loop (``SamplingTree.DEVICE_LOOP = False``)
  with an STL obstacle equal the JAX package's host loop
  (``S3_TPU_DEVICE_LOOP=0``) cell for cell: the
  360-triangle sphere of ``tests/test_device_loop.py:286-325``, the same
  with ``pre_select_cells`` and the sphere refined to level 5, and the
  huge-table route (``_FUSED_GEO_BYTES = 0`` in both packages).  Each run
  asserts that every winding number its inside tests computed lies at
  least 1e-3 from the 0.5 threshold, so that the two packages' roundings
  cannot have decided a flag differently.
- The kernel wrapper raises rather than falling back for a CUDA tensor it
  cannot launch on; on the card the kernel equals its plain version
  (``cuda`` marker; skips here).
"""
import logging
import tempfile
from os.path import join
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparsespatialsampling_tpu as jpkg  # noqa: E402
import sparsespatialsampling_tpu.engine.tree as jtree  # noqa: E402
from sparsespatialsampling_tpu.geometry import stl as jstl  # noqa: E402
from sparsespatialsampling_tpu.ops.knn import KNNIndex as JaxKNN  # noqa: E402
import sparsespatialsampling_torch as tpkg  # noqa: E402
import sparsespatialsampling_torch.engine.tree as ttree  # noqa: E402
from sparsespatialsampling_torch import _build  # noqa: E402
from sparsespatialsampling_torch.geometry import stl as tstl  # noqa: E402
from sparsespatialsampling_torch.ops import winding  # noqa: E402
from sparsespatialsampling_torch.ops.knn import (  # noqa: E402
    KNNIndex as TorchKNN)
from bench import synthetic_sphere_stl  # noqa: E402

from .const import DummyCells  # noqa: E402

CELLS = DummyCells()
# least distance of a winding number from the 0.5 threshold in a grid run
MARGIN = 1e-3


@pytest.fixture(scope="module")
def sphere_stl(tmp_path_factory):
    """The watertight 5,664-triangle sphere of ``tests/test_geometry.py``
    (radius 0.05 at (0.2, 0.2, 0.2))."""
    path = str(tmp_path_factory.mktemp("stl") / "sphere.stl")
    assert synthetic_sphere_stl(path, n_lat=60, n_lon=48) == 5664
    return path


@pytest.fixture(scope="module")
def pair(sphere_stl):
    """The port's and the JAX package's obstacle on the sphere."""
    return (tpkg.GeometrySTL3D("sphere", False, sphere_stl, device="cpu"),
            jpkg.GeometrySTL3D("sphere", False, sphere_stl))


def _cube_triangles():
    """The unit cube of ``tests/test_geometry.py:315``: 12 outward
    triangles."""
    v = np.asarray([[x, y, z] for z in (0, 1) for y in (0, 1)
                    for x in (0, 1)], dtype=np.float64)
    faces = [(0, 2, 1), (1, 2, 3), (4, 5, 6), (5, 7, 6), (0, 1, 4), (1, 5, 4),
             (2, 6, 3), (3, 6, 7), (0, 4, 2), (2, 4, 6), (1, 3, 5), (3, 7, 5)]
    return np.stack([v[list(f)] for f in faces])


@pytest.fixture
def cube_stl(tmp_path):
    path = str(tmp_path / "cube.stl")
    tstl.write_stl(path, _cube_triangles())
    return path


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


# --------------------------------------------------------------------------- #
# host I/O                                                                     #
# --------------------------------------------------------------------------- #
def _ascii_stl(tris) -> str:
    lines = ["solid s"]
    for t in tris:
        lines += ["facet normal 0 0 0", " outer loop"]
        lines += [f"  vertex {float(x)!r} {float(y)!r} {float(z)!r}"
                  for x, y, z in t]
        lines += [" endloop", "endfacet"]
    return "\n".join(lines + ["endsolid s"]) + "\n"


@pytest.mark.parametrize("form", ["binary", "ascii"])
def test_read_write_match_jax(sphere_stl, tmp_path, form):
    tris = jstl.read_stl(sphere_stl)
    if form == "ascii":
        path = tmp_path / "s.stl"
        path.write_text(_ascii_stl(tris[:100]))
        path = str(path)
    else:
        path = sphere_stl
    got, want = tstl.read_stl(path), jstl.read_stl(path)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    tstl.write_stl(str(tmp_path / "t.stl"), got)
    jstl.write_stl(str(tmp_path / "j.stl"), want)
    assert ((tmp_path / "t.stl").read_bytes()
            == (tmp_path / "j.stl").read_bytes())


@pytest.mark.parametrize("reduce_by", [0.0, 0.3, 0.8])
def test_decimate_matches_jax(sphere_stl, reduce_by):
    tris = jstl.read_stl(sphere_stl)
    got = tstl.decimate(tris, reduce_by)
    np.testing.assert_array_equal(got, jstl.decimate(tris, reduce_by))
    assert got.shape[0] <= tris.shape[0]


def test_reduce_by_writes_the_jax_reduced_file(sphere_stl, tmp_path):
    src = tmp_path / "ball.stl"
    src.write_bytes(Path(sphere_stl).read_bytes())
    reduced = tmp_path / "ball._reduced_by_Scube.stl"
    jg = jpkg.GeometrySTL3D("b", False, str(src), reduce_by=0.5)
    want = reduced.read_bytes()
    reduced.unlink()
    tg = tpkg.GeometrySTL3D("b", False, str(src), reduce_by=0.5,
                            device="cpu")
    assert reduced.read_bytes() == want
    np.testing.assert_array_equal(tg.triangles, jg.triangles)
    assert tg.device_table_bytes == jg.device_table_bytes


@pytest.mark.parametrize("reduce_by,message", [
    (-0.5, "invalid negative value"), (1.5, "Correcting to 0.99")])
def test_reduce_by_out_of_range_warns(cube_stl, caplog, reduce_by, message):
    with caplog.at_level(logging.WARNING, logger="sparsespatialsampling_torch"):
        g = tpkg.GeometrySTL3D("c", False, cube_stl, reduce_by=reduce_by,
                               device="cpu")
    assert any(message in r.message for r in caplog.records)
    assert g.triangles.shape == (12, 3, 3)


def test_many_triangles_warn(sphere_stl, caplog, monkeypatch):
    g = tpkg.GeometrySTL3D("s", False, sphere_stl, device="cpu")
    monkeypatch.setattr(g, "_triangles",
                        np.concatenate([g.triangles] * 9))
    with caplog.at_level(logging.WARNING, logger="sparsespatialsampling_torch"):
        g._check_geometry()
    assert any("Consider using 'reduce_by'" in r.message
               for r in caplog.records)


def test_geometry_attributes_match_jax(pair):
    g, ref = pair
    for got, want in zip(g.bounding_box(), ref.bounding_box()):
        np.testing.assert_array_equal(got, want)
    assert g.main_width == ref.main_width
    np.testing.assert_array_equal(g.center, ref.center)
    np.testing.assert_array_equal(g.triangles, ref.triangles)
    assert g.type == ref.type == "STL"
    assert g.device_table_bytes == ref.device_table_bytes > 0


# --------------------------------------------------------------------------- #
# tables                                                                       #
# --------------------------------------------------------------------------- #
def test_sign_grid_matches_jax(pair):
    g, ref = pair
    for key in ("state", "origin", "inv_h", "dims"):
        got, want = np.asarray(g._sg[key]), np.asarray(ref._sg[key])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert g._sg["n_near_vox"] == ref._sg["n_near_vox"]
    assert g._sg["n_vox"] == ref._sg["n_vox"]
    assert 0 < g._sg["n_near_vox"] < g._sg["n_vox"]


def test_fast_winding_tables_match_jax(pair):
    tris = pair[0].triangles
    got, want = tstl.build_fast_winding(tris), jstl.build_fast_winding(tris)
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        assert np.asarray(got[key]).dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def _fw_points():
    """The points of ``tests/test_geometry.py:389-395``: uniform in the
    domain, a shell at 0.9-1.1 radii and the inner ball."""
    rng = np.random.default_rng(4)
    far = rng.uniform([0, 0, 0], [0.6, 0.4, 0.4], size=(256, 3))
    rd = rng.normal(size=(256, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    near = 0.2 + rd * (0.05 * rng.uniform(0.9, 1.1, size=(256, 1)))
    inner = 0.2 + rd * (0.05 * rng.uniform(0.0, 0.85, size=(256, 1)))
    return np.concatenate([far, near, inner]).astype(np.float32)


def _sg_points():
    """The points of ``tests/test_geometry.py:517-524``: around the
    sphere, across its shell, and far out of the grid."""
    rng = np.random.default_rng(11)
    return np.concatenate([
        rng.uniform(0.1, 0.3, size=(4000, 3)),
        0.2 + rng.normal(size=(1000, 3)) * 0.05,
        rng.uniform(-2.0, 3.0, size=(200, 3)),
    ]).astype(np.float32)


POINTS = {"fast-winding-set": _fw_points, "sign-grid-set": _sg_points}


def _pad(pts, chunk, fill=0.0):
    m = pts.shape[0]
    out = np.full((-(-m // chunk) * chunk, 3), fill, np.float32)
    out[:m] = pts
    return jnp.asarray(out)


def _jax_exact(ref, pts):
    return np.asarray(jstl._winding_number(
        _pad(pts, jstl._POINT_CHUNK, 1e6), ref._v0, ref._v1,
        ref._v2))[:pts.shape[0]]


@pytest.mark.parametrize("points", list(POINTS))
def test_winding_plain_matches_jax(pair, points):
    g, ref = pair
    pts = POINTS[points]()
    tris = g.triangles
    got = winding.winding_number(torch.from_numpy(pts),
                                 *[torch.from_numpy(_f32(tris[:, i]))
                                   for i in range(3)]).numpy()
    want = _jax_exact(ref, pts)
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got > 0.5, want > 0.5)
    assert 0 < (got > 0.5).sum() < got.size


@pytest.mark.parametrize("points", list(POINTS))
def test_fast_winding_matches_jax(pair, points):
    tris = pair[0].triangles
    pts = POINTS[points]()
    fw = jstl.build_fast_winding(tris)
    want = np.asarray(jstl._fast_winding(
        _pad(pts, jstl._FW_CHUNK), fw["cell_tris"], fw["v0"], fw["v1"],
        fw["v2"], fw["resid"], fw["clus_cell"], fw["clus_cent"],
        fw["clus_an"], fw["origin"], fw["inv_h"], fw["dims"]))[:len(pts)]
    g = _fw_geometry(pair[0])
    got = tstl._fast_winding(torch.from_numpy(pts),
                             g._tables(torch.device("cpu"))["fw"]).numpy()
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got > 0.5, want > 0.5)


def _fw_geometry(g, keep_inside=False):
    """A geometry on ``g``'s file that takes the fast-winding route."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstl, "_FW_MIN_TRIS", 4096)
        out = tpkg.GeometrySTL3D("fw", keep_inside, g._pwd, device="cpu")
    assert out._fw is not None
    return out


def _cells(pts):
    """Each point the first corner of a cell one level-9 step wide."""
    offs = np.stack(np.meshgrid(*([[0.0, 1.0]] * 3), indexing="ij"),
                    -1).reshape(-1, 3)
    return (pts[:, None, :].astype(np.float64)
            + offs[None] / 2 ** 9).astype(np.float32)


@pytest.mark.parametrize("route", ["exact", "fast-winding"])
@pytest.mark.parametrize("points", list(POINTS))
def test_mask_and_cells_match_jax(sphere_stl, monkeypatch, points, route):
    if route == "fast-winding":
        monkeypatch.setattr(tstl, "_FW_MIN_TRIS", 4096)
        monkeypatch.setattr(jstl, "_FW_MIN_TRIS", 4096)
    pts = POINTS[points]()
    cells = _cells(pts[::4])
    for keep in (False, True):
        g = tpkg.GeometrySTL3D("s", keep, sphere_stl, device="cpu")
        ref = jpkg.GeometrySTL3D("s", keep, sphere_stl)
        assert (g._fw is not None) == (route == "fast-winding")
        got = g.mask_points(pts)
        want = np.asarray(ref.mask_points(pts))
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < want.size
        # f64 input is tested in f32, as the JAX package casts it
        np.testing.assert_array_equal(
            g.mask_points(pts.astype(np.float64)), want)
        for refine in (False, True):
            np.testing.assert_array_equal(
                g.check_cells(cells, refine),
                np.asarray(ref.check_cells(cells, refine)))


@pytest.mark.parametrize("keep_inside,cell,expected", [
    (False, "outside", False), (False, "partially", False),
    (True, "outside", True), (True, "partially", False),
])
def test_unit_cube_truth_table(cube_stl, keep_inside, cell, expected):
    g = tpkg.GeometrySTL3D("stl", keep_inside, cube_stl, device="cpu")
    assert g.check_cell(CELLS.cells_3D[cell]) is expected
    assert (jpkg.GeometrySTL3D("stl", keep_inside, cube_stl)
            .check_cell(CELLS.cells_3D[cell]) is expected)


def test_unit_cube_points_and_batches(cube_stl):
    g = tpkg.GeometrySTL3D("stl", False, cube_stl, device="cpu")
    pts = np.asarray([[0.5, 0.5, 0.5], [0.1, 0.9, 0.5], [1.5, 0.5, 0.5],
                      [-0.1, 0.5, 0.5]])
    assert g.mask_points(pts).tolist() == [True, True, False, False]
    assert g.pre_check_cell(CELLS.cell_outside_3D) is False
    cells = np.stack([CELLS.cell_outside_3D, CELLS.cell_partially_3D])
    assert g.check_cells(cells).tolist() == [False, False]


def test_holed_sphere_warns_and_classifies(sphere_stl, tmp_path, caplog):
    """``tests/test_geometry.py:434-488``: a sphere with a polar cap
    removed is diagnosed and classified correctly away from the hole, as
    the JAX package classifies it."""
    tris = tstl.read_stl(sphere_stl)
    keep = tris.mean(axis=1)[:, 2] < 0.2 + 0.96 * 0.05
    assert (~keep).sum() > 10
    holed = str(tmp_path / "holed.stl")
    tstl.write_stl(holed, tris[keep])
    with caplog.at_level(logging.WARNING, logger="sparsespatialsampling_torch"):
        g = tpkg.GeometrySTL3D("holed", False, holed, device="cpu")
    assert any("not closed/manifold" in r.message for r in caplog.records)
    rng = np.random.default_rng(5)
    rd = rng.normal(size=(3000, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    pts = 0.2 + rd * rng.uniform(0.0, 2.0, size=(3000, 1)) * 0.05
    rr = np.linalg.norm(pts - 0.2, axis=1)
    d_hole = np.linalg.norm(pts - [0.2, 0.2, 0.25], axis=1)
    evaluated = (np.abs(rr - 0.05) > 1e-3) & (d_hole > 2 * 0.014)
    got = g.mask_points(pts)
    np.testing.assert_array_equal(got[evaluated], (rr < 0.05)[evaluated])
    np.testing.assert_array_equal(
        got, np.asarray(jpkg.GeometrySTL3D("holed", False, holed)
                        .mask_points(pts)))


def test_checkpoint_round_trip(pair, tmp_path):
    g = pair[0]
    pts = _sg_points()
    before = g.mask_points(torch.from_numpy(pts))
    assert g._device_tables
    torch.save(g, tmp_path / "g.pt")
    state = g.__getstate__()
    assert state["_device_tables"] == {}
    assert not any(isinstance(v, torch.Tensor) for v in state.values())
    loaded = torch.load(tmp_path / "g.pt", weights_only=False)
    assert loaded._device_tables == {}
    assert torch.equal(loaded.mask_points(torch.from_numpy(pts)), before)
    assert g._device_tables  # the original keeps its copies


# --------------------------------------------------------------------------- #
# the kernel wrapper                                                           #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bad", ["dtype", "shape", "unequal", "empty"])
def test_wrapper_rejects_bad_input(bad):
    p = torch.zeros(4, 3)
    v = torch.zeros(5, 3)
    args = {"dtype": (p.double(), v, v, v),
            "shape": (torch.zeros(4, 2), v, v, v),
            "unequal": (p, v, v, torch.zeros(6, 3)),
            "empty": (p, *(torch.zeros(0, 3),) * 3)}[bad]
    with pytest.raises((TypeError, ValueError)):
        winding.winding_number(*args)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    class CudaStandIn:
        """Quacks like a contiguous f32 CUDA [8, 3] tensor."""
        shape = (8, 3)
        dtype = torch.float32
        device = torch.device("cuda")

        def dim(self):
            return 2

        def is_contiguous(self):
            return True

    def plain_called(*_):
        raise AssertionError("plain version used for a CUDA tensor")
    monkeypatch.setattr(winding, "winding_number_plain", plain_called)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_library_path",
                        lambda src: Path("/nonexistent") / src.name)
    monkeypatch.setattr(winding, "_entry", None)
    before = winding.launches
    x = CudaStandIn()
    with pytest.raises(RuntimeError, match="nvcc"):
        winding.winding_number(x, x, x, x)
    assert winding.launches == before
    with pytest.raises(RuntimeError, match="no kernel"):
        winding.winding_number(*(torch.zeros(4, 3, device="meta"),) * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_points,n_tris", [
    (None, None),   # the sign-grid point set over the whole sphere
    (1, None),
    (15, None),     # the median near-band call of bench workload 4
    (37, 1003),     # a span and a point tile left partly empty
])
def test_kernel_matches_plain_on_card(pair, n_points, n_tris):
    """The kernel equals its plain version to 1e-6, and a point's ``w`` is
    bitwise the same in a shuffled batch and in a prefix batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tris = pair[0].triangles[:n_tris]
    v = [torch.from_numpy(_f32(tris[:, i])).cuda() for i in range(3)]
    pts = torch.from_numpy(_sg_points()[:n_points]).cuda()
    before = winding.launches
    got = winding.winding_number(pts, *v)
    want = winding.winding_number_plain(pts, *v)
    torch.cuda.synchronize()
    assert winding.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-6
    perm = torch.randperm(pts.shape[0], device="cuda")
    assert torch.equal(winding.winding_number(pts[perm], *v), got[perm])
    head = max(1, pts.shape[0] // 3)
    assert torch.equal(winding.winding_number(pts[:head], *v), got[:head])


@pytest.mark.cuda
def test_kernel_slices_give_the_whole_batch_on_card(pair, monkeypatch):
    """A batch whose partial sums exceed ``_PART_BYTES`` runs in slices of
    points, one launch each, and gives the unsliced ``w`` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tris = pair[0].triangles
    v = [torch.from_numpy(_f32(tris[:, i])).cuda() for i in range(3)]
    pts = torch.from_numpy(_sg_points()[:100]).cuda()
    whole = winding.winding_number(pts, *v)
    spans = -(-tris.shape[0] // 256)
    monkeypatch.setattr(winding, "_PART_BYTES", 8 * spans * 7)
    before = winding.launches
    assert torch.equal(winding.winding_number(pts, *v), whole)
    assert winding.launches == before + 15


# --------------------------------------------------------------------------- #
# grids                                                                        #
# --------------------------------------------------------------------------- #
def _sphere_cloud():
    """The cloud of ``tests/test_device_loop.py:304-309``."""
    rng = np.random.default_rng(3)
    xyz = rng.uniform([0, 0, 0], [0.6, 0.4, 0.4], size=(7000, 3))
    xyz = xyz[np.linalg.norm(xyz - 0.2, axis=1) > 0.05][:6000]
    metric = np.exp(-np.maximum(np.linalg.norm(xyz - 0.2, axis=1) - 0.05,
                                0) / 0.1) + 0.01
    return xyz, metric


GRID_CASES = {
    "sphere360": ({}, {}, False),
    "sphere360-preselect-refine5": (
        {"refine": True, "min_refinement_level": 5},
        {"pre_select_cells": True}, False),
    "sphere360-huge-table-refine5": (
        {"refine": True, "min_refinement_level": 5}, {}, True),
}


@pytest.fixture(scope="module")
def sphere360(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("s360") / "sphere.stl")
    assert synthetic_sphere_stl(path, n_lat=16, n_lon=12) == 360
    return path


def _grid_key(s3):
    c = np.asarray(s3.centers)
    lv = np.asarray(s3.levels).ravel()
    order = np.lexsort((lv,) + tuple(c.T))
    return c[order], lv[order]


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_grid_matches_jax(sphere360, monkeypatch, case):
    stl_kw, kw, huge = GRID_CASES[case]
    monkeypatch.setattr(JaxKNN, "GRID_MIN_POINTS", 1000)
    monkeypatch.setattr(TorchKNN, "GRID_MIN_POINTS", 1000)
    monkeypatch.setenv("S3_TPU_DEVICE_LOOP", "0")
    monkeypatch.setattr(ttree.SamplingTree, "DEVICE_LOOP", False)
    if huge:
        monkeypatch.setattr(jtree, "_FUSED_GEO_BYTES", 0)
        monkeypatch.setattr(ttree, "_FUSED_GEO_BYTES", 0)
    seen = []
    route = tstl.GeometrySTL3D._winding

    def recorded(self, *args):
        w = route(self, *args)
        seen.append(w)
        return w
    monkeypatch.setattr(tstl.GeometrySTL3D, "_winding", recorded)
    xyz, metric = _sphere_cloud()
    grids = []
    for pkg, extra in ((jpkg, {}), (tpkg, {"device": "cpu"})):
        s3 = pkg.SparseSpatialSampling(
            xyz, metric,
            [pkg.CubeGeometry("domain", True, [0, 0, 0], [0.6, 0.4, 0.4]),
             pkg.GeometrySTL3D("sphere", False, sphere360, **stl_kw,
                               **extra)],
            save_path=tempfile.mkdtemp(), save_name="s", uniform_levels=2,
            n_cells_max=1500, **kw, **extra)
        s3.execute_grid_generation()
        grids.append(s3)
    a, b = grids
    ca, la = _grid_key(a)
    cb, lb = _grid_key(b)
    np.testing.assert_array_equal(lb, la)
    np.testing.assert_array_equal(cb, ca)
    assert (b.data_final_mesh["iterations"]
            == a.data_final_mesh["iterations"])
    np.testing.assert_allclose(b.data_final_mesh["metric_per_iter"],
                               a.data_final_mesh["metric_per_iter"],
                               rtol=1e-5)
    w = torch.cat(seen)
    assert w.numel() > 0
    assert float((w - 0.5).abs().min()) >= MARGIN
    if stl_kw:
        assert int(lb.max()) == 5
    s = tpkg.load_s_cube(join(b.save_path, "s_cube_s.pt"))
    np.testing.assert_array_equal(s.centers, b.centers)
