"""The port's multi-device layer (``sparsespatialsampling_torch/parallel``)
on the CPU, against the port's single-device path and the JAX package's
sharded path.

The port's sharded path runs on virtual meshes of the CPU
(``parallel.mesh.VIRTUAL_SHARDS``, set through ``monkeypatch``); the JAX
package's on the conftest's 8-device virtual CPU mesh, with
``S3_TPU_DISABLE_SHARDING`` removed where its entry points must shard (as
``tests/test_multichip_pipeline.py`` does).

- ``ShardedKNNIndex.query``, full and grid routes, 2D and 3D, over 1, 3
  and 8 shards (a shard count that divides the cloud and ones that pad
  it): bitwise the single-device ``KNNIndex.query``; on the JAX package's
  own layout (``sharded_index_from_reference``) the JAX ``ShardedKNNIndex``'s
  indices off ties and its distances to rtol 1e-6; on a lattice's exact
  ties the canonical order, where the JAX package's score order differs.
- ``sharded_interpolate``: bitwise the single-device interpolation and
  the host route's CSR product (``interpolate_host``), the JAX package's
  mesh ``einsum`` to rtol 1e-6.
- ``distributed_rsvd``: the JAX package's spectrum to 1e-3 and subspaces
  at cosines ≥ 0.999 (the sketches differ), no NaN on a rank-deficient
  input, orthonormal modes.
- The engine, 2D and 3D, on the ``shard_full`` and ``shard_grid`` cores:
  rows identical to the port's single-device tree, cells, levels and
  iterations identical to the JAX package's sharded tree with the metric
  trace to rtol 1e-5, the device loop engaged.
- The pipeline ``SparseSpatialSampling`` → ``ExportData`` →
  ``compute_svd`` (the distributed route): faces, levels and the export's
  neighbours bitwise the single-device run's; the export's weights the
  JAX package's sharded weights bit for bit (the single device's to rtol
  1e-4), its f64 metric and its fields bitwise the host formulas on those
  weights.  ``ShardedKNNIndex.weights`` likewise.
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import sparsespatialsampling_tpu as jpkg  # noqa: E402
from sparsespatialsampling_tpu import parallel as jpar  # noqa: E402
import sparsespatialsampling_torch as tpkg  # noqa: E402
from sparsespatialsampling_torch import parallel as tpar  # noqa: E402
from sparsespatialsampling_torch import utils as tutils  # noqa: E402
from sparsespatialsampling_torch.ops.interpolate import (  # noqa: E402
    interpolate_data, interpolate_host)
from chip_smoke import jax_sharded_weights  # noqa: E402
from sparsespatialsampling_torch.ops.knn import KNNIndex  # noqa: E402
from sparsespatialsampling_torch.parallel import mesh as tmesh  # noqa: E402

SHARDS = (1, 3, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the device loop issues many small operations,
    which slow down many times over when the suite's workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud(n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, d))
    metric = np.exp(-np.sum((pts - 0.5) ** 2, axis=1) / 0.02) + 0.01
    return pts, metric


def _grid_policy(monkeypatch, grid: bool):
    """The bucket grid on (from 1,000 points) or off, on every index."""
    n = 1000 if grid else 10 ** 9
    for cls in (KNNIndex, tpar.ShardedKNNIndex, jpar.ShardedKNNIndex):
        monkeypatch.setattr(cls, "GRID_MIN_POINTS", n)


# ---------------------------------------------------------------------- #
# the mesh                                                               #
# ---------------------------------------------------------------------- #
def test_mesh_defaults_take_one_device():
    assert tmesh.VIRTUAL_SHARDS is None and not tmesh.DISABLE_SHARDING
    assert not tpar.sharding_enabled("cpu")
    assert tpar.make_mesh(device="cpu").size == 1


@pytest.mark.parametrize("shards", SHARDS)
def test_virtual_mesh(monkeypatch, shards):
    monkeypatch.setattr(tmesh, "VIRTUAL_SHARDS", shards)
    assert tpar.sharding_enabled("cpu")
    mesh = tpar.default_mesh("cpu")
    assert mesh.size == shards and mesh.root == torch.device("cpu")
    assert tpar.CELL_AXIS == "cells"
    monkeypatch.setattr(tmesh, "DISABLE_SHARDING", True)
    assert not tpar.sharding_enabled("cpu")


def test_mesh_that_cannot_be_built_raises(monkeypatch):
    with pytest.raises(ValueError):
        tpar.Mesh([])
    with pytest.raises(ValueError):
        tpar.make_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh(2)


def test_collectives_keep_shard_order():
    mesh = tpar.make_mesh(3, device="cpu")
    parts = [torch.tensor([v], dtype=torch.float64)
             for v in (1e16, 1.0, -1e16)]
    # in shard order the 1.0 is lost; another order would keep it
    assert tmesh.psum(parts, mesh).item() == (1e16 + 1.0) - 1e16 == 0.0
    assert tmesh.all_gather(parts, mesh).tolist() == [1e16, 1.0, -1e16]


# ---------------------------------------------------------------------- #
# sharded kNN                                                            #
# ---------------------------------------------------------------------- #
def _queries(d: int, n: int = 700, seed: int = 9):
    return np.random.default_rng(seed).uniform(-0.05, 1.05, size=(n, d))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("d,grid", [(2, True), (3, True), (2, False),
                                    (3, False)],
                         ids=["2d-grid", "3d-grid", "2d-full", "3d-full"])
def test_sharded_query_equals_single_device(monkeypatch, d, grid, shards):
    _grid_policy(monkeypatch, grid)
    # clouds that 3 and 8 shards do not divide
    n = (6001 if d == 2 else 5003) if grid else (2001 if d == 2 else 1503)
    pts, metric = _cloud(n, d, d)
    q = _queries(d)
    k = 8 if d == 2 else 26
    one = KNNIndex(pts, values=metric, device="cpu")
    sh = tpar.ShardedKNNIndex(pts, tpar.make_mesh(shards, device="cpu"),
                              values=metric)
    assert sh.core_kind == ("shard_grid" if grid else "shard_full")
    if grid:
        assert sh._grid is not None and sh.last_fallback == 0
    for a, b in zip(one.query(q, k), sh.query(q, k)):
        np.testing.assert_array_equal(b, a)
    if grid:
        # the grid answered most rows, the full route the rest
        assert 0 < sh.last_fallback < q.shape[0] // 2
    (ow, oi), (tw, ti) = one.weights(q, k), sh.weights(q, k)
    np.testing.assert_array_equal(ti, oi)
    # the mesh weighs as the JAX package's sharded index does, from the
    # cloud cast to f32 before it is centred on its f32 mean; the single
    # device from its cloud centred in f64.  The raw coordinates' f32
    # rounding costs the short distances up to about 1e-4 of their size.
    np.testing.assert_array_equal(tw, jax_sharded_weights(pts, q, oi))
    np.testing.assert_allclose(tw, ow, rtol=1e-4)
    np.testing.assert_array_equal(sh.predict(q, k), one.predict(q, k))
    np.testing.assert_array_equal(sh.predict_host(q[:9], k),
                                  one.predict_host(q[:9], k))


def _reference_arrays(jidx) -> dict:
    """numpy copies of a JAX ``ShardedKNNIndex``'s arrays."""
    out = {name: np.asarray(getattr(jidx, name)) for name in
           ("_points", "_points_sq", "_shift", "_points_host")}
    out["_n_padded"] = jidx._n_padded
    g = jidx._grid
    if g is not None:
        out.update({name: np.asarray(g[name]) for name in
                    ("dil_pts", "dil_cand", "dil_ovf", "origin", "inv_h",
                     "dims") + (("dil_vals",) if "dil_vals" in g else ())})
        out.update(C=g["C"], n_cells=g["n_cells"], rows=g["rows"])
    return out


def _off_ties(dists: np.ndarray, rel: float = 1e-5) -> np.ndarray:
    """Rows whose k + 1 nearest distances are pairwise apart by more than
    ``rel`` (the k-th place and the order are then tie-free)."""
    gap = np.diff(dists, axis=1) > rel * np.maximum(dists[:, 1:], 1e-30)
    return gap.all(axis=1)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("d,grid", [(2, True), (3, True), (3, False)],
                         ids=["2d-grid", "3d-grid", "3d-full"])
def test_sharded_query_on_the_jax_layout(monkeypatch, d, grid, shards):
    _grid_policy(monkeypatch, grid)
    n = (6001 if d == 2 else 5003) if grid else 1503
    pts, metric = _cloud(n, d, d + 4)
    q = _queries(d, seed=d + 5).astype(np.float32)
    k = 8 if d == 2 else 26
    jidx = jpar.ShardedKNNIndex(pts, jpar.make_mesh(shards),
                                values=metric)
    tidx = tpar.sharded_index_from_reference(
        _reference_arrays(jidx), tpar.make_mesh(shards, device="cpu"))
    assert (tidx._grid is None) == (not grid)
    jd, ji = jidx.query(q, k)
    td, ti = tidx.query(q, k)
    assert tidx.last_fallback == jidx.last_fallback
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-7)
    off = _off_ties(tidx.query(q, k + 1)[0])
    assert off.mean() > 0.95
    np.testing.assert_array_equal(ti[off], ji[off])
    # the port's own build answers as the port's single device does, and
    # the same neighbours as the JAX package's off ties
    own = tpar.ShardedKNNIndex(pts, tpar.make_mesh(shards, device="cpu"))
    od, oi = own.query(q, k)
    np.testing.assert_allclose(od, jd, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(oi[off], ji[off])


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_query_ties_on_a_lattice(shards):
    """Exact distance ties (queries on and between the points of a
    lattice): the port answers in the canonical ascending ``(distance²,
    index)`` order, on its own build bitwise as the single device does;
    the JAX package's full route ranks by the score ``|p|² − 2q·p`` without
    slack, so it orders (and at the k-th place picks) tied neighbours
    differently.  The distances agree as sorted sets."""
    axis = np.arange(40) * 0.1 + 0.05
    pts = np.stack(np.meshgrid(axis, axis, indexing="ij"), -1).reshape(-1, 2)
    rng = np.random.default_rng(0)
    q = (pts[rng.choice(len(pts), 300, replace=False)]
         + rng.choice([0.0, 0.05], size=(300, 2))).astype(np.float32)
    jidx = jpar.ShardedKNNIndex(pts, jpar.make_mesh(shards))
    tidx = tpar.sharded_index_from_reference(
        _reference_arrays(jidx), tpar.make_mesh(shards, device="cpu"))
    jd, ji = jidx.query(q, 8)
    td, ti = tidx.query(q, 8)
    sq, idx = (t.numpy() for t in tidx._spatial_run(q, 8, "query"))
    np.testing.assert_array_equal(idx, ti)
    canonical = (sq[:, 1:] > sq[:, :-1]) | ((sq[:, 1:] == sq[:, :-1])
                                            & (idx[:, 1:] > idx[:, :-1]))
    assert canonical.all()
    assert (sq[:, 1:] == sq[:, :-1]).any(axis=1).sum() > 100
    np.testing.assert_allclose(np.sort(jd, axis=1), td, rtol=1e-6,
                               atol=1e-6)
    assert (ji != ti).any(axis=1).sum() > 100
    one = KNNIndex(pts, device="cpu")
    own = tpar.ShardedKNNIndex(pts, tpar.make_mesh(shards, device="cpu"))
    for a, b in zip(one.query(q, 8), own.query(q, 8)):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------- #
# sharded interpolation                                                  #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_interpolate(shards):
    rng = np.random.default_rng(2)
    n_orig, m, k, c, s = 1000, 333, 8, 2, 5
    data = rng.normal(size=(n_orig, c, s)).astype(np.float32)
    w = rng.uniform(size=(m, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    idx = rng.integers(0, n_orig, size=(m, k))
    one = interpolate_data(torch.from_numpy(w), torch.from_numpy(idx),
                           torch.from_numpy(data), chunk_size=64).numpy()
    out = tpar.sharded_interpolate(w, idx, data,
                                   tpar.make_mesh(shards, device="cpu"),
                                   chunk_size=64)
    assert out.shape == (m, c, s) and out.dtype == np.float32
    np.testing.assert_array_equal(out, one)
    ref = jpar.sharded_interpolate(w, idx.astype(np.int32), data,
                                   jpar.make_mesh(shards))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("k", [8, 26])
def test_sharded_interpolate_is_the_host_contraction(shards, k):
    """Each shard sums its rows left to right over k: bitwise the host
    route's CSR product (``interpolate_host``) on the same weights.  The
    JAX package's mesh ``einsum`` sums in another order and differs from
    it in part of the values (``test_sharded_interpolate`` holds the port
    to it at rtol 1e-6)."""
    rng = np.random.default_rng(k)
    n_orig, m, c, s = 2000, 501, 3, 4
    data = rng.normal(size=(n_orig, c, s)).astype(np.float32)
    w = rng.uniform(size=(m, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    idx = rng.integers(0, n_orig, size=(m, k))
    out = tpar.sharded_interpolate(w, idx, data,
                                   tpar.make_mesh(shards, device="cpu"))
    np.testing.assert_array_equal(out, interpolate_host(w, idx, data))
    ref = jpar.sharded_interpolate(w, idx.astype(np.int32), data,
                                   jpar.make_mesh(shards))
    assert (ref != out).any()


# ---------------------------------------------------------------------- #
# distributed randomized SVD                                             #
# ---------------------------------------------------------------------- #
def _low_rank(m: int = 3001, n: int = 40, seed: int = 3):
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(size=(m, 6)))[0]
    v = np.linalg.qr(rng.normal(size=(n, 6)))[0]
    s = np.array([50.0, 30.0, 20.0, 10.0, 5.0, 2.0])
    return ((u * s) @ v.T + 1e-3 * rng.normal(size=(m, n))).astype(
        np.float32)


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    qa = np.linalg.qr(np.asarray(a, np.float64))[0]
    qb = np.linalg.qr(np.asarray(b, np.float64))[0]
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


@pytest.mark.parametrize("shards", SHARDS)
def test_distributed_rsvd_against_jax(shards):
    a = _low_rank()
    u, s, v = tpar.distributed_rsvd(a, 5, tpar.make_mesh(shards,
                                                         device="cpu"))
    ju, js, jv = jpar.distributed_rsvd(a, 5, jpar.make_mesh(shards))
    assert u.shape == (a.shape[0], 5) and v.shape == (a.shape[1], 5)
    np.testing.assert_allclose(s, js, rtol=1e-3)
    assert _cosines(u, ju).min() >= 0.999
    assert _cosines(v, jv).min() >= 0.999
    np.testing.assert_allclose(u.T.astype(np.float64) @ u, np.eye(5),
                               atol=1e-4)
    np.testing.assert_allclose(v.T.astype(np.float64) @ v, np.eye(5),
                               atol=1e-4)


@pytest.mark.parametrize("shards", SHARDS)
def test_distributed_rsvd_rank_deficient(shards):
    """A rank-3 matrix sketched at width 15: the dead directions map to
    zero columns, never NaN."""
    rng = np.random.default_rng(4)
    a = (rng.normal(size=(997, 3)) @ rng.normal(size=(3, 30))).astype(
        np.float32)
    u, s, v = tpar.distributed_rsvd(a, 5, tpar.make_mesh(shards,
                                                         device="cpu"))
    assert np.isfinite(u).all() and np.isfinite(s).all() \
        and np.isfinite(v).all()
    ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s[:3], ref[:3], rtol=1e-4)
    assert s[3:].max() <= 1e-3 * s[0]


# ---------------------------------------------------------------------- #
# the engine                                                             #
# ---------------------------------------------------------------------- #
def _grid_run(pkg, pts, metric, d, **extra):
    geo = [pkg.CubeGeometry("domain", True, [0.0] * d, [1.0] * d),
           pkg.SphereGeometry("hole", False, [0.3] * d, 0.1)]
    s3 = pkg.SparseSpatialSampling(pts, metric, geo,
                                   save_path=tempfile.mkdtemp(),
                                   save_name="p", uniform_levels=3,
                                   min_metric=0.85, **extra)
    s3.execute_grid_generation()
    return s3


def _rows(s3) -> tuple:
    return (np.asarray(s3.levels).ravel(), np.asarray(s3.centers),
            np.asarray(s3.faces), s3.data_final_mesh["iterations"])


def _sorted_cells(s3) -> tuple:
    c = np.asarray(s3.centers)
    lv = np.asarray(s3.levels).ravel()
    order = np.lexsort((lv,) + tuple(c.T))
    return c[order], lv[order]


@pytest.mark.parametrize("d,grid", [(2, True), (3, True), (2, False),
                                    (3, False)],
                         ids=["2d-shard_grid", "3d-shard_grid",
                              "2d-shard_full", "3d-shard_full"])
def test_sharded_engine(monkeypatch, d, grid):
    """2D over 3 shards, 3D over 8.  The 3D grid case escalates cells:
    under the mesh they skip the ring and go to the sharded full scan."""
    _grid_policy(monkeypatch, grid)
    pts, metric = _cloud(4000 if d == 2 else 3000, d, 0)
    one = _grid_run(tpkg, pts, metric, d, device="cpu")
    monkeypatch.setattr(tmesh, "VIRTUAL_SHARDS", 3 if d == 2 else 8)
    sh = _grid_run(tpkg, pts, metric, d, device="cpu")
    st = sh.data_final_mesh["epoch_stats"]
    assert st["core"] == ("shard_grid" if grid else "shard_full")
    assert one.data_final_mesh["epoch_stats"]["core"] == (
        "dil" if grid else "full")
    # the device loop carried the iterations: fewer epoch calls than
    # iterations, and no ring or rescue under the mesh
    assert st["windows"] >= 1
    assert st["n_calls_main"] < sh.data_final_mesh["iterations"]
    assert st["ring_queries"] == st["rescued_queries"] == 0
    assert st["n_calls_ring"] == 0
    assert st["full_scan_cells"] == st["n_bad_cells"]
    if d == 3 and grid:
        assert st["n_bad_cells"] > 0 and st["n_calls_full"] >= 1
    for a, b in zip(_rows(one), _rows(sh)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(sh.data_final_mesh["metric_per_iter"],
                                  one.data_final_mesh["metric_per_iter"])

    monkeypatch.delenv("S3_TPU_DISABLE_SHARDING", raising=False)
    assert jpar.sharding_enabled() and jax.device_count() == 8
    ref = _grid_run(jpkg, pts, metric, d)
    (ca, la), (cb, lb) = _sorted_cells(ref), _sorted_cells(sh)
    np.testing.assert_array_equal(lb, la)
    np.testing.assert_array_equal(cb, ca)
    assert sh.data_final_mesh["iterations"] == \
        ref.data_final_mesh["iterations"]
    np.testing.assert_allclose(sh.data_final_mesh["metric_per_iter"],
                               ref.data_final_mesh["metric_per_iter"],
                               rtol=1e-5)


def test_sharded_engine_budget_and_balance(monkeypatch):
    """The cell-budget stopping rule, the 2:1 balance in the device loop
    and the geometry refinement on the mesh's root: rows identical to the
    single device's."""
    _grid_policy(monkeypatch, True)
    pts, metric = _cloud(4000, 2, 0)

    def run():
        geo = [tpkg.CubeGeometry("domain", True, [0.0, 0.0], [1.0, 1.0]),
               tpkg.SphereGeometry("hole", False, [0.3, 0.3], 0.1,
                                   refine=True, min_refinement_level=6)]
        s3 = tpkg.SparseSpatialSampling(
            pts, metric, geo, save_path=tempfile.mkdtemp(), save_name="b",
            uniform_levels=3, n_cells_max=1500, max_delta_level=True,
            device="cpu")
        s3.execute_grid_generation()
        return s3
    one = run()
    monkeypatch.setattr(tmesh, "VIRTUAL_SHARDS", 3)
    sh = run()
    st = sh.data_final_mesh["epoch_stats"]
    assert st["core"] == "shard_grid" and st["windows"] >= 1
    assert st["geometry_route"]["windows"] + st["geometry_route"][
        "host_levels"] >= 1
    for a, b in zip(_rows(one), _rows(sh)):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------- #
# the pipeline                                                           #
# ---------------------------------------------------------------------- #
def _snapshots(pts, metric):
    """Three modes: the metric's, and two of the coordinates."""
    return np.stack([metric * (1 + 0.1 * i) + pts[:, 0] * np.sin(i)
                     + pts[:, 1] ** 2 * np.cos(0.7 * i) for i in range(6)],
                    axis=-1)[:, None, :].astype(np.float32)


def _pipeline(pts, metric, d):
    s3 = _grid_run(tpkg, pts, metric, d, device="cpu")
    snaps = _snapshots(pts, metric)
    exp = tpkg.ExportData(s3, write_times=[str(i) for i in range(6)],
                          device="cpu")
    field = exp.interpolate(pts, snaps)
    area = ((s3.size_initial_cell / 2.0 ** s3.levels.astype(float))
            ** d).ravel()
    return s3, exp, field, tpkg.compute_svd(field[:, 0], area, rank=3,
                                            device="cpu")


@pytest.mark.parametrize("d", [2, 3])
def test_sharded_pipeline(monkeypatch, d):
    pts, metric = _cloud(3000, d, 1)
    monkeypatch.setattr(tutils, "_RSVD_ROW_THRESHOLD", 100)
    one = _pipeline(pts, metric, d)
    calls = []
    real = tutils.distributed_rsvd_device

    def counted(*args, **kw):
        calls.append(args[2].size)
        return real(*args, **kw)
    monkeypatch.setattr(tutils, "distributed_rsvd_device", counted)
    monkeypatch.setattr(tmesh, "VIRTUAL_SHARDS", 3)
    sh = _pipeline(pts, metric, d)
    assert calls == [3]
    assert isinstance(sh[1]._knn, tpar.ShardedKNNIndex)
    assert sh[1]._mesh.size == 3
    for a, b in zip(_rows(one[0]), _rows(sh[0])):
        np.testing.assert_array_equal(b, a)
    # the host route: the mesh's neighbours are the single device's; its
    # weights are the JAX package's sharded weights (the cloud cast to f32
    # before centring), the single device's its own (centred in f64), the
    # same to 1e-4; the metric is the f64 host sum and the fields the
    # single-device contraction of the mesh's weights, bit for bit
    w, idx = sh[1]._w_centers, sh[1]._idx_centers
    np.testing.assert_array_equal(idx, one[1]._idx_centers)
    np.testing.assert_array_equal(
        w, jax_sharded_weights(pts, one[0].centers, idx))
    np.testing.assert_allclose(w, one[1]._w_centers, rtol=1e-4)
    np.testing.assert_array_equal(sh[1]._metric,
                                  (w * metric[idx]).sum(axis=1))
    assert sh[1]._metric.dtype == one[1]._metric.dtype == np.float64
    np.testing.assert_array_equal(
        sh[2], interpolate_host(w, idx, _snapshots(pts, metric)))
    np.testing.assert_allclose(sh[2], one[2], rtol=1e-4, atol=1e-6)
    (s1, u1, v1), (s2, u2, v2) = one[3], sh[3]
    np.testing.assert_allclose(s2, s1, rtol=1e-4)
    assert _cosines(v2, v1).min() >= 0.999
