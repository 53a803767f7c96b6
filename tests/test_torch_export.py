"""The port's export routes against the JAX package's, on the CPU.

- ``KNNIndex.weights`` (the host route's weights) is the JAX package's bit
  for bit in 2D (k = 8) and 3D (k = 26): on the grid route with its
  fallback rows (a void the grid cannot answer near), on the full-scan
  route, and at 256 < k <= 3^d·C, where the port's full scan answers what
  the JAX package's grid answers.
- ``ShardedKNNIndex.weights`` over 3 shards is the JAX package's sharded
  weights bit for bit (off ties: uniform clouds).
- A weight cache prefetched by ``execute_grid_generation`` is byte for
  byte the one ``ExportData`` builds (``timings["prefetch"]`` reads
  ``"consumed"``, and ``"built"`` with ``EXPORT_PREFETCH = False``), and a
  checkpoint reloads without the prefetch.
- The host route over a 3-shard mesh writes the JAX package's mesh
  weights and ``constant/metric`` bit for bit; its fields are the
  single-device contraction of those weights bit for bit, and within
  rtol 1e-6 of the JAX package's mesh ``einsum``.
- The device route (``ExportData.INTERP = "device"``) against the JAX
  package's ``S3_TPU_INTERP=device``: the grid datasets and the device
  weights bit for bit; ``constant/metric`` (f32) and the fields to rtol
  1e-6, not bit for bit: the JAX package's device contraction is an XLA
  ``einsum``, which sums the k terms in another order than the port's
  left-to-right sum.
"""
import tempfile
from os.path import join
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparsespatialsampling_tpu as jpkg  # noqa: E402
from sparsespatialsampling_tpu import parallel as jpar  # noqa: E402
from sparsespatialsampling_tpu.ops import knn as jknn  # noqa: E402
import sparsespatialsampling_torch as tpkg  # noqa: E402
from sparsespatialsampling_torch import parallel as tpar  # noqa: E402
from sparsespatialsampling_torch.ops import knn as tknn  # noqa: E402
from sparsespatialsampling_torch.ops import topk  # noqa: E402
from sparsespatialsampling_torch.ops.interpolate import (  # noqa: E402
    interpolate_host)
from sparsespatialsampling_torch.parallel import mesh as tmesh  # noqa: E402
from tests.test_torch_pipeline import _h5_items  # noqa: E402

K = {2: 8, 3: 26}


def _void_cloud(d: int, n: int, seed: int):
    """A uniform cloud with a void at the centre, whose queries the grid
    cannot certify (fallback rows), and queries a little beyond it."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, d))
    pts = pts[np.linalg.norm(pts - 0.5, axis=1) > 0.12]
    q = rng.uniform(-0.05, 1.05, size=(1500, d))
    return pts, q


def _grid_policy(monkeypatch, grid_from: int):
    for cls in (jknn.KNNIndex, tknn.KNNIndex, jpar.ShardedKNNIndex,
                tpar.ShardedKNNIndex):
        monkeypatch.setattr(cls, "GRID_MIN_POINTS", grid_from)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("route", ["grid", "full-scan"])
def test_knn_weights_bitwise_jax(monkeypatch, d, route):
    _grid_policy(monkeypatch, 1000 if route == "grid" else 10 ** 12)
    pts, q = _void_cloud(d, 6000, d)
    j = jknn.KNNIndex(pts)
    t = tknn.KNNIndex(pts, device="cpu")
    jw, ji = j.weights(q, K[d])
    tw, ti = t.weights(q, K[d])
    assert tw.dtype == jw.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)
    if route == "grid":
        # rows the grid rejects went to the full scan, in both packages
        assert t.last_fallback == j.last_fallback > 0
    else:
        assert t._grid is None and j._grid is None


def test_knn_weights_above_the_kernel_queue(monkeypatch):
    """256 < k <= 3^d·C: the JAX package answers from its grid and weighs
    by host distances; the port selects by the full scan (k is above the
    kernel's queue) and must weigh by the same host distances."""
    _grid_policy(monkeypatch, 1000)
    pts, q = _void_cloud(3, 6000, 5)
    j = jknn.KNNIndex(pts)
    t = tknn.KNNIndex(pts, device="cpu")
    k = 300
    assert topk.MAX_K < k <= 27 * t._grid["C"]
    assert not t._uses_grid(q.shape[0], k)
    jw, ji = j.weights(q[:300], k)
    tw, ti = t.weights(q[:300], k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("d", [2, 3])
def test_sharded_weights_bitwise_jax(monkeypatch, d):
    monkeypatch.delenv("S3_TPU_DISABLE_SHARDING", raising=False)
    _grid_policy(monkeypatch, 1000)
    rng = np.random.default_rng(20 + d)
    pts = rng.uniform(size=(5003, d))
    q = rng.uniform(-0.05, 1.05, size=(800, d))
    j = jpar.ShardedKNNIndex(pts, jpar.make_mesh(3))
    t = tpar.ShardedKNNIndex(pts, tpar.make_mesh(3, device="cpu"))
    jw, ji = j.weights(q, K[d])
    tw, ti = t.weights(q, K[d])
    assert tw.dtype == jw.dtype
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)


def _grid(d: int, save_path: str, prefetch: bool = True):
    """A small grid of the port on the CPU (the engine's index has a grid:
    ``GRID_MIN_POINTS`` is lowered by the caller)."""
    rng = np.random.default_rng(30 + d)
    pts = rng.uniform(size=(4000, d))
    metric = np.exp(-((pts - 0.6) ** 2).sum(1) / 0.05) + 0.01
    geo = [tpkg.CubeGeometry("domain", True, [0.0] * d, [1.0] * d)]
    saved = tpkg.SparseSpatialSampling.EXPORT_PREFETCH
    tpkg.SparseSpatialSampling.EXPORT_PREFETCH = prefetch
    try:
        s3 = tpkg.SparseSpatialSampling(
            pts, metric, geo, save_path=save_path, save_name="g",
            uniform_levels=2, n_cells_max=600 if d == 2 else 800,
            device="cpu")
        s3.execute_grid_generation()
    finally:
        tpkg.SparseSpatialSampling.EXPORT_PREFETCH = saved
    return pts, metric, s3


def _snapshots(pts, metric, n_snap: int = 4):
    return (metric[:, None, None] * (1 + 0.2 * np.sin(np.arange(n_snap)))
            + pts[:, :1, None] * np.cos(np.arange(n_snap))).astype(
                np.float32)


@pytest.mark.parametrize("d", [2, 3])
def test_prefetched_cache_is_the_built_one(monkeypatch, tmp_path, d):
    _grid_policy(monkeypatch, 1000)
    pts, metric, s3 = _grid(d, str(tmp_path / "on"))
    pf = s3._knn_prefetch
    assert pf["k"] == K[d] and pf["thread"] is not None
    data = _snapshots(pts, metric)
    on = tpkg.ExportData(s3, write_times=["0"], device="cpu")
    field_on = on.interpolate(pts, data)
    assert on.timings["prefetch"] == "consumed"
    assert pf["thread"] is None and "centers" not in pf["data"]
    assert pf["t_build"] > 0.0

    _, _, s3_off = _grid(d, str(tmp_path / "off"), prefetch=False)
    assert s3_off._knn_prefetch["thread"] is None
    off = tpkg.ExportData(s3_off, write_times=["0"], device="cpu")
    field_off = off.interpolate(pts, data)
    assert off.timings["prefetch"] == "built"
    np.testing.assert_array_equal(s3_off.centers, s3.centers)
    for a, b in ((on._w_centers, off._w_centers),
                 (on._idx_centers, off._idx_centers),
                 (on._op_centers.data, off._op_centers.data),
                 (on._op_centers.indices, off._op_centers.indices),
                 (on._op_centers.indptr, off._op_centers.indptr),
                 (on._metric, off._metric), (field_on, field_off)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert on._metric.dtype == np.float64
    # a second export of the same grid builds its own cache, the same
    again = tpkg.ExportData(s3, write_times=["0"], device="cpu")
    np.testing.assert_array_equal(again.interpolate(pts, data), field_on)
    assert again.timings["prefetch"] == "built"


def test_checkpoint_reloads_without_the_prefetch(monkeypatch, tmp_path):
    _grid_policy(monkeypatch, 1000)
    _, _, s3 = _grid(2, str(tmp_path))
    assert s3._knn_prefetch["thread"] is not None
    s3._knn_prefetch["thread"].join()
    back = tpkg.load_s_cube(join(str(tmp_path), "s_cube_g.pt"))
    assert not hasattr(back, "_knn_prefetch")
    assert not hasattr(back, "_knn_index")
    np.testing.assert_array_equal(back.centers, s3.centers)
    # a reloaded grid exports through a cache ExportData builds
    exp = tpkg.ExportData(back, write_times=["0"], device="cpu")
    exp.interpolate(*_grid_cloud(2))
    assert exp.timings["prefetch"] == "built"


def _grid_cloud(d: int):
    rng = np.random.default_rng(30 + d)
    pts = rng.uniform(size=(4000, d))
    metric = np.exp(-((pts - 0.6) ** 2).sum(1) / 0.05) + 0.01
    return pts, _snapshots(pts, metric)


def _export_both(s3, pts, data, jax_env: dict, monkeypatch,
                 interp: str = "host"):
    """The same grid exported by both packages (fresh weight caches, the
    cells' own kNN index): their HDF5 datasets and ``ExportData``s."""
    files, exps = {}, {}
    for label, pkg in (("jax", jpkg), ("port", tpkg)):
        grid = SimpleNamespace(
            n_dimensions=s3.n_dimensions, faces=s3.faces,
            centers=s3.centers, vertices=s3.vertices, levels=s3.levels,
            metric=s3.metric, size_initial_cell=s3.size_initial_cell,
            save_path=tempfile.mkdtemp(), save_name="g", grid_name="g")
        with monkeypatch.context() as mp:
            if pkg is jpkg:
                for key, value in jax_env.items():
                    if value is None:
                        mp.delenv(key, raising=False)
                    else:
                        mp.setenv(key, value)
            else:
                mp.setattr(tpkg.ExportData, "INTERP", interp)
            extra = {"device": "cpu"} if pkg is tpkg else {}
            exp = pkg.ExportData(grid, write_times=["0", "1", "2", "3"],
                                 interpolate_at_vertices=True, **extra)
            exp.export(pts, data, "p")
        files[label] = _h5_items(join(grid.save_path, "g.h5"))
        exps[label] = exp
    assert sorted(files["port"]) == sorted(files["jax"])
    for key, want in files["jax"].items():
        assert files["port"][key].dtype == want.dtype, key
    return files, exps


def test_mesh_export_matches_jax(monkeypatch, tmp_path):
    """3 shards in both packages (the JAX package's export takes
    ``parallel.make_mesh()``, patched to 3 devices)."""
    _grid_policy(monkeypatch, 1000)
    pts, metric, s3 = _grid(2, str(tmp_path))
    data = _snapshots(pts, metric)
    monkeypatch.setattr(tmesh, "VIRTUAL_SHARDS", 3)
    monkeypatch.setattr(jpar, "make_mesh", lambda n=3: jpar.mesh.make_mesh(
        n))
    files, exps = _export_both(s3, pts, data,
                               {"S3_TPU_DISABLE_SHARDING": None},
                               monkeypatch)
    jexp, texp = exps["jax"], exps["port"]
    assert isinstance(texp._knn, tpar.ShardedKNNIndex)
    assert texp._mesh.size == 3 and jexp._mesh.devices.size == 3
    np.testing.assert_array_equal(texp._w_centers, jexp._knn_w_centers)
    np.testing.assert_array_equal(texp._idx_centers, jexp._knn_idx_centers)
    np.testing.assert_array_equal(texp._w_vertices, jexp._knn_w_vertices)
    for key, want in files["jax"].items():
        got = files["port"][key]
        if key.startswith("data/"):
            # the JAX package's mesh contraction is an XLA einsum
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    # the mesh's fields are the single-device contraction of its weights
    centers = interpolate_host(texp._w_centers, texp._idx_centers, data)
    vertices = interpolate_host(texp._w_vertices, texp._idx_vertices, data)
    for i, t in enumerate(["0", "1", "2", "3"]):
        np.testing.assert_array_equal(files["port"][f"data/{t}/p_center"],
                                      centers[:, 0, i])
        np.testing.assert_array_equal(files["port"][f"data/{t}/p_vertices"],
                                      vertices[:, 0, i])


@pytest.mark.parametrize("d", [2, 3])
def test_device_route_against_jax(monkeypatch, tmp_path, d):
    _grid_policy(monkeypatch, 1000)
    pts, metric, s3 = _grid(d, str(tmp_path))
    data = _snapshots(pts, metric)
    files, exps = _export_both(s3, pts, data, {"S3_TPU_INTERP": "device"},
                               monkeypatch, interp="device")
    texp = exps["port"]
    assert texp._cache_device and texp.timings["prefetch"] == "off"
    assert texp.timings["interp_outputs"] == (
        (s3.centers.shape[0] + s3.vertices.shape[0]) * data.shape[2])
    assert files["port"]["constant/metric"].dtype == np.float32
    # the device weights are the JAX package's bit for bit ...
    jexp = exps["jax"]
    n = s3.centers.shape[0]
    np.testing.assert_array_equal(texp._w_centers.numpy(),
                                  np.asarray(jexp._knn_w_centers)[:n])
    np.testing.assert_array_equal(texp._idx_centers.numpy(),
                                  np.asarray(jexp._knn_idx_centers)[:n])
    # ... while the contractions (metric and fields) sum in another order
    # than the JAX package's XLA einsum
    for key, want in files["jax"].items():
        got = files["port"][key]
        if key.startswith("data/") or key == "constant/metric":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def _report_device_route():
    """Print, for each dataset of the device route that is not the JAX
    package's bit for bit, the differing values, the first of them and the
    largest relative difference (``JAX_PLATFORMS=cpu python -m
    tests.test_torch_export`` from the repository's root)."""
    mp = pytest.MonkeyPatch()
    _grid_policy(mp, 1000)
    for d in (2, 3):
        pts, metric, s3 = _grid(d, tempfile.mkdtemp())
        data = _snapshots(pts, metric)
        files, _ = _export_both(s3, pts, data, {"S3_TPU_INTERP": "device"},
                                mp, interp="device")
        for key in sorted(files["jax"]):
            got, want = files["port"][key].ravel(), files["jax"][key].ravel()
            bad = np.nonzero(got != want)[0]
            if bad.size:
                print(f"{d}D {key}: {bad.size} of {got.size} differ; first "
                      f"at {bad[0]}: {got[bad[0]]!r} against "
                      f"{want[bad[0]]!r}; largest relative difference "
                      f"{float(np.max(np.abs(got - want) / np.abs(want)))}")
    mp.undo()


if __name__ == "__main__":
    _report_device_route()
