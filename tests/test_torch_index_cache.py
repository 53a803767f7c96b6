"""The port's size-1 kNN index cache (``engine/tree.py:_KNN_INDEX_CACHE``)
against cold builds and the JAX package's ``_KNN_INDEX_CACHE``.

- Two trees on equal bytes share one ``KNNIndex``; the warm run's
  ``t_knn_build`` is the key's hash and the lookup.
- The second and third runs of a ``min_metric`` sweep (the reference
  examples' use, ``examples/s3_for_OAT15_airfoil.py:63-72``) grow the
  cells, iterations and metric trace of a cold build, and of the JAX
  package's run at the same settings.
- The index is rebuilt when one metric value moves by an ulp, one
  coordinate moves, any of the six build-policy attributes changes or the
  device differs (the key, without a card).
- One entry: a third cloud evicts the first.  A sharded run leaves the
  cache as it was.
- A reused index holds a fresh build's ``last_fallback`` and values.
- A run that takes a cached index first joins the worker threads that
  query it (the export's prefetch), and no other.
"""
import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparsespatialsampling_tpu as jpkg  # noqa: E402
from sparsespatialsampling_tpu.engine import tree as jtree  # noqa: E402
from sparsespatialsampling_tpu.ops.knn import KNNIndex as JaxKNN  # noqa: E402
import sparsespatialsampling_torch as tpkg  # noqa: E402
from sparsespatialsampling_torch.engine import graphs  # noqa: E402
from sparsespatialsampling_torch.engine import tree as ttree  # noqa: E402
from sparsespatialsampling_torch.ops.knn import KNNIndex  # noqa: E402
from sparsespatialsampling_torch.parallel import mesh as tmesh  # noqa: E402

# the six attributes of the build policy in the key, each with another
# value that still builds the grid on the test's cloud
POLICY = {"GRID_MIN_POINTS": 1001, "GRID_OCCUPANCY": 12,
          "GRID_CAPACITY": 48, "GRID_SHRINK_TARGET": 24,
          "GRID_CHUNK": 1024, "DIL_MAX_BYTES": 0}


@pytest.fixture(autouse=True)
def _clear_caches(monkeypatch):
    """Each test starts and ends with both packages' caches empty, the
    grid route on from 1,000 points in both."""
    monkeypatch.setattr(KNNIndex, "GRID_MIN_POINTS", 1000)
    monkeypatch.setattr(JaxKNN, "GRID_MIN_POINTS", 1000)
    ttree._KNN_INDEX_CACHE.clear()
    jtree._KNN_INDEX_CACHE.clear()
    yield
    ttree._KNN_INDEX_CACHE.clear()
    jtree._KNN_INDEX_CACHE.clear()


def _cloud(seed: int = 5, n: int = 4000):
    rng = np.random.default_rng(seed)
    xy = rng.uniform([0, 0], [1, 1], size=(n, 2))
    metric = np.exp(-((xy[:, 0] - .6) ** 2 + (xy[:, 1] - .5) ** 2)
                    / .03) + 0.01
    return xy, metric


def _tree(xy, metric, **kw):
    return ttree.SamplingTree(
        xy, metric, [tpkg.CubeGeometry("domain", True, [0, 0], [1, 1])],
        uniform_level=3, device="cpu", **kw)


def _run(pkg, xy, metric, min_metric: float):
    """One grid through ``pkg``'s public entry point."""
    extra = {"device": "cpu"} if pkg is tpkg else {}
    s3 = pkg.SparseSpatialSampling(
        xy, metric, [pkg.CubeGeometry("domain", True, [0, 0], [1, 1])],
        save_path=tempfile.mkdtemp(), save_name="c", uniform_levels=3,
        min_metric=min_metric, **extra)
    index = s3._sampling._knn
    s3.execute_grid_generation()
    return s3, index


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


def test_reuse_on_equal_bytes():
    xy, metric = _cloud()
    xy = xy.astype(np.float32)
    first = _tree(xy, metric)
    # other arrays of the same values: an f32 cloud and its f64 cast
    second = _tree(xy.astype(np.float64), metric.copy())
    assert first._knn._grid is not None
    assert second._knn is first._knn
    assert second._epoch_stats["core"] == first._epoch_stats["core"]
    assert 0.0 < second._times["t_knn_build"] < first._times["t_knn_build"]
    (key, index), = ttree._KNN_INDEX_CACHE.values()
    assert index is first._knn
    assert key == ttree._index_key(xy, metric, torch.device("cpu"))


def test_sweep_matches_cold_build_and_jax():
    """``min_metric`` 0.25, 0.5, 0.75 on one cloud: one index, and the
    warm 0.5 and 0.75 runs equal cold builds and the JAX package's."""
    xy, metric = _cloud()
    runs = [_run(tpkg, xy, metric, m) for m in (0.25, 0.5, 0.75)]
    assert runs[1][1] is runs[0][1] and runs[2][1] is runs[0][1]
    for warm, m in ((runs[1][0], 0.5), (runs[2][0], 0.75)):
        ttree._KNN_INDEX_CACHE.clear()
        cold, index = _run(tpkg, xy, metric, m)
        assert index is not runs[0][1]
        _assert_same(cold, warm)
        jtree._KNN_INDEX_CACHE.clear()
        _assert_same(_run(jpkg, xy, metric, m)[0], warm)
    assert runs[2][0].data_final_mesh["iterations"] > 20


@pytest.mark.parametrize("change", ["metric_ulp", "coordinate"]
                         + list(POLICY))
def test_rebuild_on_change(monkeypatch, change):
    xy, metric = _cloud()
    first = _tree(xy, metric)
    if change == "metric_ulp":
        metric = metric.copy()
        metric[1234] = np.nextafter(metric[1234], np.inf)
    elif change == "coordinate":
        xy = xy.copy()
        xy[17, 1] += 1e-9
    else:
        monkeypatch.setattr(KNNIndex, change, POLICY[change])
    second = _tree(xy, metric)
    assert second._knn is not first._knn
    assert second._knn._grid is not None
    assert ttree._KNN_INDEX_CACHE["entry"][1] is second._knn
    # and the changed index is what a cold build gives
    ref = KNNIndex(xy, values=metric, device="cpu")
    assert ("dil_pts" in ref._grid) == ("dil_pts" in second._knn._grid)
    for name in ("C", "_dil_keep"):
        assert ref._grid.get(name) == second._knn._grid.get(name)


def test_device_is_in_the_key():
    xy, metric = _cloud()
    cpu = ttree._index_key(xy, metric, torch.device("cpu"))
    assert cpu == ttree._index_key(xy.copy(), metric.copy(), "cpu")
    assert cpu != ttree._index_key(xy, metric, torch.device("cuda"))
    assert (ttree._index_key(xy, metric, "cuda")
            != ttree._index_key(xy, metric, "cuda:1"))


def test_one_entry():
    clouds = [_cloud(seed) for seed in (1, 2, 3)]
    trees = [_tree(*c) for c in clouds]
    assert len({id(t._knn) for t in trees}) == 3
    assert len(ttree._KNN_INDEX_CACHE) == 1
    assert ttree._KNN_INDEX_CACHE["entry"][1] is trees[2]._knn
    again = _tree(*clouds[0])
    assert again._knn is not trees[0]._knn
    assert _tree(*clouds[0])._knn is again._knn


def test_sharded_run_leaves_the_cache(monkeypatch):
    xy, metric = _cloud()
    single = _tree(xy, metric)
    entry = ttree._KNN_INDEX_CACHE["entry"]
    monkeypatch.setattr(tmesh, "VIRTUAL_SHARDS", 3)
    sharded = _tree(xy, metric)
    assert not isinstance(sharded._knn, KNNIndex)
    assert ttree._KNN_INDEX_CACHE == {"entry": entry}
    assert entry[1] is single._knn
    # the mesh's own tree is never cached either
    ttree._KNN_INDEX_CACHE.clear()
    _tree(xy, metric)
    assert ttree._KNN_INDEX_CACHE == {}


def test_reused_index_state_is_a_fresh_builds():
    """After a run and its export have queried the index, the next run's
    index holds what a fresh build holds, and answers as it does."""
    xy, metric = _cloud()
    s3, index = _run(tpkg, xy, metric, 0.5)
    exp = tpkg.ExportData(s3, write_times=["0"], device="cpu")
    exp.interpolate(xy, metric[:, None, None].astype(np.float32))
    far = np.asarray([[0.5, 0.5], [5.0, 5.0], [-3.0, 0.2]])
    index.query(far, 8)
    assert index.last_fallback > 0
    warm = _tree(xy, metric)._knn
    fresh = KNNIndex(xy, values=metric, device="cpu")
    assert warm is index
    assert warm.last_fallback == fresh.last_fallback == 0
    assert torch.equal(warm._values, fresh._values)
    np.testing.assert_array_equal(warm._values_host, fresh._values_host)
    q = np.random.default_rng(9).uniform(-0.2, 1.2, size=(500, 2))
    for a, b in zip(warm.query(q, 8), fresh.query(q, 8)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert warm.last_fallback == fresh.last_fallback
    np.testing.assert_array_equal(warm.predict(q, 8), fresh.predict(q, 8))


def test_cached_index_waits_for_its_workers():
    """A worker registered as holding the cached index ends before the
    next tree takes it; a worker holding another object does not hold
    the tree up."""
    xy, metric = _cloud()
    index = _tree(xy, metric)._knn
    done = threading.Event()
    release = threading.Event()

    def holder():
        time.sleep(0.3)
        done.set()

    def other():
        release.wait(30)
    workers = [threading.Thread(target=holder, daemon=True),
               threading.Thread(target=other, daemon=True)]
    graphs.register_worker(workers[0], holds=index)
    graphs.register_worker(workers[1], holds=object())
    for w in workers:
        w.start()
    try:
        assert _tree(xy, metric)._knn is index
        assert done.is_set() and workers[1].is_alive()
    finally:
        release.set()
        workers[1].join()
