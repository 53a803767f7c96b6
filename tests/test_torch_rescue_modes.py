"""``SamplingTree.FULL_RESCUE``, the port's counterpart of the JAX
package's ``S3_TPU_FULL_RESCUE`` (``tests/test_device_loop.py:214-240``).

The in-epoch full-scan rescue changes only where bad cells are resolved,
in the epoch or by the host escalation, never the grid:

- ``"auto"``, ``"1"`` and ``"0"`` grow the same cells and iterations on
  the hole-heavy cloud of the JAX package's test, and on a cloud whose
  void is wider than the ring, where bad cells do appear;
- ``"auto"`` turns the rescue on when bad cells appear, ``"1"`` starts
  with it on, ``"0"`` never turns it on and rescues no query;
- the grid and ``_rescue_active`` equal the JAX package's under
  ``S3_TPU_FULL_RESCUE`` set to the same mode, on both clouds and on a
  gridless (full-scan) cloud;
- the host loop (``DEVICE_LOOP = False``) grows the device loop's grid in
  every mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparsespatialsampling_tpu import CubeGeometry as JCube  # noqa: E402
from sparsespatialsampling_tpu import SphereGeometry as JSphere  # noqa: E402
from sparsespatialsampling_tpu.engine import tree as jtree  # noqa: E402
from sparsespatialsampling_tpu.ops.knn import KNNIndex as JaxKNN  # noqa: E402
from sparsespatialsampling_torch import CubeGeometry as TCube  # noqa: E402
from sparsespatialsampling_torch import SphereGeometry as TSphere  # noqa: E402
from sparsespatialsampling_torch.engine import tree as ttree  # noqa: E402
from sparsespatialsampling_torch.ops.knn import KNNIndex as TorchKNN  # noqa: E402

MODES = ["auto", "1", "0"]
MODE_IDS = ["auto", "always", "never"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the device loop issues many small operations,
    which slow down many times over when the suite's workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hole():
    """The cloud of ``tests/test_device_loop.py:224-229``: a hole of
    radius 0.12 with the obstacle over it."""
    rng = np.random.default_rng(0)
    xy = rng.uniform([0, 0], [1, 1], size=(9000, 2))
    r = np.linalg.norm(xy - [0.3, 0.5], axis=1)
    xy, r = xy[r > 0.12][:7000], r[r > 0.12][:7000]
    metric = np.exp(-np.maximum(r - 0.12, 0) / 0.05) + 0.01
    return xy, metric, ([0.3, 0.5], 0.12), 1000


def _wide_void():
    """A void of radius 0.3 on the top wall around an obstacle of 0.05
    (``tests/test_torch_ring.py``'s ``void-wider-than-ring``)."""
    rng = np.random.default_rng(0)
    xy = rng.uniform([0, 0], [1, 1], size=(9000, 2))
    r = np.linalg.norm(xy - [0.5, 0.95], axis=1)
    xy, r = xy[r > 0.3][:7000], r[r > 0.3][:7000]
    metric = np.exp(-np.maximum(r - 0.3, 0) / 0.05) + 0.01
    return xy, metric, ([0.5, 0.95], 0.05), 1000


def _gridless():
    """The hole-heavy cloud under a grid threshold it does not reach: the
    full scan answers every query."""
    xy, metric, hole, _ = _hole()
    return xy, metric, hole, 10 ** 9


CLOUDS = {"hole": _hole, "wide-void": _wide_void, "gridless": _gridless}
_runs = {}


def _grid(pkg: str, cloud: str, mode: str, device_loop: bool = True):
    """``(sorted centres, sorted levels, iterations, rescue switch before
    and after the refinement, epoch counters)`` of one grid, ``pkg`` the
    port ("torch") or the JAX package ("jax"); each run once a module."""
    key = (pkg, cloud, mode, device_loop)
    if key in _runs:
        return _runs[key]
    xy, metric, (centre, radius), grid_from = CLOUDS[cloud]()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TorchKNN, "GRID_MIN_POINTS", grid_from)
        mp.setattr(JaxKNN, "GRID_MIN_POINTS", grid_from)
        mp.setattr(ttree.SamplingTree, "FULL_RESCUE", mode)
        mp.setattr(ttree.SamplingTree, "DEVICE_LOOP", device_loop)
        mp.setenv("S3_TPU_FULL_RESCUE", mode)
        mp.setenv("S3_TPU_DEVICE_LOOP", "1" if device_loop else "0")
        if pkg == "torch":
            tree = ttree.SamplingTree(
                xy, metric, [TCube("domain", True, [0, 0], [1, 1]),
                             TSphere("hole", False, centre, radius)],
                uniform_level=3, n_cells=1500, device="cpu")
        else:
            tree = jtree.SamplingTree(
                xy, metric, [JCube("domain", True, [0, 0], [1, 1]),
                             JSphere("hole", False, centre, radius)],
                uniform_level=3, n_cells=1500)
        before = tree._rescue_active
        tree.refine()
    c = np.asarray(tree.all_centers)
    lv = np.asarray(tree.all_levels).ravel()
    order = np.lexsort((lv,) + tuple(c.T))
    _runs[key] = out = (c[order], lv[order],
                        tree.data_final_mesh["iterations"], before,
                        tree._rescue_active, dict(tree._epoch_stats))
    return out


def _assert_same_grid(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
    assert a[2] == b[2]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("cloud", ["hole", "wide-void"])
def test_modes_grow_one_grid(cloud, mode):
    _assert_same_grid(_grid("torch", cloud, mode), _grid("torch", cloud,
                                                          "auto"))


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("cloud", ["hole", "wide-void"])
def test_rescue_switch(cloud, mode):
    *_, before, after, st = _grid("torch", cloud, mode)
    if cloud == "wide-void":
        # cells the ring cannot prove exact appear here in every mode
        assert _grid("torch", cloud, "0")[-1]["n_bad_cells"] > 0
    if mode == "auto":
        assert not before
        assert after == (st["n_bad_cells"] > 0)
    elif mode == "1":
        assert before and after
    else:
        assert not before and not after
        assert st["rescued_queries"] == 0
    if cloud == "wide-void" and mode != "0":
        assert st["rescued_queries"] > 0


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_matches_jax(cloud, mode):
    port, ref = _grid("torch", cloud, mode), _grid("jax", cloud, mode)
    _assert_same_grid(port, ref)
    assert port[3] == ref[3] and port[4] == ref[4]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("cloud", ["hole", "wide-void"])
def test_host_loop_matches_device_loop(cloud, mode):
    host = _grid("torch", cloud, mode, device_loop=False)
    loop = _grid("torch", cloud, mode)
    _assert_same_grid(host, loop)
    assert host[4] == loop[4]
    assert host[-1]["windows"] == 0 < loop[-1]["windows"]


def test_unknown_mode_raises(monkeypatch):
    monkeypatch.setattr(ttree.SamplingTree, "FULL_RESCUE", "on")
    xy, metric, _, _ = _gridless()
    with pytest.raises(ValueError, match="FULL_RESCUE"):
        ttree.SamplingTree(xy, metric,
                           [TCube("domain", True, [0, 0], [1, 1])],
                           device="cpu")


def _tree(mode: str, monkeypatch, cloud: str = "hole"):
    xy, metric, (centre, radius), grid_from = CLOUDS[cloud]()
    monkeypatch.setattr(TorchKNN, "GRID_MIN_POINTS", grid_from)
    monkeypatch.setattr(ttree.SamplingTree, "FULL_RESCUE", mode)
    return ttree.SamplingTree(
        xy, metric, [TCube("domain", True, [0, 0], [1, 1]),
                     TSphere("hole", False, centre, radius)],
        uniform_level=3, n_cells=1500, device="cpu")


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_window_rescue_rows(monkeypatch, mode):
    """The rescue rows of a window's epochs, part of its graph key: none
    before the rescue is on, at least ``_LOOP_RESCUE_MIN`` from the first
    window in mode "1", none ever in mode "0"."""
    tree = _tree(mode, monkeypatch)
    assert tree._loop_ring()[1] == (ttree._LOOP_RESCUE_MIN if mode == "1"
                                    else 0)
    tree._loop_rescue_rows = 512      # a window's epochs left 512 rows bad
    tree._maybe_enable_rescue()       # and their cells were escalated
    assert tree._rescue_active == (mode != "0")
    assert tree._loop_ring()[1] == (0 if mode == "0" else 512)
    # the window key of each differs, so no capture is replayed with
    # another rescue
    keys = {tree._window_key(64, 8, 8, 16, 512, plan, rescue)
            for plan, rescue in [((), 0), ((), 128), ((), 512)]}
    assert len(keys) == 3


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_mesh_keeps_the_flag_and_never_rescues(monkeypatch, mode):
    """Under a mesh the JAX package sets the flag from the mode and its
    sharded epoch never reads it; ``_maybe_enable_rescue`` returns."""
    from sparsespatialsampling_torch.parallel import mesh as tmesh
    monkeypatch.setattr(tmesh, "VIRTUAL_SHARDS", 3)
    tree = _tree(mode, monkeypatch)
    assert tree._mesh is not None
    assert tree._rescue_active == (mode == "1")
    tree._maybe_enable_rescue()
    assert tree._rescue_active == (mode == "1")
    assert tree._loop_ring()[1] == 0


def test_gridless_auto_stays_off(monkeypatch):
    """Without a grid no query is bad, and the switch never turns on."""
    tree = _tree("auto", monkeypatch, "gridless")
    assert tree._knn._grid is None
    tree._maybe_enable_rescue()
    assert not tree._rescue_active and tree._loop_ring() == ((), 0)
