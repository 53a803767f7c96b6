"""What the capture of the device-resident loops' windows as CUDA graphs
(``engine/graphs.py``) relies on, held on the CPU.

- Both loop bodies update the state in place: after every iteration each
  state tensor keeps its ``data_ptr()`` (a replay reads and writes the
  addresses the capture saw), in 2D metric mode, in 3D with
  ``n_cells_max``, with ``max_delta_level``, and in the geometry loop.
- One iteration of each body runs under ``FakeTensorMode``, which raises
  on an operation whose output depends on the data (``nonzero``, boolean
  masks, reads of device values): none is left in a body, its epoch or
  the closed-form geometry tests.
- The STL inside test's fixed-size near-band compaction gives the flags
  of the ``nonzero`` route bit for bit, on both winding routes, with an
  empty band and with every point in the band.
- The plain winding number with a count equals it on the first ``count``
  rows, zeros after.
- The window keys change with the ring plan, the rescue rows, ``cap``
  and ``k_max`` (and the geometry key with its shapes and target).
- On the CPU every iteration runs eagerly and is counted so; a mesh's
  windows are counted as eager with the cause ``mesh``.
- On the card (skipped here): graphs against the eager body, bitwise, with
  one warm-up and one capture a key, and the launch counts equal.
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import sparsespatialsampling_torch as tpkg  # noqa: E402
from bench import synthetic_sphere_stl  # noqa: E402
from sparsespatialsampling_torch.engine import tree as ttree  # noqa: E402
from sparsespatialsampling_torch.engine.tree import SamplingTree  # noqa: E402
from sparsespatialsampling_torch.geometry import stl as tstl  # noqa: E402
from sparsespatialsampling_torch.ops import topk, winding  # noqa: E402
from sparsespatialsampling_torch.ops.knn import (  # noqa: E402
    KNNIndex as TorchKNN)
from sparsespatialsampling_torch.parallel import mesh  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as ``tests/test_torch_device_loop.py`` runs:
    the loops issue many small tensor operations."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud(d: int, n: int = 3000, seed: int = 0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, size=(n, d))
    r = np.linalg.norm(pts - 0.4, axis=1)
    return pts, np.exp(-r ** 2 / 0.03) + 0.01


def _geometries(d: int, refine: bool = False):
    return [tpkg.CubeGeometry("domain", True, [0.0] * d, [1.0] * d),
            tpkg.SphereGeometry("hole", False, [0.7] * d, 0.08,
                                refine=refine, min_refinement_level=(
                                    7 if refine else None))]


def _grid(d: int, device="cpu", refine: bool = False, grid: bool = True,
          **kw):
    """A grid of the seeded cloud; ``grid`` False: the full-scan core."""
    TorchKNN.GRID_MIN_POINTS = 1000 if grid else 10 ** 9
    pts, metric = _cloud(d)
    s3 = tpkg.SparseSpatialSampling(pts, metric, _geometries(d, refine),
                                    save_path=tempfile.mkdtemp(),
                                    save_name="g", device=device, **kw)
    s3.execute_grid_generation()
    return s3


@pytest.fixture(autouse=True)
def _restore_grid_threshold(monkeypatch):
    monkeypatch.setattr(TorchKNN, "GRID_MIN_POINTS",
                        TorchKNN.GRID_MIN_POINTS)


# the grid kNN (dilated layout, ring and rescue) in 2D, the full-scan core
# in 3D, where the ring's radius-4 rows are slow on the CPU
LOOP_CASES = {
    "metric2d": (2, {"uniform_levels": 3, "min_metric": 0.7}),
    "ncells3d": (3, {"uniform_levels": 2, "n_cells_max": 500,
                     "grid": False}),
    "mdl2d": (2, {"uniform_levels": 3, "min_metric": 0.6,
                  "max_delta_level": True}),
}


def _address_probe(monkeypatch, name: str) -> list:
    """Wrap the tree module's ``name`` body: each call records whether
    every state tensor kept its ``data_ptr()``."""
    body = getattr(ttree, name)
    kept = []

    def probe(s, *args):
        before = {k: v.data_ptr() for k, v in s.items()}
        body(s, *args)
        kept.append({k: s[k].data_ptr() for k in before} == before
                    and set(s) == set(before))
    monkeypatch.setattr(ttree, name, probe)
    return kept


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_loop_body_keeps_state_addresses(monkeypatch, case):
    d, kw = LOOP_CASES[case]
    kept = _address_probe(monkeypatch, "loop_body")
    s3 = _grid(d, **kw)
    st = s3.data_final_mesh["epoch_stats"]
    assert st["windows"] > 0 and len(kept) >= 3
    assert all(kept)
    # one eager iteration a step: each window's iterations and the
    # predicated step enqueued after its last (two after a guard)
    assert st["graphs"]["eager_iterations"] == len(kept) >= (
        st["window_iters"] + st["windows"])
    assert st["graphs"]["eager_causes"]["cpu"] == len(kept)
    assert st["graphs"]["captures"] == st["graphs"]["replays"] == 0


def test_geometry_body_keeps_state_addresses(monkeypatch):
    kept = _address_probe(monkeypatch, "geometry_level_body")
    s3 = _grid(2, refine=True, uniform_levels=3, min_metric=0.6)
    route = s3.data_final_mesh["epoch_stats"]["geometry_route"]
    assert route["windows"] > 0 and len(kept) >= 3
    assert all(kept)
    assert route["graphs"]["eager_iterations"] == len(kept) >= (
        route["window_levels"] + route["windows"])


def _fake_first_call(monkeypatch, name: str) -> list:
    """Run the first call of the tree module's ``name`` body once more on
    fake copies of its state under ``FakeTensorMode`` (which raises on a
    data-dependent operation), then the real call."""
    body = getattr(ttree, name)
    done = []

    def probe(s, *args):
        if not done:
            with FakeTensorMode(allow_non_fake_inputs=True) as mode:
                fake = {k: mode.from_tensor(v) for k, v in s.items()}
                body(fake, *args)
            done.append(True)
        body(s, *args)
    monkeypatch.setattr(ttree, name, probe)
    return done


@pytest.mark.parametrize("case", ["ncells3d", "mdl2d"])
def test_loop_body_has_no_data_dependent_operation(monkeypatch, case):
    d, kw = LOOP_CASES[case]
    done = _fake_first_call(monkeypatch, "loop_body")
    _grid(d, **kw)
    assert done


def test_geometry_body_has_no_data_dependent_operation(monkeypatch):
    done = _fake_first_call(monkeypatch, "geometry_level_body")
    _grid(2, refine=True, uniform_levels=3, min_metric=0.6)
    assert done


# --------------------------------------------------------------------- #
# the STL near band                                                     #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def sphere_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("loop_graph") / "sphere.stl")
    assert synthetic_sphere_stl(path, n_lat=16, n_lon=12) == 360
    return path


def _nonzero_inside(g, points):
    """The near band through ``torch.nonzero``: the route the fixed-size
    compaction replaced, kept here as the reference."""
    pts = points.to(torch.float32)
    tab = g._tables(pts.device)
    cell = torch.floor((pts - tab["origin"]) * tab["inv_h"])
    in_grid = ((cell >= 0) & (cell < tab["dims_f"])).all(-1)
    cell = torch.where(in_grid[:, None], cell, 0.0).to(torch.int64)
    dims = tab["dims"]
    flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    state = torch.where(in_grid, tab["state"][flat],
                        torch.zeros((), dtype=torch.int8))
    inside = state == 1
    rows = torch.nonzero(state == 2).flatten()
    if rows.numel():
        near = pts[rows].contiguous()
        w = (tstl._fast_winding(near, tab["fw"]) if "fw" in tab else
             winding.winding_number_plain(near, tab["v0"], tab["v1"],
                                          tab["v2"]))
        inside[rows] = w > 0.5
    in_box = ((pts >= tab["lower"]) & (pts <= tab["upper"])).all(-1)
    return inside & in_box, state


def _band_points(g, which: str) -> torch.Tensor:
    """f32 points: ``mixed`` (around the sphere, some in the band),
    ``empty`` (far from it) or ``all_near`` (every one in a near-band
    voxel, the voxels' centres and corners' insides)."""
    rng = np.random.default_rng(5)
    lo, hi = g.bounding_box()
    if which == "mixed":
        pts = rng.uniform(lo - 0.02, hi + 0.02, size=(400, 3))
    elif which == "empty":
        pts = rng.uniform(hi + 0.5, hi + 1.0, size=(200, 3))
    else:
        sg = g._sg
        ijk = np.argwhere(np.asarray(sg["state"]).reshape(
            tuple(np.asarray(sg["dims"]))) == 2)
        ijk = ijk[rng.choice(len(ijk), 100, replace=False)]
        frac = np.stack([np.full(3, 0.5), rng.uniform(0.1, 0.9, 3)])
        pts = ((ijk[:, None, :] + frac[None]) / np.asarray(sg["inv_h"])
               + np.asarray(sg["origin"])).reshape(-1, 3)
    return torch.from_numpy(pts.astype(np.float32))


@pytest.mark.parametrize("route", ["exact", "fast_winding"])
@pytest.mark.parametrize("which", ["mixed", "empty", "all_near"])
def test_stl_near_band_matches_nonzero_route(sphere_path, monkeypatch,
                                             route, which):
    if route == "fast_winding":
        monkeypatch.setattr(tstl, "_FW_MIN_TRIS", 100)
    g = tpkg.GeometrySTL3D("s", False, sphere_path, device="cpu")
    assert ("fw" in g._tables(torch.device("cpu"))) == (
        route == "fast_winding")
    pts = _band_points(g, which)
    want, state = _nonzero_inside(g, pts)
    n_near = int((state == 2).sum())
    assert {"mixed": 0 < n_near < pts.shape[0], "empty": n_near == 0,
            "all_near": n_near == pts.shape[0]}[which]
    assert torch.equal(g._inside(pts), want)
    nodes = pts[:pts.shape[0] // 8 * 8].reshape(-1, 8, 3)
    for refine in (False, True):
        m = want[:nodes.shape[0] * 8].reshape(-1, 8)
        flags = g.check_cells(nodes, refine)
        assert torch.equal(flags, m.any(1) if refine else m.all(1))


@pytest.mark.parametrize("count", [0, 17, 50])
def test_plain_winding_with_count(sphere_path, count):
    g = tpkg.GeometrySTL3D("s", False, sphere_path, device="cpu")
    v = [torch.from_numpy(g.triangles[:, i].astype(np.float32))
         for i in range(3)]
    pts = _band_points(g, "mixed")[:50].contiguous()
    c = torch.tensor([count], dtype=torch.int32)
    got = winding.winding_number(pts, *v, count=c)
    assert got.shape == (50,)
    assert torch.equal(got[:count], winding.winding_number_plain(
        pts[:count], *v))
    assert not got[count:].any()
    for bad in (c.long(), torch.tensor([count, 1], dtype=torch.int32)):
        with pytest.raises(ValueError, match="count"):
            winding.winding_number(pts, *v, count=bad)


# --------------------------------------------------------------------- #
# keys and the eager route                                              #
# --------------------------------------------------------------------- #
def test_window_keys_follow_what_the_capture_bakes_in():
    pts, metric = _cloud(2)
    TorchKNN.GRID_MIN_POINTS = 1000     # a grid, so a ring
    tree = SamplingTree(pts, metric, _geometries(2), n_cells=500,
                        uniform_level=3, device="cpu")
    assert tree._epoch_stats["core"] == "dil"
    shape = dict(cap=4096, k_max=8, k_sel=8, iters=64, block=32768)

    def key(**kw):
        plan, rescue = tree._loop_ring()
        return tree._window_key(**{**shape, **kw}, plan=plan, rescue=rescue)
    base = key()
    assert key() == base
    changed = [key(cap=8192), key(k_max=16), key(k_sel=16), key(iters=32)]
    tree._loop_ring_rows = 256
    changed.append(key())
    tree._loop_ring_rows = 2000
    changed.append(key())
    tree._loop_rescue_rows = 128
    changed.append(key())
    assert len({base, *changed}) == len(changed) + 1
    g = tree._geometry[1]
    geo = tree._geometry_key(g, 4096, 256, 7)
    assert len({geo, tree._geometry_key(g, 8192, 256, 7),
                tree._geometry_key(g, 4096, 512, 7),
                tree._geometry_key(g, 4096, 256, 8),
                tree._geometry_key(tree._geometry[0], 4096, 256, 7)}) == 5


def test_switched_off_and_mesh_windows_run_eagerly(monkeypatch):
    """On the CPU the switch changes nothing (every iteration is eager for
    the CPU); under a mesh every window iteration is eager for the mesh."""
    monkeypatch.setattr(SamplingTree, "_LOOP_GRAPHS", False)
    off = _grid(2, uniform_levels=3, min_metric=0.7)
    monkeypatch.setattr(mesh, "VIRTUAL_SHARDS", 2)
    meshed = _grid(2, uniform_levels=3, min_metric=0.7)
    a = off.data_final_mesh["epoch_stats"]["graphs"]
    b = meshed.data_final_mesh["epoch_stats"]["graphs"]
    assert a["eager_causes"]["cpu"] == a["eager_iterations"] > 0
    assert b["eager_causes"]["mesh"] == b["eager_iterations"] > 0
    assert meshed.data_final_mesh["epoch_stats"]["core"].startswith("shard")
    np.testing.assert_array_equal(off.levels, meshed.levels)


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_graphs_match_eager_body_on_card(monkeypatch, case):
    """Graph replays against the eager body: the same rows, the metric
    trace bitwise, one warm-up and one capture a key, every other step a
    replay, and the kernels' launch counts equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs have no CPU mode")
    d, kw = LOOP_CASES[case]
    runs = {}
    for graphs_on in (True, False):
        monkeypatch.setattr(SamplingTree, "_LOOP_GRAPHS", graphs_on)
        before = topk.launches
        s3 = _grid(d, device="cuda", refine=True, **kw)
        s3._knn_prefetch["thread"] and s3._knn_prefetch["thread"].join()
        runs[graphs_on] = (s3, topk.launches - before)
    (on, n_on), (off, n_off) = runs[True], runs[False]
    np.testing.assert_array_equal(on.levels, off.levels)
    np.testing.assert_array_equal(on.centers, off.centers)
    assert on.data_final_mesh["metric_per_iter"] == \
        off.data_final_mesh["metric_per_iter"]
    assert n_on == n_off
    st = on.data_final_mesh["epoch_stats"]
    off_st = off.data_final_mesh["epoch_stats"]
    for stats, eager in ((st["graphs"], off_st["graphs"]),
                         (st["geometry_route"]["graphs"],
                          off_st["geometry_route"]["graphs"])):
        assert stats["eager_iterations"] == stats["captures"] == \
            stats["eager_causes"]["warmup"]
        # the same steps, all but the warm-ups replays
        assert stats["replays"] + stats["eager_iterations"] == \
            eager["eager_causes"]["off"]
