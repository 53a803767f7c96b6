"""The benchmark's cylinder3D cell (``s3bench``'s ``cyl3d.export``) at a
tiny size, on the CPU, through its harness and the port.

- A tiny copy of the configuration (3,000 points, ``uniform_levels`` 3,
  the cylinder to level 6, 6 snapshots) runs one job and comes out
  ``correct`` against the plain reference: no cell apart, the field within
  float32 rounding.
- Its snapshots exported one and three per ``interpolate`` call give the
  one call's field, bitwise.
- A profiled job whose geometry levels overflow the window (its ``k_geo``
  narrowed below the entry surface, the cause the card's 3D surface
  takes) records the counts of ``engine.geometry_window``,
  ``engine.geometry_level``, ``export.interpolate`` and
  ``export.weights``; the level counts add up to ``epoch_stats``'s
  ``geometry_route``, and the benchmark's ``geometry_host_s`` reads them.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparsespatialsampling_torch as tpkg  # noqa: E402
from sparsespatialsampling_torch import trace  # noqa: E402
from sparsespatialsampling_torch.engine import tree as ttree  # noqa: E402

BENCH = Path(__file__).resolve().parents[1] / "s3bench"
SEED = 2 ** 33 + 17
N_SNAPSHOTS = 6
CAUSES = ("route", "level_cap", "overflow", "mdl")


@pytest.fixture(scope="module")
def harness():
    """The benchmark's harness module, its directory on the path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(BENCH))
        import harness
        yield harness


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny copy of ``cyl3d`` as the cell ``tc.export`` (one call an
    export) under a root of its own; ``_cell`` adds ``tc.b<n>`` beside
    it, ``export_batch`` n."""
    root = tmp_path_factory.mktemp("bench")
    for sub in ("gen", "metrics"):
        shutil.copytree(BENCH / sub, root / sub)
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    config = json.loads((BENCH / "configs/cyl3d.json").read_text())
    config.update(name="tc", n_points=3000, n_snapshots=N_SNAPSHOTS,
                  settings={"uniform_levels": 3, "n_cells_max": 500})
    config["geometries"][1]["min_refinement_level"] = 6
    (root / "configs/tc.json").write_text(json.dumps(config))
    (root / "traffic/tc.export.json").write_text(json.dumps(
        {"config": "tc", "grids": [{}], "export": True, "pool": 2,
         "limits": {"cells_unmatched_pct": 0.0, "field_gap": 1e-5}}))
    return root


def _cell(harness, root, batch=None):
    if batch is None:
        return harness.Cell("tc.export", root)
    traffic = json.loads((root / "traffic/tc.export.json").read_text())
    (root / f"traffic/tc.b{batch}.json").write_text(
        json.dumps({**traffic, "export_batch": batch}))
    return harness.Cell(f"tc.b{batch}", root)


@pytest.fixture(scope="module")
def one_call(harness, root):
    """``(inputs, job)`` of one job of ``tc.export``, its results kept."""
    cell = _cell(harness, root)
    inputs = cell.inputs(SEED, 0, "cpu")
    ttree._KNN_INDEX_CACHE.clear()
    rec = harness.run_job(cell, inputs, "cpu", root / "one",
                          keep=True)
    ttree._KNN_INDEX_CACHE.clear()
    return inputs, rec


def test_tiny_cell_is_correct(harness, root, one_call):
    cell = _cell(harness, root)
    inputs, rec = one_call
    grid = rec["grids"][0]
    # the surface refinement reached the cylinder's level
    assert grid["levels"].max() == 6
    assert grid["field"].shape == (len(grid["levels"]), N_SNAPSHOTS)
    numbers = harness.check(cell, inputs, rec["grids"], "cpu")
    assert numbers["cells_unmatched_pct"] == 0.0
    assert numbers["field_gap"] <= 1e-5
    ok, shown = harness.verdict(numbers, cell.traffic["limits"])
    assert ok, shown


@pytest.mark.parametrize("batch", [1, 3])
def test_export_batches_give_the_one_call_field(harness, root, one_call,
                                                batch):
    cell = _cell(harness, root, batch)
    assert cell.export_batch == batch
    inputs, want = one_call
    ttree._KNN_INDEX_CACHE.clear()
    got = harness.run_job(cell, inputs, "cpu",
                          root / f"b{batch}", keep=True)
    ttree._KNN_INDEX_CACHE.clear()
    a, b = want["grids"][0], got["grids"][0]
    np.testing.assert_array_equal(a["levels"], b["levels"])
    assert b["field"].dtype == a["field"].dtype
    np.testing.assert_array_equal(a["field"], b["field"])


@pytest.fixture(scope="module")
def host_walk(harness, root, one_call):
    """A profiled job of ``tc.b1`` (one snapshot a call) whose geometry
    windows are narrowed below their entry surface: ``(the job's record,
    the program's span records, its geometry_route, the cell)``."""
    cell = _cell(harness, root, 1)
    inputs, _ = one_call
    shape = ttree.SamplingTree._geometry_loop_shape
    stats = []
    generate = tpkg.SparseSpatialSampling.execute_grid_generation

    def narrow(self, g, surface, gmin, gmax):
        if id(g) not in self._geo_loop_shapes:
            _, cap = shape(self, g, surface, gmin, gmax)
            self._geo_loop_shapes[id(g)] = (max(int(surface.size) - 1, 1),
                                            cap)
        return self._geo_loop_shapes[id(g)]

    def kept(self):
        generate(self)
        stats.append(self.data_final_mesh["epoch_stats"]["geometry_route"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttree.SamplingTree, "_geometry_loop_shape", narrow)
        mp.setattr(tpkg.SparseSpatialSampling, "execute_grid_generation",
                   kept)
        ttree._KNN_INDEX_CACHE.clear()
        trace.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            rec = harness.run_job(cell, inputs, "cpu",
                                  root / "walk", traced=True)
        records = trace.records()
        trace.clear()
        ttree._KNN_INDEX_CACHE.clear()
    assert len(stats) == 1
    return rec, records, stats[0], cell


def _named(records, name):
    return [r for r in records if r["name"] == name]


def test_geometry_level_counts_add_up_to_the_route(host_walk):
    _, records, route, _ = host_walk
    assert route["host_levels"] >= 1 and route["window_levels"] == 0
    assert route["host_fallback"]["overflow"] == route["host_levels"]
    levels = _named(records, "engine.geometry_level")
    assert len(levels) == route["host_levels"]
    for r in levels:
        c = r["counts"]
        causes = [k for k in CAUSES if k in c]
        assert set(c) == {"cells", "children", "removed", *causes}
        assert len(causes) == 1 and c[causes[0]] == 1
        assert c["cells"] >= 1 and c["children"] == 8 * c["cells"]
        assert 0 <= c["removed"] < c["children"]
    for cause in CAUSES:
        assert sum(r["counts"].get(cause, 0) for r in levels) == route[
            "host_fallback"][cause]
    # every window saw a surface wider than its k_geo and ran no level
    windows = _named(records, "engine.geometry_window")
    assert windows and len(windows) == route["host_fallback"]["overflow"]
    for r in windows:
        c = r["counts"]
        assert set(c) == {"surface", "levels", "k_geo"}
        assert c["surface"] > c["k_geo"] >= 1 and c["levels"] == 0


def test_export_counts_name_calls_snapshots_and_the_cache(host_walk):
    _, records, _, cell = host_walk
    calls = _named(records, "export.interpolate")
    assert len(calls) == N_SNAPSHOTS
    assert sum(r["counts"]["snapshots"] for r in calls) == N_SNAPSHOTS
    n = cell.config["n_points"]
    assert all(r["counts"]["bytes"] == 4 * n * r["counts"]["snapshots"]
               for r in calls)
    weights = _named(records, "export.weights")
    assert len(weights) == 1
    assert weights[0]["counts"] in ({"consumed": 1}, {"built": 1})


def test_geometry_host_s_reads_the_host_levels(harness, host_walk):
    rec, records, _, cell = host_walk
    entries = [m for m in json.loads(
        (BENCH.parent / "BENCHMARK.json").read_text())["per_layer"]
        if m["name"] == "geometry_host_s"]
    assert len(entries) == 1
    run = harness.Run(cell, [rec], 1.0, 0)
    trace.clear()
    assert harness.read_metrics(run, entries) == {}
    want = sum(r["end_ns"] - r["start_ns"] for r in _named(
        records, "engine.geometry_level")) / 1e9
    trace._records.extend(records)
    try:
        got = harness.read_metrics(run, entries)["geometry_host_s"]
    finally:
        trace.clear()
    assert got["value"] == pytest.approx(want) and want > 0.0
    assert got["unit"] == "s"
