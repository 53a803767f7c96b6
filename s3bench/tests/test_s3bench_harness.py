"""The harness: discovery by name, the generators, the metric arithmetic
and the bound arithmetic."""
import json
import math
import shutil
import textwrap

import numpy as np
import pytest
import torch

import harness
import tracing


RING2D = textwrap.dedent('''
    import numpy as np

    def make(config, rng, device):
        xy = rng.uniform(config["box"][0], config["box"][1],
                         size=(config["n_points"], 2))
        r = np.hypot(xy[:, 0], xy[:, 1])
        return {"points": xy, "metric": np.exp(-(r - 0.5) ** 2 / 0.01)}
''')

DOMAIN2D = {"type": "cube", "name": "domain", "keep_inside": True,
            "lower": [-1, -1], "upper": [1, 1]}


def _ring2d_cell(root, name: str, geometries: list):
    """A 2D cell ``<name>.cold`` on the ring generator, one grid."""
    (root / "gen/ring2d.py").write_text(RING2D)
    (root / f"configs/{name}.json").write_text(json.dumps({
        "name": name, "generator": "ring2d", "dims": 2,
        "n_points": 2000, "box": [[-1, -1], [1, 1]],
        "geometries": geometries,
        "settings": {"uniform_levels": 3, "n_cells_max": 300}}))
    (root / f"traffic/{name}.cold.json").write_text(json.dumps({
        "config": name, "grids": [{}], "export": False, "pool": 3,
        "limits": {"cells_unmatched_pct": 0.0, "metric_trace_gap": 1e-5}}))
    return harness.Cell(f"{name}.cold", root)


def _job_and_check(cell, root):
    inputs = cell.inputs(5, 0, "cpu")
    rec = harness.run_job(cell, inputs, "cpu", root / "out", keep=True)
    numbers = harness.check(cell, inputs, rec["grids"], "cpu")
    return rec, numbers


def test_discovery_of_added_files(tiny):
    """A configuration, a cell, a generator, a metric and a kernel bound
    added as files only are found by name and run."""
    cell = _ring2d_cell(tiny, "ring2d", [DOMAIN2D])
    (tiny / "metrics/cells_per_s.py").write_text(textwrap.dedent('''
        def read(run):
            return 300 / (sum(j["wall"] for j in run.jobs) / len(run.jobs))
    '''))
    (tiny / "roofline/extra_kernel.py").write_text(
        "MODULE = 'x'\nENTRIES = ()\nKERNEL = 'extra'\n")
    rec, numbers = _job_and_check(cell, tiny)
    ok, shown = harness.verdict(numbers, cell.traffic["limits"])
    assert ok, shown
    run = harness.Run(cell, [rec], 1.0, 0)
    got = harness.read_metrics(run, [{"name": "cells_per_s", "unit": "1/s"},
                                     {"name": "job_s", "unit": "s"}])
    assert set(got) == {"cells_per_s", "job_s"}
    assert "extra_kernel" in tracing.roofline_modules(tiny)


def test_a_geometry_kind_added_as_files(tiny, tmp_path, monkeypatch):
    """A geometry kind added as two files, the program's object in the
    harness's search directory and the reference's inside test in the
    reference's, runs a cell through the job and the check with no cell
    apart."""
    import ref.geometry
    kinds = tmp_path / "geometry"
    shutil.copytree(harness.HERE / "geometry", kinds)
    monkeypatch.setattr(harness, "GEOMETRY", kinds)
    (kinds / "disc.py").write_text(textwrap.dedent('''
        def make(spec, refine, min_refinement_level):
            from sparsespatialsampling_torch import SphereGeometry
            return SphereGeometry(spec["name"], spec["keep_inside"],
                                  spec["center"], spec["radius"],
                                  refine=refine,
                                  min_refinement_level=min_refinement_level)
    '''))
    shapes = tmp_path / "shapes"
    shutil.copytree(harness.HERE / "ref/shapes", shapes)
    (shapes / "disc.py").write_text(textwrap.dedent('''
        import numpy as np
        import torch

        def bounds(spec):
            c = np.asarray(spec["center"], float)
            return c - spec["radius"], c + spec["radius"]

        def inside(spec, p):
            c = torch.as_tensor(spec["center"], dtype=p.dtype,
                                device=p.device)
            return ((p - c) ** 2).sum(-1) <= spec["radius"] ** 2
    '''))
    monkeypatch.setattr(ref.geometry, "SHAPES", shapes)
    # dyadic centre and radius: both sides' squares of lattice nodes are
    # exact, so a node on the circle is inside on both
    disc = {"type": "disc", "name": "hole", "keep_inside": False,
            "center": [0.25, -0.125], "radius": 0.375, "refine": True,
            "min_refinement_level": 6}
    cell = _ring2d_cell(tiny, "disc2d", [DOMAIN2D, disc])
    assert set(cell.kinds) == {"cube", "disc"}
    rec, numbers = _job_and_check(cell, tiny)
    assert numbers["cells_unmatched_pct"] == 0.0
    ok, shown = harness.verdict(numbers, cell.traffic["limits"])
    assert ok, shown
    # the obstacle took away every cell wholly inside it and refined its
    # surface
    levels = rec["grids"][0]["levels"].ravel()
    assert levels.max() == 6
    centers = np.asarray(rec["grids"][0]["centers"])
    half_diagonal = 2.0 / 2.0 ** levels / np.sqrt(2)
    assert (np.hypot(centers[:, 0] - 0.25, centers[:, 1] + 0.125)
            > 0.375 - half_diagonal).all()


def test_unknown_names_are_refused(tiny):
    import ref.geometry
    with pytest.raises(FileNotFoundError):
        harness.Cell("nothing.here", tiny)
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric", tiny)
    hexagon = {**DOMAIN2D, "type": "hexagon"}
    with pytest.raises(FileNotFoundError, match="hexagon.py"):
        _ring2d_cell(tiny, "hex2d", [hexagon])
    with pytest.raises(FileNotFoundError, match="hexagon.py"):
        ref.geometry.width_and_center(hexagon)


@pytest.mark.parametrize("batch", [1, 4])
def test_export_batches_give_the_one_call_field(tiny, batch):
    """``export_batch`` snapshots per ``interpolate`` call (6 snapshots: six
    calls, or 4 and 2) give the field of one call, bitwise, and the export's
    metrics are read from the batched job."""
    from sparsespatialsampling_torch import trace
    one = harness.Cell("t2.sweep", tiny)
    traffic = {**one.traffic, "export_batch": batch}
    (tiny / "traffic/t2.batched.json").write_text(json.dumps(traffic))
    cell = harness.Cell("t2.batched", tiny)
    assert cell.export_batch == batch and one.export_batch is None
    inputs = one.inputs(2 ** 32 + 9, 0, "cpu")
    want = harness.run_job(one, inputs, "cpu", tiny / "one", keep=True)
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = harness.run_job(cell, inputs, "cpu", tiny / "batched",
                              keep=True, traced=True)
    products = [r for r in trace.records() if r["name"] == "export.product"]
    assert len(products) == len(cell.grids) * -(-one.n_snapshots // batch)
    for a, b in zip(want["grids"], got["grids"]):
        np.testing.assert_array_equal(a["levels"], b["levels"])
        assert b["field"].shape == (len(b["levels"]), one.n_snapshots)
        assert b["field"].dtype == a["field"].dtype
        np.testing.assert_array_equal(a["field"], b["field"])
    run = harness.Run(cell, [got], 1.0, 0)
    read = harness.read_metrics(run, [{"name": "export_s", "unit": "s"},
                                      {"name": "export_product_s",
                                       "unit": "s"}])
    trace.clear()
    assert set(read) == {"export_s", "export_product_s"}
    assert read["export_s"]["value"] > read["export_product_s"]["value"] > 0


@pytest.mark.parametrize("name", ["large3d", "oat15"])
def test_generators_are_deterministic(name):
    config = json.loads((harness.HERE / "configs" / f"{name}.json")
                        .read_text())
    config["n_points"] = 5000
    gen = harness.load_module("gen", config["generator"])
    seed = 2 ** 31 + 12345

    def draw(job):
        return gen.make(config, np.random.default_rng([seed, job + 1]))
    a, b, c = draw(3), draw(3), draw(4)
    for key in ("points", "metric"):
        np.testing.assert_array_equal(a[key], b[key])
        assert not np.array_equal(a[key], c[key])
    assert a["points"].shape == (5000, config["dims"])
    assert a["metric"].dtype == np.float64
    if name == "oat15":
        s1 = gen.snapshots(config, a, 40, "cpu")
        s2 = gen.snapshots(config, b, 40, "cpu")
        assert s1.shape == (5000, 1, 40) and s1.dtype == np.float32
        np.testing.assert_array_equal(s1, s2)
        assert not gen.inside_polygon(a["points"], a["polygon"]).any()


def test_cell_inputs_and_kept_job_follow_the_seed(tiny):
    cell = harness.Cell("t2.sweep", tiny)
    a, b = cell.inputs(9, 0, "cpu"), cell.inputs(9, 0, "cpu")
    np.testing.assert_array_equal(a["snapshots"], b["snapshots"])
    warm = cell.inputs(9, -1, "cpu")
    assert not np.array_equal(warm["points"], a["points"])
    # every seed runs the pool's clouds, one after another, in its order
    pool = cell.traffic["pool"]
    for seed in (9, 2 ** 33 + 5):
        clouds = [cell.cloud(seed, j) for j in range(2 * pool)]
        assert sorted(map(tuple, clouds[:pool])) == sorted(
            map(tuple, clouds[pool:]))
        assert len({tuple(c) for c in clouds}) == pool
        assert all(clouds[j] != clouds[j + 1] for j in range(2 * pool - 1))
    assert [cell.cloud(9, j) for j in range(pool)] != [
        cell.cloud(10, j) for j in range(pool)]
    assert cell.cloud(9, -1) not in [cell.cloud(9, j) for j in range(pool)]
    cell.traffic["sample_jobs"] = 4
    picks = {cell.keep_job(s) for s in range(40)}
    assert picks == {0, 1, 2, 3}
    assert cell.keep_job(2 ** 33 + 1) == cell.keep_job(2 ** 33 + 1)


def test_job_s_is_the_mean_wall_of_whole_jobs(tiny):
    cell = harness.Cell("t3.sweep", tiny)
    jobs = [{"wall": w, "init_s": 0.5, "export_s": 0.0, "checkpoint_s": 0.1,
             "adaptive_s": 1.0, "renumber_s": 0.2, "geometry_s": None}
            for w in (2.0, 3.0, 7.0)]
    run = harness.Run(cell, jobs, 12.5, 2_000_000_000)
    read = {m: harness.load_module("metrics", m).read(run)
            for m in ("job_s", "peak_mem_gb", "setup_s", "init_s",
                      "geometry_s", "export_s", "grid_select_roofline",
                      "device_idle_pct")}
    assert read["job_s"] == pytest.approx(4.0)
    assert read["peak_mem_gb"] == pytest.approx(2.0)
    assert read["setup_s"] == 12.5
    assert read["init_s"] == pytest.approx(0.5)
    # nothing to read: left out of the result line
    assert read["geometry_s"] is None and read["export_s"] is None
    assert read["grid_select_roofline"] is None
    assert read["device_idle_pct"] is None


def test_roofline_metrics_from_a_trace(tiny):
    cell = harness.Cell("t3.sweep", tiny)
    trace = {"window_s": 4.0, "busy_s": 1.0, "device_events": 10,
             "kernels": {"grid_select": {
                 "launches": 4, "bound_s": 0.002, "matched": 4,
                 "matched_s": 0.004, "device_s": 0.012,
                 "device_launches": 30}}}
    run = harness.Run(cell, [{"wall": 2.0}, {"wall": 2.0}], 1.0, 0, trace)

    def read(m):
        return harness.load_module("metrics", m).read(run)
    assert read("grid_select_roofline") == pytest.approx(50.0)
    assert read("grid_select.device_ms") == pytest.approx(6.0)
    assert read("device_idle_pct") == pytest.approx(75.0)
    # the trace tied fewer kernels to the tracked launches than were
    # tracked: nothing to read
    trace["kernels"]["grid_select"]["matched"] = 3
    assert read("grid_select_roofline") is None


PEAKS = {"hbm_bytes_per_s": 1e12, "f32_ops_per_s": 1e13,
         "f64_ops_per_s": 1e12}


def test_bound_of_a_dilated_launch():
    from roofline import grid_select as gs
    q, d, w, k = 6, 3, 8, 2
    a = {"queries": torch.zeros(q, d), "k": k, "sorted_rows": True,
         "flat": torch.tensor([4, 4, 1, 9, 1, 4]),
         "dil_cand": torch.zeros(10, w, dtype=torch.int32)}
    facts, counts = gs.bound_terms("grid_select_dilated", a)
    assert counts.tolist() == [6, 3]
    # bytes: 3 rows of 8 candidates x 3 coords x 4 B, the queries, the
    # ids 6 x (8 + 2 x 4), the outputs 6 x 2 x 16
    nbytes = 3 * 8 * 3 * 4 + 6 * 3 * 4 + 6 * (8 + 2 * 4) + 6 * 2 * 16
    ops = 6 * 8 * (3 + 2) / 1e13 + 6 * 8 * 2 * 2 / 1e12
    assert gs.bound_seconds(facts, counts.tolist(), PEAKS) == pytest.approx(
        max(nbytes / 1e12, ops))


def test_bound_of_a_masked_blocked_launch():
    from roofline import grid_select as gs
    q, d, r, c, k = 4, 2, 9, 4, 3
    flat = torch.arange(q * r).reshape(q, r) % 7
    mask = torch.tensor([True, False, True, False])
    a = {"queries": torch.zeros(q, d), "k": k, "flat": flat, "mask": mask,
         "cell_list": torch.zeros(7, c, dtype=torch.int32)}
    facts, counts = gs.bound_terms("grid_select_blocked", a)
    live_slabs = torch.unique(flat[mask]).numel()
    assert counts.tolist() == [2, live_slabs]
    kk = min(k + 8, r * c)
    nbytes = (live_slabs * c * d * 4 + 2 * d * 4 + 2 * (r * 8 + kk * 4) + q
              + q * k * 16)
    n = 2 * r * c
    ops = n * (d + 2) / 1e13 + n * 2 * (d - 1) / 1e12
    assert gs.bound_seconds(facts, counts.tolist(), PEAKS) == pytest.approx(
        max(nbytes / 1e12, ops))


def test_interval_arithmetic():
    merged = tracing._merge([(5, 9), (0, 2), (1, 3), (8, 12)])
    assert merged == [[0, 3], [5, 12]]
    assert tracing._overlap(merged, 2, 6) == 2
    assert tracing._overlap(merged, 20, 30) == 0
    assert math.isclose(tracing._overlap(merged, 0, 12), 10)
