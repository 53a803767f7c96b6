"""The harness: discovery by name, the generators, the metric arithmetic
and the bound arithmetic."""
import json
import math
import textwrap

import numpy as np
import pytest
import torch

import harness
import tracing


def test_discovery_of_added_files(tiny):
    """A configuration, a cell, a generator, a metric and a kernel bound
    added as files only are found by name and run."""
    (tiny / "gen/ring2d.py").write_text(textwrap.dedent('''
        import numpy as np

        def make(config, rng, device):
            xy = rng.uniform(config["box"][0], config["box"][1],
                             size=(config["n_points"], 2))
            r = np.hypot(xy[:, 0], xy[:, 1])
            return {"points": xy, "metric": np.exp(-(r - 0.5) ** 2 / 0.01)}
    '''))
    (tiny / "configs/ring2d.json").write_text(json.dumps({
        "name": "ring2d", "generator": "ring2d", "dims": 2,
        "n_points": 2000, "box": [[-1, -1], [1, 1]],
        "geometries": [{"type": "cube", "name": "domain",
                        "keep_inside": True, "lower": [-1, -1],
                        "upper": [1, 1]}],
        "settings": {"uniform_levels": 3, "n_cells_max": 300}}))
    (tiny / "traffic/ring2d.cold.json").write_text(json.dumps({
        "config": "ring2d", "grids": [{}], "export": False, "pool": 3,
        "limits": {"cells_unmatched_pct": 0.0, "metric_trace_gap": 1e-5}}))
    (tiny / "metrics/cells_per_s.py").write_text(textwrap.dedent('''
        def read(run):
            return 300 / (sum(j["wall"] for j in run.jobs) / len(run.jobs))
    '''))
    (tiny / "roofline/extra_kernel.py").write_text(
        "MODULE = 'x'\nENTRIES = ()\nKERNEL = 'extra'\n")
    cell = harness.Cell("ring2d.cold", tiny)
    inputs = cell.inputs(5, 0, "cpu")
    rec = harness.run_job(cell, inputs, "cpu", tiny / "out", keep=True)
    ok, shown = harness.verdict(harness.check(cell, inputs, rec["grids"],
                                              "cpu"), cell.traffic["limits"])
    assert ok, shown
    run = harness.Run(cell, [rec], 1.0, 0)
    got = harness.read_metrics(run, [{"name": "cells_per_s", "unit": "1/s"},
                                     {"name": "job_s", "unit": "s"}])
    assert set(got) == {"cells_per_s", "job_s"}
    assert "extra_kernel" in tracing.roofline_modules(tiny)


def test_unknown_names_are_refused(tiny):
    with pytest.raises(FileNotFoundError):
        harness.Cell("nothing.here", tiny)
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric", tiny)


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
