"""The port's spans (``sparsespatialsampling_torch.trace``), on the CPU.

- A grid run and its export under ``torch.profiler`` record the span tree:
  every span's name under the parent it belongs to, one run id for the
  spans of one ``SparseSpatialSampling`` object (its ``ExportData`` and
  prefetch thread included), the prefetch on its own thread under the
  generation span, every main-thread span also a range of the profile
  within 1 ms, and the timer keys equal to their spans' durations.
- The same run with no profiler records nothing, opens no
  ``record_function`` range and synchronises nothing.
- A span synchronises its CUDA device only where the profiler traces its
  thread, and never during a graph capture.
- The benchmark's span metrics read a traced job of its harness.
"""
import json
import shutil
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparsespatialsampling_torch as tpkg  # noqa: E402
from sparsespatialsampling_torch import trace  # noqa: E402
from sparsespatialsampling_torch.engine import tree as ttree  # noqa: E402
from sparsespatialsampling_torch.ops import knn as tknn  # noqa: E402

# the parents each span may have (None: a root)
PARENTS = {
    "s3.init": {None}, "s3.generation": {None},
    "export.interpolate": {None}, "export.write": {None},
    "knn.key": {"s3.init"}, "knn.build": {"s3.init", "export.weights"},
    "workers.join": {"s3.init", "export.weights", "engine.window",
                     "engine.geometry_window"},
    "engine.setup": {"s3.init"},
    "knn.order": {"knn.build"}, "knn.upload": {"knn.build"},
    "knn.plan": {"knn.build"}, "knn.layout": {"knn.build"},
    "engine.uniform": {"s3.generation"}, "engine.adaptive": {"s3.generation"},
    "engine.geometry": {"s3.generation"}, "engine.renumber": {"s3.generation"},
    "s3.finalize": {"s3.generation"}, "s3.checkpoint": {"s3.generation"},
    "s3.prefetch": {"s3.generation"},
    "engine.epochs": {"engine.uniform", "engine.iteration"},
    "engine.retry": {"engine.epochs", "engine.window"},
    "engine.window": {"engine.adaptive"},
    "engine.iteration": {"engine.adaptive"},
    "engine.select": {"engine.iteration"},
    "engine.expand": {"engine.iteration"},
    "engine.split": {"engine.iteration"},
    "graphs.capture": {"engine.window", "engine.geometry_window"},
    "engine.geometry_window": {"engine.geometry"},
    "engine.geometry_level": {"engine.geometry"},
    "renumber.pre": {"engine.renumber"}, "renumber.keys": {"engine.renumber"},
    "renumber.unique": {"engine.renumber"},
    "renumber.emit": {"engine.renumber"},
    "export.upload": {"export.interpolate"},
    "export.weights": {"export.interpolate"},
    "export.metric": {"export.interpolate"},
    "export.product": {"export.interpolate"},
    "export.readback": {"export.product"},
}
# what the CPU cannot record: an escalation (none in these clouds) and a
# graph capture (the card's)
NOT_HERE = {"engine.retry", "graphs.capture", "export.write"}


def _cloud():
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 1, size=(6000, 2))
    metric = np.exp(-((xy - [0.35, 0.6]) ** 2).sum(1) / 0.02) + 0.01
    snaps = np.stack([metric * (1 + 0.1 * i) for i in range(3)],
                     -1)[:, None, :]
    return xy, metric, snaps


def _geometries():
    return [tpkg.CubeGeometry("domain", True, [0, 0], [1, 1]),
            tpkg.SphereGeometry("hole", False, [0.6, 0.4], 0.1,
                                refine=True, min_refinement_level=7)]


def _job(xy, metric, snaps, interp=None, **settings):
    """A grid, its export's interpolation (on the route ``interp``, the
    default's where None), and the prefetch joined."""
    s3 = tpkg.SparseSpatialSampling(
        xy, metric, _geometries(), save_path=tempfile.mkdtemp(),
        save_name="g", uniform_levels=3, n_cells_max=900, device="cpu",
        **settings)
    s3.execute_grid_generation()
    exp = tpkg.ExportData(s3, write_times=["0", "1", "2"], device="cpu")
    exp._interp_path = interp or exp._interp_path
    field = exp.interpolate(xy, snaps)
    thread = s3._knn_prefetch["thread"]
    if thread is not None:
        thread.join(timeout=60)
        assert not thread.is_alive()
    return s3, exp, field


@pytest.fixture(scope="module")
def profiled():
    """Two jobs on one cloud under the profiler: the device loop's, then
    (the cached index) the host loop's with the 2:1 balance and the
    export's device route."""
    xy, metric, snaps = _cloud()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tknn.KNNIndex, "GRID_MIN_POINTS", 1000)
        ttree._KNN_INDEX_CACHE.clear()
        trace.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            a = _job(xy, metric, snaps)
            mp.setattr(ttree.SamplingTree, "DEVICE_LOOP", False)
            b = _job(xy, metric, snaps, interp="device",
                     max_delta_level=True)
        ttree._KNN_INDEX_CACHE.clear()
    records = trace.records()
    trace.clear()
    events = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name() in PARENTS]
    return {"a": a, "b": b, "records": records, "events": events}


def test_the_span_tree(profiled):
    records = profiled["records"]
    by_id = {r["id"]: r for r in records}
    names = {r["name"] for r in records}
    assert names <= set(PARENTS)
    assert set(PARENTS) - NOT_HERE <= names
    main = threading.main_thread().ident
    for r in records:
        parent = by_id.get(r["parent"])
        assert r["parent"] is None or parent is not None, r
        assert (None if parent is None else parent["name"]) in PARENTS[
            r["name"]], r
        assert r["start_ns"] <= r["end_ns"]
        if parent is not None and parent["thread"] == r["thread"]:
            assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
                parent["end_ns"], r
        assert (r["thread"] == main) == (r["name"] != "s3.prefetch"), r
    # a run id an object: its spans, its export's and its prefetch's
    runs = {profiled[k][0]._trace_run for k in "ab"}
    assert len(runs) == 2
    for key in "ab":
        s3 = profiled[key][0]
        mine = [r for r in records if r["run"] == s3._trace_run]
        roots = sorted(r["name"] for r in mine if r["parent"] is None)
        assert roots == ["export.interpolate", "s3.generation", "s3.init"]
        prefetch, = [r for r in mine if r["name"] == "s3.prefetch"]
        gen, = [r for r in mine if r["name"] == "s3.generation"]
        assert prefetch["parent"] == gen["id"]
        assert prefetch["counts"]["cells"] == s3.centers.shape[0]
    assert {r["run"] for r in records} == runs
    # the second job took the cached index: a key and a join, no build
    b_run = profiled["b"][0]._trace_run
    b_init = [r["name"] for r in records
              if r["run"] == b_run and by_id.get(r["parent"], {}).get(
                  "name") == "s3.init"]
    assert b_init == ["knn.key", "workers.join", "engine.setup"]


def test_main_thread_spans_are_profile_ranges(profiled):
    """Each main-thread span is a range of the profile, its record's start
    and end within 1 ms of the range's.  A record's stamp and the
    profiler's are two reads of the clock microseconds apart; where the
    host takes the CPU from the thread between them (under the test
    suite's parallel workers it does, for whole scheduler ticks of 4 ms),
    one of the two lies further off: at most one of a span's two stamps,
    on at most 1 span in 20."""
    events = profiled["events"]
    main = threading.main_thread().ident
    spans = [r for r in profiled["records"] if r["thread"] == main]
    assert len(spans) > 100
    off = 0
    for r in spans:
        near = min((e for e in events if e[0] == r["name"]),
                   key=lambda e: abs(e[1] - r["start_ns"])
                   + abs(e[2] - r["end_ns"]))
        gaps = sorted([abs(near[1] - r["start_ns"]),
                       abs(near[2] - r["end_ns"])])
        assert gaps[0] < 1e6, r
        off += gaps[1] >= 1e6
    assert off <= len(spans) // 20, off
    # the worker thread records, but is not in the profile
    assert not [e for e in events if e[0] == "s3.prefetch"]


def test_a_reloaded_checkpoint_takes_a_new_run(profiled):
    """The run id is the process's: the checkpoint does not carry it, and
    a reloaded object (and its export's spans) takes a new one."""
    s3 = profiled["a"][0]
    file_path = Path(s3.save_path) / "s_cube_g.pt"
    assert "_trace_run" not in s3.__getstate__()
    loaded = tpkg.load_s_cube(str(file_path))
    assert loaded._trace_run != s3._trace_run
    assert loaded._trace_run not in {r["run"] for r in profiled["records"]}
    exp = tpkg.ExportData(loaded, write_times=["0"], device="cpu")
    assert exp._trace_run == loaded._trace_run


def test_a_span_without_the_profiler_flag_records_nothing(monkeypatch):
    """A torch without the private profiler flag runs every span
    unrecorded."""
    monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    trace.clear()
    with trace.span("flagless", "cuda") as sp:
        pass
    assert trace.records() == [] and sp.id is None and sp.seconds >= 0.0


def _seconds(record) -> float:
    return (record["end_ns"] - record["start_ns"]) / 1e9


@pytest.mark.parametrize("job", ["a", "b"])
def test_timer_keys_are_span_durations(profiled, job):
    s3, exp, _ = profiled[job]
    mine = [r for r in profiled["records"] if r["run"] == s3._trace_run]

    def one(name):
        rec, = [r for r in mine if r["name"] == name]
        return _seconds(rec)

    info = s3.data_final_mesh
    assert info["t_adaptive"] == one("engine.adaptive")
    assert info["t_renumbering"] == one("engine.renumber")
    assert info["t_geometry"] == one("engine.geometry")
    assert info["t_uniform"] == one("engine.uniform")
    # the second write is the object's checkpoint
    checkpoints = sorted((r for r in mine if r["name"] == "s3.checkpoint"),
                         key=lambda r: r["start_ns"])
    assert len(checkpoints) == 2
    assert info["t_checkpoint"] == _seconds(checkpoints[1])
    assert all(r["counts"]["bytes"] > 0 for r in checkpoints)
    assert exp.timings["t_weights"] == one("export.weights")
    assert exp.timings["t_metric"] == one("export.metric")
    assert s3._knn_prefetch["t_build"] == one("s3.prefetch")
    split = info["renumber_split"]
    assert split["t_keys"] == round(one("renumber.keys"), 4)
    assert split["t_pre"] == round(one("renumber.pre"), 4)
    asplit = info["adaptive_split"]
    assert asplit["t_window"] == pytest.approx(sum(
        _seconds(r) for r in mine if r["name"] == "engine.window"))
    assert asplit["t_select"] == pytest.approx(sum(
        _seconds(r) for r in mine if r["name"] == "engine.select"))
    gsplit = info["geometry_split"]
    assert gsplit["t_window"] == pytest.approx(sum(
        _seconds(r) for r in mine if r["name"] == "engine.geometry_window"))
    assert gsplit["t_host"] == pytest.approx(sum(
        _seconds(r) for r in mine if r["name"] == "engine.geometry_level"))
    if job == "a":
        assert info["t_knn_build"] == pytest.approx(
            one("knn.key") + one("knn.build"))
        assert asplit["t_window"] > 0.0 and asplit["t_select"] == 0.0
    else:
        assert info["t_knn_build"] == pytest.approx(
            one("knn.key") + _seconds(next(
                r for r in mine if r["name"] == "workers.join")))
        assert asplit["t_window"] == 0.0 and asplit["t_select"] > 0.0
        assert asplit["t_expand"] > 0.0
        product = one("export.product")
        assert exp.timings["t_kernel"] + exp.timings["t_readback"] == \
            pytest.approx(product)
        assert exp.timings["t_upload"] == one("export.upload")


def test_knn_build_children_cover_it(profiled):
    records = profiled["records"]
    build, = [r for r in records if r["name"] == "knn.build"]
    kids = [r for r in records if r["parent"] == build["id"]]
    # the centred f64 cloud goes up first, the values after the grid,
    # outside its build transients
    assert [r["name"] for r in kids] == ["knn.upload", "knn.order",
                                         "knn.plan", "knn.layout",
                                         "knn.upload"]
    assert build["counts"]["points"] == 6000
    points, values = [r for r in kids if r["name"] == "knn.upload"]
    assert points["counts"]["bytes"] == 6000 * 2 * 8
    assert values["counts"]["bytes"] == 6000 * 4
    order, plan = [r for r in kids if r["name"] in ("knn.order", "knn.plan")]
    # the permutation comes back; each cell-count pass reads one maximum
    assert order["counts"]["readback_bytes"] == 6000 * 8
    assert 1 <= plan["counts"]["passes"] <= 9


def test_the_same_run_unprofiled_records_nothing(monkeypatch):
    calls = {"range": 0, "sync": 0}
    real = torch.autograd.profiler.record_function

    def counted_range(*args, **kwargs):
        calls["range"] += 1
        return real(*args, **kwargs)

    def counted_sync(*args, **kwargs):
        calls["sync"] += 1

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counted_range)
    monkeypatch.setattr(trace, "_synchronize", counted_sync)
    monkeypatch.setattr(torch.cuda, "synchronize", counted_sync)
    monkeypatch.setattr(tknn.KNNIndex, "GRID_MIN_POINTS", 1000)
    ttree._KNN_INDEX_CACHE.clear()
    trace.clear()
    xy, metric, snaps = _cloud()
    s3, exp, _ = _job(xy, metric, snaps)
    ttree._KNN_INDEX_CACHE.clear()
    assert trace.records() == []
    assert calls == {"range": 0, "sync": 0}
    # the timer keys still read their spans
    info = s3.data_final_mesh
    assert info["t_adaptive"] > 0.0 and info["t_checkpoint"] > 0.0
    assert info["t_knn_build"] > 0.0 and info["t_init"] > 0.0
    assert exp.timings["t_weights"] > 0.0
    assert s3._knn_prefetch["t_build"] > 0.0


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture()
def syncs(monkeypatch):
    """Counts the spans' synchronises; the stream is never captured."""
    count = []
    monkeypatch.setattr(trace, "_synchronize", count.append)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    trace.clear()
    yield count
    trace.clear()


def test_a_profiled_span_synchronises_its_card(syncs):
    with trace.span("off", "cuda") as sp:
        pass
    assert syncs == [] and trace.records() == [] and sp.id is None
    with _profile():
        with trace.span("on", "cuda:0", rows=2) as sp:
            sp.count(rows=3)
        with trace.span("host"):
            pass
        with trace.span("cpu", "cpu"):
            pass
    assert syncs == [torch.device("cuda:0")]
    on, host, cpu = trace.records()
    assert on["counts"] == {"rows": 5}
    assert sp.seconds == (on["end_ns"] - on["start_ns"]) / 1e9


def test_no_synchronise_in_a_capture_or_on_a_worker(syncs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with _profile():
        with trace.span("captured", "cuda"):
            pass
    assert syncs == []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with _profile():
        with trace.span("main", "cuda", run=7) as main:
            worker = threading.Thread(target=lambda: trace.span(
                "worker", "cuda", run=7, parent=main.id).__enter__()
                .__exit__(None, None, None))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    assert len(syncs) == 1      # the main thread's span alone
    recs = {r["name"]: r for r in trace.records()}
    assert recs["worker"]["parent"] == recs["main"]["id"]
    assert recs["worker"]["run"] == recs["main"]["run"] == 7
    assert recs["worker"]["thread"] != recs["main"]["thread"]


def test_nested_spans_take_parent_and_run():
    trace.clear()
    with _profile():
        with trace.span("root", run="r"):
            with trace.span("child"):
                with trace.span("leaf"):
                    pass
            with pytest.raises(ValueError):
                with trace.span("raises"):
                    raise ValueError("inside")
        with trace.span("after"):
            pass
    recs = {r["name"]: r for r in trace.records()}
    assert list(recs) == ["leaf", "child", "raises", "root", "after"]
    root, child, leaf = recs["root"], recs["child"], recs["leaf"]
    raises, after = recs["raises"], recs["after"]
    assert leaf["parent"] == child["id"] and child["parent"] == root["id"]
    assert raises["parent"] == root["id"] and raises["run"] == "r"
    assert after["parent"] is None and after["run"] is None
    assert {r["run"] for r in (root, child, leaf)} == {"r"}
    trace.clear()
    assert trace.records() == []


# the benchmark's readers of the spans (``s3bench/metrics/<name>.py``)
SPAN_METRICS = ("knn_build_s", "worker_wait_s", "prefetch_s",
                "export_product_s", "outside_spans_s")


def test_the_benchmark_reads_the_spans(tmp_path, monkeypatch):
    """A traced job of a tiny airfoil sweep through the benchmark's
    harness: each span metric has a value, and the spans cover the job."""
    bench = Path(__file__).resolve().parents[1] / "s3bench"
    monkeypatch.syspath_prepend(str(bench))
    import harness
    root = tmp_path / "bench"
    for sub in ("gen", "metrics"):
        shutil.copytree(bench / sub, root / sub)
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    config = json.loads((bench / "configs/oat15.json").read_text())
    config.update(name="t2", n_points=3000, n_snapshots=6)
    (root / "configs/t2.json").write_text(json.dumps(config))
    (root / "traffic/t2.sweep.json").write_text(json.dumps(
        {"config": "t2",
         "grids": [{"uniform_levels": 3, "min_metric": 0.5},
                   {"uniform_levels": 3, "n_cells_max": 400}],
         "geometry_settings": {"airfoil": {"min_refinement_level": 6}},
         "export": True, "pool": 2}))
    cell = harness.Cell("t2.sweep", root)
    inputs = cell.inputs(5, 0, "cpu")
    entries = [m for m in json.loads(
        (bench.parent / "BENCHMARK.json").read_text())["per_layer"]
        if m["name"] in SPAN_METRICS]
    assert [m["name"] for m in entries] == list(SPAN_METRICS)
    ttree._KNN_INDEX_CACHE.clear()
    trace.clear()
    # no records: nothing to read, nothing raised
    run = harness.Run(cell, [{"wall": 1.0}], 1.0, 0)
    assert harness.read_metrics(run, entries) == {}
    with _profile():
        rec = harness.run_job(cell, inputs, "cpu", tmp_path / "out",
                              traced=True)
    ttree._KNN_INDEX_CACHE.clear()
    run = harness.Run(cell, [rec], 1.0, 0)
    got = {k: v["value"] for k, v in harness.read_metrics(
        run, entries).items()}
    records = trace.records()
    trace.clear()
    assert set(got) == set(SPAN_METRICS)
    builds = [r for r in records if r["name"] == "knn.build"]
    assert len(builds) == 1     # the second grid took the cached index
    assert got["knn_build_s"] == _seconds(builds[0])
    assert got["prefetch_s"] > 0.0 and got["export_product_s"] > 0.0
    assert got["worker_wait_s"] >= 0.0
    assert -1e-3 < got["outside_spans_s"] < 0.25 * rec["wall"]
