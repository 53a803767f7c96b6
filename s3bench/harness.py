"""The benchmark of ``sparsespatialsampling_torch``: set-up, the window of
jobs, the check against the reference, the metrics.

Everything that belongs to one configuration, traffic mix, generator,
geometry kind, metric or kernel bound is a file that this module finds by
name: ``configs/<config>.json``, ``traffic/<cell>.json`` (a cell is named
after its traffic file, which names its configuration),
``gen/<generator>.py``, ``geometry/<type>.py`` (the program's object of a
geometry spec, ``make(spec, refine, min_refinement_level)``) with
``ref/shapes/<type>.py`` (the reference's ``inside`` and ``bounds`` of
it), ``metrics/<metric>.py`` and ``roofline/<kernel>.py``.  Which metrics
a cell reports, and on how many cards it runs, ``BENCHMARK.json`` at the
root of the checkout says.

A traffic file holds ``config``, ``grids`` (each grid's settings over the
configuration's), ``geometry_settings`` (per geometry name), ``export``,
``export_batch`` (snapshots per ``interpolate`` call; without it one call
takes them all), ``pool``, ``sample_jobs``, ``trace_jobs`` and ``limits``.

A job is what one user's script does with one cloud: for each grid of the
cell's sweep, ``SparseSpatialSampling(...)`` and
``execute_grid_generation()``, then, where the cell exports, one
``ExportData(s3, ...)`` and its ``interpolate(...)`` of every snapshot,
``export_batch`` at a time; it ends when
the program's worker threads started during it have ended and the card has
synchronised.  Its inputs are made before it starts, from the cell's pool
of clouds in the order the seed draws (:meth:`Cell.cloud`).
"""
import importlib.util
import json
import os
import shutil
import sys
import threading
from contextlib import ExitStack, nullcontext
from pathlib import Path
from time import perf_counter

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names no run may import
FORBIDDEN = ("jax", "jaxlib", "flax", "sparsespatialsampling_tpu")
# where the program's geometry kinds are found, whatever the cell's root (as
# ``ref.geometry.SHAPES`` for the reference's); a test may point it elsewhere
GEOMETRY = HERE / "geometry"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = HERE):
    """``<root>/<kind>/<name>.py`` as a module."""
    return load_file(root / kind / f"{name}.py", kind)


def load_file(path: Path, kind: str):
    """The module of ``path``, a file of ``kind``; a missing file is
    refused by its name."""
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {path.stem!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"s3bench_{kind}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is one no run may import."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Cell:
    """One cell: its traffic file, its configuration and its generator."""

    def __init__(self, name: str, root: Path = HERE):
        self.name, self.root = name, root
        path = root / "traffic" / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no cell named {name!r} ({path})")
        self.traffic = load_json(path)
        self.config = load_json(root / "configs"
                                / f"{self.traffic['config']}.json")
        self.gen = load_module("gen", self.config["generator"], root)
        self.kinds = {g["type"]: load_file(GEOMETRY / f"{g['type']}.py",
                                           "geometry")
                      for g in self.config["geometries"]}
        base = self.config.get("settings", {})
        self.grids = [{**base, **g} for g in self.traffic["grids"]]
        self.export = bool(self.traffic.get("export", False))
        batch = self.traffic.get("export_batch")
        self.export_batch = None if batch is None else int(batch)
        if self.export_batch is not None and self.export_batch < 1:
            raise ValueError(f"export_batch of {name!r} must be at least 1, "
                             f"got {batch!r}")
        self.n_snapshots = int(self.config.get("n_snapshots", 0))
        self.k = 8 if self.config["dims"] == 2 else 26

    def cloud(self, seed: int, job: int) -> list:
        """The entropy of job ``job``'s cloud.  Every seed's window runs the
        same ``pool`` clouds (drawn once, from the cell's name), in an
        order the seed draws, so that seeds differ in order and not in
        work; the warm-up (job -1) draws a cloud of its own from the
        seed."""
        if job < 0:
            return [seed % (1 << 63), 0]
        pool = int(self.traffic["pool"])
        order = np.random.default_rng([seed % (1 << 63), 0, 2]).permutation(
            pool)
        name = int.from_bytes(self.name.encode(), "little")
        return [name, 1 + int(order[job % pool])]

    def inputs(self, seed: int, job: int, device) -> dict:
        """The inputs of job ``job`` (-1: the warm-up) of seed ``seed``."""
        rng = np.random.default_rng(self.cloud(seed, job))
        data = self.gen.make(self.config, rng, device)
        if self.export:
            data["snapshots"] = self.gen.snapshots(self.config, data,
                                                   self.n_snapshots, device)
        return data

    def geometry_specs(self, inputs: dict) -> list:
        """The configuration's geometries, with the traffic's settings and
        coordinates the generator made (a string names an input)."""
        over = self.traffic.get("geometry_settings", {})
        out = []
        for g in self.config["geometries"]:
            g = {**g, **over.get(g["name"], {})}
            if isinstance(g.get("coordinates"), str):
                g["coordinates"] = inputs[g["coordinates"]]
            out.append(g)
        return out

    def keep_job(self, seed: int) -> int:
        """The job of the window whose results are checked, drawn from the
        seed among the first ``sample_jobs``."""
        rng = np.random.default_rng([seed % (1 << 63), 0, 1])
        return int(rng.integers(int(self.traffic.get("sample_jobs", 1))))


def port_geometries(specs: list, kinds: dict) -> list:
    """The program's geometry objects of the specs, each made by its kind's
    module (``Cell.kinds``)."""
    return [kinds[g["type"]].make(g, bool(g.get("refine", False)),
                                  g.get("min_refinement_level"))
            for g in specs]


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_job(cell: Cell, inputs: dict, device, out_dir: Path,
            keep: bool = False, traced: bool = False) -> dict:
    """One job (see the module's docstring).  Returns its wall and the
    layers' seconds summed over its grids; with ``keep`` also each grid's
    results, for the check."""
    from sparsespatialsampling_torch import ExportData, SparseSpatialSampling
    import torch
    span = (torch.profiler.record_function if traced
            else lambda name: nullcontext())
    rec = {"init_s": 0.0, "export_s": 0.0, "checkpoint_s": 0.0,
           "adaptive_s": 0.0, "renumber_s": 0.0, "geometry_s": None,
           "grids": []}
    times = [f"{i}" for i in range(cell.n_snapshots)]
    before = set(threading.enumerate())
    t0 = perf_counter()
    with span("s3bench::job"):
        for g, settings in enumerate(cell.grids):
            t1 = perf_counter()
            with span("s3bench::init"):
                s3 = SparseSpatialSampling(
                    inputs["points"], inputs["metric"],
                    port_geometries(cell.geometry_specs(inputs),
                                    cell.kinds),
                    save_path=str(out_dir), save_name=f"grid{g}",
                    device=device, **settings)
                _sync(device)
            rec["init_s"] += perf_counter() - t1
            with span("s3bench::generation"):
                s3.execute_grid_generation()
            info = s3.data_final_mesh
            rec["checkpoint_s"] += float(info["t_checkpoint"])
            rec["adaptive_s"] += float(info["t_adaptive"])
            rec["renumber_s"] += float(info["t_renumbering"])
            if info["t_geometry"] is not None:
                rec["geometry_s"] = (rec["geometry_s"] or 0.0) + float(
                    info["t_geometry"])
            field = None
            if cell.export:
                snaps = inputs["snapshots"]
                step = cell.export_batch or snaps.shape[-1]
                t2 = perf_counter()
                with span("s3bench::export"):
                    exp = ExportData(s3, write_times=times, device=device)
                    # a batch's field is held only for the checked job;
                    # otherwise it goes as the next comes
                    parts = []
                    for lo in range(0, snaps.shape[-1], step):
                        part = exp.interpolate(inputs["points"],
                                               snaps[:, :, lo:lo + step])
                        if keep:
                            parts.append(part)
                    _sync(device)
                rec["export_s"] += perf_counter() - t2
                del exp, part
                if keep:
                    field = (parts[0] if len(parts) == 1
                             else np.concatenate(parts, axis=-1))
                del parts
            if keep:
                rec["grids"].append({
                    "levels": np.asarray(s3.levels), "centers": s3.centers,
                    "faces": np.asarray(s3.faces),
                    "vertices": np.asarray(s3.vertices),
                    "iterations": int(info["iterations"]),
                    "trace": [float(m) for m in info["metric_per_iter"]],
                    "field": None if field is None else field[:, 0, :]})
            del s3, field
        with span("s3bench::join"):
            for t in threading.enumerate():
                if t not in before and t.is_alive():
                    t.join()
            _sync(device)
    rec["wall"] = perf_counter() - t0
    return rec


def _reference_inputs(cell: Cell, inputs: dict, device) -> tuple:
    """``(specs, lattice origin, root width, the reference's kNN)`` of a
    job's inputs on ``device``."""
    import torch
    from ref.geometry import width_and_center
    from ref.knn import ExactKNN
    specs = cell.geometry_specs(inputs)
    width, center = width_and_center(next(g for g in specs
                                          if g["keep_inside"]))
    pts = torch.as_tensor(np.asarray(inputs["points"]), dtype=torch.float64,
                          device=device)
    metric = torch.as_tensor(inputs["metric"], dtype=torch.float64,
                             device=device)
    return specs, center - 0.5 * width, width, ExactKNN(pts, metric)


def check(cell: Cell, inputs: dict, grids: list, device,
          log=None) -> dict:
    """The numbers of :mod:`ref.compare` for the checked job's ``grids``
    (the program's results, or the control's), the worst over its grids,
    against the reference run here in float64 on ``device``."""
    import torch
    from ref import compare
    from ref.s3 import reference_grid
    specs, lo, width, knn = _reference_inputs(cell, inputs, device)
    snaps = None
    if cell.export:
        snaps = torch.as_tensor(inputs["snapshots"][:, 0, :], device=device)
    out = {}
    for settings, got in zip(cell.grids, grids):
        t0 = perf_counter()
        port = compare.port_grid_check(got["levels"], got["centers"],
                                       got["faces"], got["vertices"], lo,
                                       width)
        # the reference's grid, or the grid of a stop decision the program
        # may take otherwise, whichever the program's is nearer to
        nums, ref = min(
            (({"cells_unmatched_pct": compare.cells_unmatched_pct(port, r),
               "metric_trace_gap": (
                   compare.metric_trace_gap(got["trace"], r.trace)
                   if got["iterations"] == r.iterations else 1.0)}, r)
             for r in reference_grid(knn, specs, settings)),
            key=lambda nr: (nr[0]["cells_unmatched_pct"],
                            nr[0]["metric_trace_gap"]))
        if cell.export:
            nums["field_gap"] = compare.field_gap(knn, got["centers"], snaps,
                                                  got["field"], cell.k)
        for key, v in nums.items():
            out[key] = max(out.get(key, 0.0), v)
        if log is not None:
            log(f"reference: grid {settings} ref {len(ref.levels)} cells / "
                f"{ref.iterations} its, program {len(got['levels'])} / "
                f"{got['iterations']}; {nums}; {perf_counter() - t0:.2f} s")
    return out


def control_grids(cell: Cell, inputs: dict, device, dtype) -> list:
    """The reference in ``dtype`` put in the program's place: each grid's
    results as the program reports them (levels, centres, faces and
    vertices, iterations, trace, field)."""
    import torch
    from ref import compare
    from ref.s3 import DIRECTIONS, reference_grid
    specs, lo, width, knn = _reference_inputs(cell, inputs, device)
    out = []
    for settings in cell.grids:
        ref = reference_grid(knn, specs, settings, dtype=dtype)[0]
        levels, coords = ref.levels.astype(np.int64), ref.coords
        d = coords.shape[1]
        depth = int(levels.max())
        h = width / np.exp2(levels.astype(np.float64))[:, None]
        centers = lo + (coords + 0.5) * h
        offsets = ((np.asarray(DIRECTIONS[d]) + 1) // 2).astype(np.int64)
        corner = ((coords[:, None, :] + offsets[None])
                  << (depth - levels)[:, None, None])
        key = corner[..., 0]
        for a in range(1, d):
            key = key * ((1 << depth) + 1) + corner[..., a]
        uniq, faces = np.unique(key.ravel(), return_inverse=True)
        node = np.zeros((uniq.size, d), dtype=np.int64)
        rest = uniq.copy()
        for a in range(d - 1, -1, -1):
            node[:, a] = rest % ((1 << depth) + 1)
            rest //= (1 << depth) + 1
        vertices = lo + node * (width / (1 << depth))
        field = None
        if cell.export:
            snaps = torch.as_tensor(inputs["snapshots"][:, 0, :],
                                    device=device)
            c = torch.as_tensor(centers, dtype=torch.float64, device=device)
            field = torch.cat([f for _, _, f, _ in compare.reference_field(
                knn, c, snaps, cell.k, dtype)]).float().cpu().numpy()
        out.append({"levels": levels[:, None], "centers": centers,
                    "faces": faces.reshape(-1, 2 ** d),
                    "vertices": vertices, "iterations": ref.iterations,
                    "trace": ref.trace, "field": field})
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: every number the cell's
    ``limits`` name at or under its limit; a limit not yet set, or a
    number not read, fails."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        shown[name] = {"value": value, "limit": limit}
        if limit is None or value is None or not value <= limit:
            ok = False
    return ok, shown


class Run:
    """What the metric readers read: the cell, the window's jobs, the
    set-up seconds, the peak, and the trace's reduction (None untraced)."""

    def __init__(self, cell, jobs, setup_s, peak_bytes, trace=None):
        self.cell, self.jobs, self.setup_s = cell, jobs, setup_s
        self.peak_bytes, self.trace = peak_bytes, trace


def read_metrics(run: Run, entries: list) -> dict:
    """Each entry's reader (``metrics/<name>.py``); a reader that finds
    nothing to read returns None, and the metric is left out."""
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"], run.cell.root).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def cell_entries(bench: dict, cell: str, kind: str) -> list:
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def main(argv=None) -> int:
    t_start = perf_counter()
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    bench = load_json(REPO / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    # every cache of the program and its libraries inside the checkout,
    # at a fixed path
    cache = REPO / ".s3bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(entry["chips"])):
        log(f"needs {entry['chips']} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    cell = Cell(args.workload)
    device = "cuda"
    out_dir = REPO / ".s3bench_out" / cell.name
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    try:
        return _measure(args, bench, cell, device, out_dir, t_start, log)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _measure(args, bench, cell, device, out_dir, t_start, log) -> int:
    import torch
    import sparsespatialsampling_torch  # noqa: F401  (loaded in set-up)

    # set-up: one job of the cell's own traffic on inputs the window never
    # uses (job -1), which builds the kernels on a checkout's first run.
    # Every job writes its checkpoints into a directory of its own, removed
    # once the job has ended, as a user's next cloud goes to new files
    t0 = perf_counter()
    t_imports = t0 - t_start
    warm = cell.inputs(args.seed, -1, device)
    t_warm_inputs = perf_counter() - t0
    t1 = perf_counter()
    run_job(cell, warm, device, out_dir / "warm")
    t_warm_job = perf_counter() - t1
    shutil.rmtree(out_dir / "warm")
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setup_s = perf_counter() - t_start
    log(f"setup: {setup_s:.3f} s (imports and the card {t_imports:.3f} s, "
        f"warm-up inputs {t_warm_inputs:.3f} s, warm-up job "
        f"{t_warm_job:.3f} s)")

    keep = cell.keep_job(args.seed)
    trace_jobs = max(int(cell.traffic.get("trace_jobs", 1)), keep + 1)
    traced = args.trace == 1
    prof = taps = None
    jobs, kept, t_inputs, written = [], None, 0.0, 0
    with ExitStack() as stack:
        if traced:
            from tracing import KernelTap, WindowFlag, roofline_modules
            window = stack.enter_context(WindowFlag())
            taps = {name: stack.enter_context(KernelTap(name, mod, window))
                    for name, mod in roofline_modules(cell.root).items()}
            prof = stack.enter_context(torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]))
        start = perf_counter()
        j = 0
        while True:
            t2 = perf_counter()
            inputs = cell.inputs(args.seed, j, device)
            t_inputs += perf_counter() - t2
            job_dir = out_dir / f"job{j}"
            rec = run_job(cell, inputs, device, job_dir, keep=(j == keep),
                          traced=traced)
            written += sum(f.stat().st_size for f in job_dir.iterdir())
            shutil.rmtree(job_dir)
            grids = rec.pop("grids")
            if j == keep:
                kept = (inputs, grids)
            del inputs, grids
            jobs.append(rec)
            j += 1
            elapsed = perf_counter() - start
            if j > keep and (elapsed >= args.seconds
                             or (traced and j >= trace_jobs)):
                break
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated())
    log(f"window: {len(jobs)} jobs in {perf_counter() - start:.3f} s; "
        f"inputs made between jobs in {t_inputs:.3f} s")
    log(f"disk: the window's jobs wrote {written} bytes of checkpoints, "
        f"each job's removed once it had ended")
    for i, rec in enumerate(jobs):
        log(f"job {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()
                                     if v is not None))

    trace = None
    if traced:
        from tracing import analyse
        t3 = perf_counter()
        trace = analyse(prof, taps, load_json(cell.root / "peaks.json"))
        del prof
        log(f"trace: {trace['device_events']} device events reduced in "
            f"{perf_counter() - t3:.3f} s; kernels {trace['kernels']}")

    run = Run(cell, jobs, setup_s, peak, trace)
    kind = "per_layer" if traced else "end_to_end"
    metrics = read_metrics(run, cell_entries(bench, cell.name, kind))

    # the check, after the peak is read and the program's results freed
    torch.cuda.empty_cache()
    t4 = perf_counter()
    numbers = check(cell, kept[0], kept[1], device, log)
    log(f"check: job {keep}, {perf_counter() - t4:.3f} s")
    ok, shown = verdict(numbers, cell.traffic.get("limits", {}))

    bad = forbidden_modules()
    if bad:
        log(f"modules that no run may import are loaded: {bad}")
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": len(jobs),
              "failed": 0 if ok else 1, "metrics": metrics,
              "device": device_info}
    if traced:
        device_info["busy_s"] = trace["busy_s"]
        device_info["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = shown
    for name, v in shown.items():
        log(f"check {name}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
