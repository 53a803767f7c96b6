"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py       # every phase, one card

Builds the hand-written CUDA kernels of ``sparsespatialsampling_torch`` from
the sources in this checkout, holds each against its plain PyTorch version
on the card, drives the port's main path (grid generation + export, then
the analysis of bench workloads 1 and 2) through its public entry points,
and checks what comes out.  Each phase prints one
JSON line; a failing phase raises, and the script exits non-zero without
the final line.  The last three lines are the kernel summary, the card's
``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {"platform": "gpu", ...}}``.

Phases:

- ``env``: torch / CUDA versions and the card;
- ``build``: compiles every ``csrc/*.cu`` (one ``nvcc`` each, in parallel)
  and counts the f64 instructions of each kernel in its SASS
  (``cuobjdump -sass``);
- ``kernel``: ``topk_smallest`` against its plain version at the 3D epoch
  shape [36864, 864] k=26, a 2D shape [20480, 576] k=8, the merge width of
  the full scan [1024, 1054] k=34 (in-row ties, whole-row ties and a row
  with fewer than k finite entries), a score-like full-scan tile
  [1024, 16384] k=34 whose last columns are +inf, and the edges k=1 and
  k=W — ``vals`` and ``sel`` must be bitwise equal; device times of the
  kernel, the plain version and ``torch.topk`` (a yardstick the port never
  calls) from CUDA-graph replays over copies of the input that do not fit
  in L2 together (``cuda_ms``), beside the memory bound;
- ``grid_select_kernel``: both entries of ``grid_select`` (the grid kNN's
  fused scoring and canonical selection) against their plain versions,
  ``(sq, idx, sel)`` bitwise, filler rows included: at every grid call
  site's shape on the layouts ``KNNIndex`` builds from the ``grid3d`` and
  ``oat2d`` clouds (the epoch's dilated rows [65 536, 384] k=26 and
  [11 520, 192] k=8, the ring's radius-4 slabs [1 024, 729·32] k=26 whole
  and half masked and [1 024, 81·C] k=8, the blocked layout's [4 320,
  27·32], a shard's unsorted rows [71 040, 864] k=26), timed beside the
  plain version, the parent's unfused chain (``unfused_ms``: the plain
  distances, ``topk_smallest`` and the canonical sort) and the bound;
  the epoch's dilated rows in the main path's order (each of a grid's
  level-6 or level-7 cells in Morton order, its centre then its
  children's centres: [65 536, 384] k=26, [11 520, 192] k=8 on the
  ``oat2d`` layout, and a shard's unsorted [71 040, 864]), timed beside
  the random order; every dilated case prints ``run_stats`` of its rows;
  ring rows in the main path's order (each of 256 cells' 1 + 2^d centres
  consecutive, beside ``grid3d``'s hole; and 2D at k=8 beside the
  airfoil), timed beside the random order, then with a quarter of them
  masked (runs cut by left-out rows), a run of 80 rows in one home cell
  (longer than a block's chunk), and rows clamped to boundary home cells
  outside the bbox, whose radius-4 rows are mostly the all-pad sentinel;
  then on 3D and 2D lattice clouds (a tie at every k-th place; queries
  on lattice points, some outside the bbox), a pad-heavy layout whose
  rows run out of real candidates (ties among pad slots at equal ``(sq,
  idx)``), capacity 4 with k + 8 above the row width, and k = 1 and the
  queue's 256;
- ``full_scan``: 2 048 queries over a 120 000-point cylinder-wake cloud
  through the full scan (``ops/knn.py:_search``) on the card and on the
  CPU; ``(sq, idx)`` must be bitwise equal;
- ``grid3d``: the cylinder-wake cloud (500 000 points, seed 1) refined to
  150 000 cells with a sphere obstacle refined to level 7, then 10
  snapshots exported through ``ExportData.export`` and the HDF5 file read
  back (where h5py is installed; else through ``ExportData.interpolate``,
  the same interpolation without the write), and 2 000 cells checked
  against a float64 k-d-tree IDW reference; the grid must have 151 557
  cells after 43 iterations.  The phase prints the epoch counters (queries
  the in-epoch ring and full-scan rescue answered, cells escalated to the
  host, host ring passes, cells left to the full scan) and walls.  Then,
  outside the timed walls, ``torch.profiler`` windows over one grid epoch
  of the 4 096 alive cells nearest the obstacle's axis and over one
  full-scan call of 4 query blocks, each printing the five device
  operations with the most time;
- ``grid2d_metric``: a 250 000-point 2D channel cloud with a circular
  obstacle in captured-metric mode (``min_metric=0.75``): the k=8 kernel
  and the metric stopping rule; 50 263 cells after 67 iterations;
- ``rescue_modes``: ``grid2d_metric`` under each of
  ``SamplingTree.FULL_RESCUE``'s modes (the JAX package's
  ``S3_TPU_FULL_RESCUE``): ``"auto"`` must turn the in-epoch full-scan
  rescue on, ``"1"`` runs it in every window epoch from the first (its
  full scan through ``topk_smallest``), ``"0"`` never (no query rescued);
  each mode grows the pinned grid with its windows as graph replays, and
  ``"1"`` and ``"0"`` again with the loop bodies eager, bitwise; each
  mode's rescued queries, escalated cells and ``refine_total``;
- ``cuda_vs_cpu``: one 60 000-point 3D grid-path case on the card and on
  the CPU; the (level, centre) sets and iteration counts must be identical;
- ``export_routes``: both export routes (``ExportData.INTERP``, ``"host"``
  the default and ``"device"``) on those two grids, 10 snapshots at the
  cell centres and vertices: on the host route the card's weights,
  neighbours, float64 metric and fields must be the CPU's bit for bit,
  and the host weights contracted on the card (``interpolate_data``) must
  equal the host route's CSR product (the count of differing values is
  printed); the device route's differing values between the card and the
  CPU are counted; every run prints its walls and the export's timings
  (``t_weights``, ``t_metric``, ``t_kernel``, ...);
- ``blocked_layout``: the same case on the card again with
  ``KNNIndex.DIL_MAX_BYTES = 0``, so every epoch and ring runs on the
  blocked layout; its grid must equal the dilated run's;
- ``large_k``: ``KNNIndex.query(q, 300)`` on a 40 000-point cloud on the
  card against the CPU, bitwise, through the full scan's stable-sort
  selections (k + 8 is above the kernel's queue);
- ``matmul_precision``: TF32 is off for f32 matmuls (PyTorch's default,
  which the analysis layer relies on);
- ``oat2d``: bench workload 1 end to end: the synthetic OAT15 airfoil
  cloud (245 000 points, seed 0) around a 240-vertex polygon obstacle
  refined at its surface, 25 000 cells, six uniform levels and
  ``pre_select_cells=True`` (the polygon outside the epochs on host-built
  nodes behind its bounding box): 27 084 cells after 33 iterations; then
  the bench's 50 snapshots interpolated (inside the counted main path),
  ``compute_svd(rank=20)`` and ``compute_dmd(rank=10)`` on the card, twice
  each: ``s`` within 1e-5·s[0] of a float64 host SVD of the same weighted,
  mean-free matrix, each of the first five modes whose gap exceeds
  1e-3·s[0] at ``|cos| ≥ 1 - 1e-4`` with the reference's, the DMD
  eigenvalues to 1e-4 of the port's CPU run; walls of the interpolation,
  the SVD (split into the f64 Gram, the host ``eigh`` and the mode
  product) and the DMD.  Without h5py ``write_svd_s_cube_to_file`` is not
  run here (``tests/test_torch_analysis.py`` holds it on the CPU);
- ``cylinder3d``: bench workload 2 end to end: the ``grid3d`` cloud
  around a ``CylinderGeometry3D`` obstacle refined to level 7, 150 000
  cells: 151 370 cells after 43 iterations; then the analysis of
  ``oat2d`` on [151 370, 50];
- ``mdl2d``: the ``grid2d_metric`` cloud's clean wake with
  ``max_delta_level=True``, ``min_metric=0.5`` and the obstacle refined
  to level 12 (the tutorial-3 configuration at 10x its points): 28 406
  cells after 34 iterations, and no two leaves that share a face, an edge
  or a corner more than one level apart;
- ``mdl2d_25k``: bench workload 5, the tutorial-3 configuration at its own
  25 000 points (``bench.synthetic_cylinder2d(calibrated=False)``, the
  full scan answers every query): 4 961 cells after 25 iterations, the
  JAX package's figures (``BENCH_r04.json``), 2:1 balanced;
- ``svd_routes``: a seeded [600 000, 50] matrix on the card with four
  planted modes over 1e-3 noise through ``compute_svd(rank=None)``, which
  must take ``randomized_svd`` and the sketched rank; the top four values
  to rtol 1e-2 of the planted spectrum and of ``economy_svd``, subspace
  cosines ≥ 0.999; ``randomized_svd(rank=20)`` on the card against the
  CPU's (the same sketch), ``s`` to rtol 1e-4;
- ``c2d_reltol``: bench workload 3 at its 25 000 points (the tutorial-1
  field calibrated to stall, ``min_metric=0.75``, the circle refined to
  level 9; the full scan answers every query): 10 415 cells after 135
  iterations, stopped on the relTol rule below 0.75;
- ``geometry_cuda_vs_cpu``: ``mask_points`` and ``check_cells`` (both
  modes) of every closed-form geometry class, in 2D and 3D where it
  exists and in both polarities, on 1 000 000 seeded points (f32 lattice
  corner nodes of levels 5-12, points within a few ulps of the surface,
  points around it) on the card and on the CPU, bitwise; then a 60 000-point
  3D case with a cylinder obstacle and ``max_delta_level=True`` on the
  card and on the CPU, whose grids must be identical;
- ``winding_kernel``: ``winding_number`` against its plain version on the
  card at [1024, 51552] (the ``stl3d`` mesh, a near-band batch of the JAX
  package's ``_MASK_CHUNK``), [15, 51552] and [481, 51552] (``stl3d``'s
  median and largest near-band calls), [16384, 5664], [1024, 258480] (the
  largest lat-lon sphere on the exact route) and at three edge shapes
  ([1, 1003], [257, 1025], [999, 40001]: spans and point tiles left partly
  empty); points uniform, within 1e-4 of the sphere's radius, and on
  triangle vertices and edges; and at ``stl3d``'s window batch of
  16 384 rows with 15, 481 and 16 383 of them counted on the device (the
  STL test's call), whose first rows must be the uncounted
  kernel's bit for bit and the rest 0, and a count of 0.
  ``|Δw| ≤ 1e-4``, flags ``w > 0.5`` equal
  at every point farther than 1e-5 from the mesh, and a shuffled batch and
  a prefix batch give each point bitwise the same ``w``; device times of
  the kernel and the plain version beside the operation bound; then the
  wrapper's slices (a batch over its scratch bound, 64 points a launch)
  bitwise the whole batch;
- ``stl3d``: bench workload 4 (``bench.py:460-498``), not cut: 200 000
  points (seed 2) around the 51 552-triangle sphere STL refined to level 6,
  ``uniform_levels=4``, 40 000 cells, no export; it prints the sign grid's
  near-band voxels and the near-band points of each winding call (those
  of the geometry phase and of its loop's windows apart), both kernels
  must launch, the winding kernel inside the geometry loop's windows too,
  and it is held against its plain version at the largest call of the run
  and of the windows;
  cells and iterations are pinned;
- ``device_loop_vs_host``: the ``cuda_vs_cpu`` case, ``mdl2d_25k`` and
  ``stl3d`` on the card on three routes: the device loops' windows as
  replays of captured CUDA graphs (the default), their bodies run eagerly
  (``SamplingTree._LOOP_GRAPHS = False``) and, for the first two, the
  host loop (``DEVICE_LOOP = False``).  Graphs and eager body must give
  the same rows and the metric trace bitwise, launch each kernel as often
  and enqueue the same steps; the host loop the same cells, levels and
  iterations, metric traces to rtol 1e-5.  The eager body's first window
  and the replays of the graphs' first captured window run under
  ``torch.profiler`` (device time, device and host operations per step,
  busy share).  A body that reads a device value must fail its capture
  with an error naming the key and the operation, and run no step
  eagerly in its place;
- ``stl_cuda_vs_cpu``: ``mask_points`` and ``check_cells`` (both modes,
  both polarities) of the 5 664-triangle sphere STL on 1 000 000 seeded
  points, on the card and on the CPU, by the exact route and by fast
  winding (``_FW_MIN_TRIS`` lowered), flags equal; then a 30 000-point cut
  of the ``stl3d`` cloud around that sphere refined to level 6, whose
  grids on the card and on the CPU must be identical;
- ``geometry_loop_vs_host``: ``oat2d``, ``stl3d`` and ``mdl2d`` (with
  ``SamplingTree.GEO_MDL_LOOP``) with the geometry-refinement loop on and
  then off: pinned grids identical row for row, each route's geometry
  wall and counters, and the winding kernel against its plain version at
  the largest call inside ``stl3d``'s geometry loop;
- ``sharded``: the multi-device layer (``sparsespatialsampling_torch/
  parallel``) over virtual meshes of the card
  (``parallel.mesh.VIRTUAL_SHARDS``), in four cases: ``large_single`` and
  ``large_sharded``, bench workload 6 at its own size (2 000 000 points,
  seed 0, in [4, 1, 1], 200 000 cells, no export) on one device and over
  4 shards on the card, rows and iterations identical, the metric trace
  to rtol 1e-5, the sharded run on the ``shard_grid`` core in device-loop
  windows, both counts against the JAX package's recorded 205 308 cells
  and pinned to the port's own; ``oat2d_sharded``, ``oat2d`` over 3
  shards (245 000 points do not divide by 3) with its pins, rows
  identical to ``oat2d``'s, and the 50 snapshots through the sharded
  index and ``sharded_interpolate``: the neighbours bitwise ``oat2d``'s,
  the weights the JAX package's sharded weights, the metric and the
  fields the host route's formulas on them, bit for bit; ``svd_distributed``, ``svd_routes``' planted matrix through
  ``compute_svd`` over 4 shards (``distributed_rsvd``) to ``svd_routes``'
  limits, its wall beside the single-device route's (``large`` also runs
  ``large_single`` with the loop bodies eager and records both runs' peak
  device memory); ``mixed_mesh``, the
  ``cuda_vs_cpu`` case over the mesh ``[cuda:0, cpu]``, rows and
  iterations identical to ``cuda_vs_cpu``'s (an operation that mixes
  devices without an explicit move raises there).  The kernels select at
  four sharded call sites: ``topk_smallest`` at ``shard_tile`` and
  ``shard_tile_merge`` (a shard's full-scan tiles and their merge) and
  ``shard_merge`` (the shards' candidates on the root), ``grid_select`` at
  ``shard_grid_select`` (the owner's scoring and selection on its
  unsorted grid rows); each must launch in the phase;
- ``index_reuse``: the engine's size-1 kNN index cache across runs
  (``engine/tree.py:_KNN_INDEX_CACHE``): the ``oat2d`` cloud swept over
  ``min_metric`` 0.25, 0.5 and 0.75 as ``examples/s3_for_OAT15_airfoil.py``
  sweeps it (``uniform_levels=5``, the airfoil refined to level 8), each
  run's ``init`` and ``t_knn_build`` cold then warm and whether the index
  was reused, the warm 0.75 run bitwise a cold one; bench workload 6's
  single-device tree constructed cold, then warm and refined to its pinned
  205 308 cells; the key: the ``cuda_vs_cpu`` cloud on the card and on the
  CPU gives two indices, and ``KNNIndex.DIL_MAX_BYTES`` changed a rebuild.

Every other phase builds its kNN index cold: ``run_grid`` empties the
cache before and after each run, so no index outlives its run and the
walls and peaks measure what they measured before the cache.

Every export runs on the JAX package's default route, the host route:
the kNN on the card, the weights in numpy, the metric in float64 and the
snapshots through one CSR product on the host.  ``grid3d``, ``oat2d``,
``cylinder3d`` and ``oat2d_sharded`` print the export's timings, which
weight cache it used (``prefetch``: the one the prefetch thread of
``execute_grid_generation`` built, ``"consumed"``, is required on one
device; a mesh builds its own), the thread's build time and
``t_checkpoint``, the checkpoint write it overlaps.  The thread is joined
inside every run, so its kernel launches count in the run.

Every grid phase prints its adaptive route (``adaptive_route``: the
device-resident loop's windows, their iterations, the host iterations and
why, why each window ended, reads back per iteration, and the other
synchronising operations inside windows) and fails unless the loop ran at
least 90 % of the iterations where it is eligible; ``blocked_layout``'s
run must take the host loop.  It prints both loops' CUDA-graph counters
(``graph_captures``, ``graph_replays``, ``eager_iterations`` by cause,
``capture_s``) and fails unless, on one device, every window step was a
replay but one eager warm-up for each key captured, with no other
synchronising operation inside the windows (``stl3d`` included); a
mesh's windows run eagerly.  Every grid phase that refines a geometry
prints its geometry route (``geometry_route``: the geometry loop's
windows and their levels, the host levels and why, why each window
ended, reads back, both routes' walls and the other synchronising
operations inside windows) and fails unless the loop ran windows where
the JAX package runs it (no 2:1 balance unless ``GEO_MDL_LOOP``) with
every host level explained by a counted exit, and the host walk alone
elsewhere.

The launch counters are set to 0 just before each main-path run and read
just after it; every main-path run must have launched every kernel of its
path (``winding_number`` is on ``stl3d``'s only), from each of its required
call sites (``grid_select``'s: the grid query, the ring's, the blocked
layout's in the ``blocked_layout`` run, a shard's; ``topk_smallest``'s:
the full scan's per-tile selection and its merge), each kernel's sites'
launches must add up to its counter, and no selection may have gone to
the stable sort.  The largest
kernel input each call site got in a main-path run is held (a reference,
not a copy) and, after the run, compared and timed again, so the reported
times are at the shapes the main path gives the kernel.
"""
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# the export's HDF5 write needs h5py; without it the smoke run checks the
# field that ExportData.interpolate returns instead of the file
HAVE_H5PY = importlib.util.find_spec("h5py") is not None
# H100 SXM data sheet: HBM3 rate, the f32 rate outside the tensor cores and
# the L2 cache's size
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# SASS mnemonics of f64 work: the f64 pipe's operations, the f64 reciprocal
# seed of a division, and conversions to or from f64
SASS_F64 = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX", "MUFU.RCP64H",
            "F2F.F64.F32", "F2F.F32.F64")


def sass_counts() -> dict:
    """Per kernel function of each built ``csrc/*.cu`` library, its
    instructions in the SASS (``cuobjdump -sass``, NOPs left out) and the
    f64 ones among them by mnemonic.  Static counts: each instruction of
    the code once, however often it runs."""
    from sparsespatialsampling_torch import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = {}
    for src in sorted(_build.SOURCE_DIR.glob("*.cu")):
        sass = subprocess.run([tool, "-sass", str(_build._library_path(src))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        funcs = {}
        for chunk in sass.split("Function : ")[1:]:
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)", chunk)
            ops = [op for op in ops if op != "NOP"]
            f64 = {k: sum(op.startswith(k) for op in ops) for k in SASS_F64}
            funcs[chunk.split()[0]] = {
                "instructions": len(ops),
                "f64": {k: v for k, v in f64.items() if v}}
        out[src.stem] = funcs
    return out


def cuda_ms(fn, x: torch.Tensor, min_reps: int = 10,
            rounds: int = 5) -> float:
    """Device time of one call ``fn(x)`` in milliseconds: calls captured in
    a CUDA graph, the graph replayed ``rounds`` times between CUDA events,
    the median replay divided by the calls.  The replay leaves out the
    host's Python and launch overhead, which a single small call would
    otherwise measure.  Each call reads the next of enough copies of ``x``
    to fill the L2 cache four times over, so no call finds its input in L2
    from the call before (at least ``min_reps`` calls)."""
    n_copies = max(2, math.ceil(4 * L2_BYTES / max(x.nbytes, 1)))
    copies = [x] + [x.clone() for _ in range(n_copies - 1)]
    reps = max(min_reps, n_copies)
    fn(x)
    return replay_ms(lambda i: fn(copies[i % n_copies]), reps, rounds)


def replay_ms(call, reps: int, rounds: int = 5) -> float:
    """Device time of one ``call(i)`` in milliseconds: ``call(0)`` …
    ``call(reps - 1)`` captured in a CUDA graph, the graph replayed
    ``rounds`` times between CUDA events, the median replay divided by
    ``reps``."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            call(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


def topk_bound(q: int, w: int, k: int):
    """Least time for the selection: each input read once, each output
    written once, against one compare per element at the f32 rate.
    Returns ``(bound_ms, bound_by)``."""
    t_bytes = (q * w * 4 + q * k * 8) / HBM_BYTES_PER_S * 1e3
    t_ops = (q * w) / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_topk(x: torch.Tensor, k: int, timed: bool = True) -> dict:
    """Kernel against its plain version on the card on the same input:
    bitwise ``vals`` and ``sel`` required; CUDA-event times."""
    from sparsespatialsampling_torch.ops import topk
    vals, sel = topk.topk_smallest(x, k)
    pvals, psel = topk.topk_smallest_plain(x, k)
    torch.cuda.synchronize()
    same_v = torch.equal(vals, pvals)
    same_s = torch.equal(sel, psel)
    finite = torch.isfinite(pvals)
    err = float((vals[finite] - pvals[finite]).abs().max()) \
        if finite.any() else 0.0
    if not (same_v and same_s):
        raise AssertionError(
            f"topk_smallest kernel disagrees with its plain version at "
            f"{list(x.shape)} k={k}: vals equal {same_v}, sel equal "
            f"{same_s}, max |dv| {err}")
    q, w = x.shape
    res = {"shape": [q, w], "k": k, "bitwise_equal_plain": True,
           "max_abs_err": err}
    if timed:
        bound, by = topk_bound(q, w, k)
        res.update(
            ms=cuda_ms(lambda t: topk.topk_smallest(t, k), x),
            plain_ms=cuda_ms(lambda t: topk.topk_smallest_plain(t, k), x,
                             min_reps=3),
            library_ms=cuda_ms(lambda t: torch.topk(t, k, largest=False), x),
            bound_ms=bound, bound_by=by)
    return res


def tie_laden(q: int, w: int, k: int, seed: int) -> torch.Tensor:
    """Seeded distance-like rows with in-row ties, whole-row ties and one
    row with fewer than k finite entries."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(q, w)).astype(np.float32)
    x[:, ::7] = np.round(x[:, ::7], 2)          # many in-row ties
    x[1, :] = 0.5                               # whole-row tie
    x[2, :w // 2] = x[2, w // 2:]               # duplicated half-row
    x[3, k // 2:] = np.inf                      # fewer than k finite
    x[4, :] = np.float32(3e30)                  # all pad distances
    return torch.from_numpy(x).cuda()


def score_tile(q: int, w: int, n_pad: int, seed: int) -> torch.Tensor:
    """Seeded full-scan score tile ``|p|² − 2 q·p`` over ``w`` points of
    which the last ``n_pad`` are pads (score +inf), with ties and one row
    holding fewer than 34 finite entries."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, size=(w, 3)).astype(np.float32)
    qs = rng.uniform(-1.0, 1.0, size=(q, 3)).astype(np.float32)
    psq = (pts * pts).sum(axis=1)
    psq[w - n_pad:] = np.inf
    x = psq[None, :] - np.float32(2.0) * (qs @ pts.T)
    x[:, ::13] = np.round(x[:, ::13], 2)        # in-row ties
    x[5, 20:] = np.inf                          # fewer than k finite
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).cuda()


def phase_kernel() -> dict:
    out = {"phase": "kernel", "cases": []}
    for q, w, k, seed in ((36864, 864, 26, 0), (20480, 576, 8, 1),
                          (1024, 1054, 34, 2), (4096, 1054, 1, 3),
                          (2048, 200, 200, 4)):
        out["cases"].append(check_topk(tie_laden(q, w, k, seed), k))
    out["cases"].append(check_topk(score_tile(1024, 16384, 1500, 5), 34))
    return out


def lattice(d: int, n: int) -> np.ndarray:
    """The unit lattice of n points an axis: a query at a lattice point
    has its k-th neighbour inside a tie of equal distances."""
    xs = np.arange(n, dtype=np.float64)
    return np.stack(np.meshgrid(*([xs] * d), indexing="ij"),
                    -1).reshape(-1, d)


def pad_heavy_layout(d: int, c: int, n_cells: int, seed: int):
    """A seeded blocked layout of ``n_cells`` cells of capacity ``c`` plus
    the all-pad sentinel row: each cell holds 0 to c members (distinct
    ids below 100,000, coordinates in the unit cube), the other slots the
    pad index 100,000 at coordinates 1e15, as ``KNNIndex`` pads them."""
    rng = np.random.default_rng(seed)
    pts = np.full((n_cells + 1, c, d), 1e15, np.float32)
    ids = np.full((n_cells + 1, c), 100_000, np.int32)
    members = rng.permutation(100_000)[:n_cells * c].reshape(n_cells, c)
    for cell, m in enumerate(rng.integers(0, c + 1, n_cells)):
        pts[cell, :m] = rng.uniform(0.0, 1.0, (m, d))
        ids[cell, :m] = members[cell, :m]
    return (torch.from_numpy(pts).cuda(), torch.from_numpy(ids).cuda())


def main_order_queries(index, lo, width: float, axis_xy, radii, z_range,
                       n_parents: int, seed: int) -> torch.Tensor:
    """Queries of a ring pass in the main path's order, centred f32 on
    the index's device: ``n_parents`` seeded cells of level 6 or 7 whose
    centres lie ``radii`` from the hole's axis ``axis_xy`` (``z_range``
    along it in 3D), each split into its 2^d children, and each child's
    centre then its 2^d prospective children's centres
    (``SamplingTree._query_centers``), the rows of a child consecutive
    and the children of a parent consecutive."""
    d = len(axis_xy) + (z_range is not None)
    rng = np.random.default_rng(seed)
    dirs = lattice(d, 2) * 2.0 - 1.0                     # {-1, +1}^d
    rows = []
    for _ in range(n_parents):
        h = width / 2.0 ** rng.integers(6, 8)
        ang, rad = rng.uniform(0, 2 * np.pi), rng.uniform(*radii)
        p = [axis_xy[0] + rad * np.cos(ang), axis_xy[1] + rad * np.sin(ang)]
        if z_range is not None:
            p.append(rng.uniform(*z_range))
        parent = np.floor((np.asarray(p) - lo) / h)
        for bits in lattice(d, 2):
            centre = lo + (2.0 * parent + bits + 0.5) * (h / 2.0)
            rows.append(centre)
            rows.extend(centre + dirs * (0.25 * h / 2.0))
    return index._queries_f32(np.asarray(rows) - index._shift)


def epoch_order_queries(index, lo, hi, width: float, level: int,
                        n_queries: int) -> torch.Tensor:
    """Queries of an epoch in the main path's order, centred f32 on the
    index's device: the cells of ``level`` (width ``width / 2^level``)
    whose lower corners lie in the box ``[lo, hi)``, in Morton order (the
    order in which refinement appends siblings), each cell's centre then
    its 2^d prospective children's centres (``SamplingTree._query_centers``),
    the first ``n_queries`` of them.  Consecutive queries share a home
    cell, and with it a dilated row, as a window's do."""
    lo = np.asarray(lo, np.float64)
    d = lo.size
    h = width / 2.0 ** level
    n_axis = np.ceil((np.asarray(hi, np.float64) - lo) / h).astype(np.int64)
    coords = np.stack(np.meshgrid(*[np.arange(n) for n in n_axis],
                                  indexing="ij"), -1).reshape(-1, d)
    key = np.zeros(coords.shape[0], np.int64)
    for bit in range(level, -1, -1):
        for a in range(d):
            key = (key << 1) | ((coords[:, a] >> bit) & 1)
    coords = coords[np.argsort(key, kind="stable")]
    n_cells = -(-n_queries // (1 + 2 ** d))
    if coords.shape[0] < n_cells:
        raise ValueError(f"{coords.shape[0]} cells of level {level}, "
                         f"{n_cells} wanted")
    centre = lo + (coords[:n_cells] + 0.5) * h
    dirs = lattice(d, 2) * 2.0 - 1.0
    rows = np.concatenate([centre[:, None, :],
                           centre[:, None, :] + dirs * (0.25 * h)], axis=1)
    rows = rows.reshape(-1, d)[:n_queries]
    return index._queries_f32(rows - index._shift)


def in_cell_queries(g, cell, n: int, seed: int) -> torch.Tensor:
    """``n`` seeded queries inside the index grid's cell ``cell`` (lattice
    coordinates; outside the grid, they clamp to its nearest cell)."""
    rng = np.random.default_rng(seed)
    origin, inv_h = g["origin"].cpu().numpy(), g["inv_h"].cpu().numpy()
    t = np.asarray(cell) + rng.uniform(0.05, 0.95, (n, len(cell)))
    return torch.from_numpy((origin + t / inv_h).astype(np.float32)).to(
        g["origin"].device)


def phase_grid_select_kernel() -> dict:
    """``grid_select`` against its plain version, bitwise, at every call
    site's shape on layouts ``KNNIndex`` builds from the workloads' clouds
    (timed), then on lattice clouds (ties at the k-th place), a pad-heavy
    layout whose rows run out of real candidates, and the edges of k."""
    from sparsespatialsampling_torch.ops import grid_select as gs, knn
    t0 = time.perf_counter()
    out = {"phase": "grid_select_kernel", "cases": {}}
    rng = np.random.default_rng(11)

    def layout(pts):
        index = knn.KNNIndex(pts, device="cuda")
        return index, index._grid

    def centred(index, q):
        return index._queries_f32(np.asarray(q, np.float64) - index._shift)

    def dil_flat(g, qf):
        return knn._grid_query_margin(qf, g["origin"], g["inv_h"],
                                      g["dims"])[0]

    def nb_flat(g, qf, radius):
        return knn._grid_neighborhood(qf, g["cell_list"].shape[0],
                                      g["origin"], g["inv_h"], g["dims"],
                                      radius)[0]

    def unsorted_rows(g):
        """A shard's rows: each cell's 3^d slabs concatenated, unsorted."""
        nb = knn._grid_neighbor_table(g["dims"], g["cell_list"].shape[0] - 1)
        n = nb.shape[0]
        return (g["cell_pts"][nb].reshape(n, -1).contiguous(),
                g["cell_list"][nb].reshape(n, -1).contiguous())

    def case(name, entry, args, timed=False):
        out["cases"][name] = check_grid(entry, args, timed=timed)

    # the call sites' shapes, timed
    xyz, _, bounds = cylinder_wake_3d()
    i3, g3 = layout(xyz)
    out["layout_3d"] = {"C": g3["C"], "keep": g3["_dil_keep"],
                        "rows": int(g3["cell_list"].shape[0])}
    q = centred(i3, rng.uniform(bounds[0], bounds[1], (65536, 3)))
    case("grid_select", "grid_select_dilated",
         (q, g3["dil_pts"], g3["dil_cand"], dil_flat(g3, q), 26, True), True)
    # the epoch's rows in the main path's order (level-6 cells in Morton
    # order, each cell's centre then its 8 children's): runs of queries
    # share a home cell's row; timed beside the random order above
    lo3 = np.asarray(bounds[0], np.float64)
    width3 = float(np.max(np.subtract(bounds[1], bounds[0])))
    eq3 = epoch_order_queries(i3, lo3, bounds[1], width3, 6, 65536)
    case("grid_select_main_order", "grid_select_dilated",
         (eq3, g3["dil_pts"], g3["dil_cand"], dil_flat(g3, eq3), 26, True),
         True)
    # the ring's rows: queries beside the cloud's cylindrical hole, half of
    # them marked as a ring pass leaves them
    ang = rng.uniform(0, 2 * np.pi, 1024)
    rad = rng.uniform(0.05, 0.07, 1024)
    ring_q = centred(i3, np.stack([0.2 + rad * np.cos(ang),
                                   0.2 + rad * np.sin(ang),
                                   rng.uniform(0.0, 0.41, 1024)], 1))
    ring_flat = nb_flat(g3, ring_q, 4)
    args = (ring_q, g3["cell_pts"], g3["cell_list"], ring_flat, 26)
    case("ring_select", "grid_select_blocked", args, True)
    half = torch.from_numpy(rng.uniform(size=1024) < 0.5).cuda()
    case("ring_select_half_masked", "grid_select_blocked", args + (half,),
         True)
    # ring rows in the main path's order (each cell's 1 + 2^d centres
    # consecutive, sibling cells after each other): runs of rows share a
    # home cell, and with it the whole row of flat; timed beside the
    # random order above
    mq = main_order_queries(i3, lo3, width3, (0.2, 0.2), (0.05, 0.07),
                            (0.0, 0.41), 32, seed=12)
    margs = (mq, g3["cell_pts"], g3["cell_list"], nb_flat(g3, mq, 4), 26)
    case("ring_select_main_order", "grid_select_blocked", margs, True)
    # the same rows with a quarter of them masked: runs cut by left-out
    # rows
    cut = torch.from_numpy(rng.uniform(size=mq.shape[0]) >= 0.25).cuda()
    case("ring_select_main_order_runs_cut", "grid_select_blocked",
         margs + (cut,))
    # one run longer than a block's chunk: 80 rows in one home cell beside
    # the hole, then 40 in the next cell along the first axis
    home = np.floor((mq[0].cpu().numpy() - g3["origin"].cpu().numpy())
                    * g3["inv_h"].cpu().numpy())
    lq = torch.cat([in_cell_queries(g3, home, 80, 13),
                    in_cell_queries(g3, home + [1.0, 0.0, 0.0], 40, 14)])
    case("ring_select_long_run", "grid_select_blocked",
         (lq, g3["cell_pts"], g3["cell_list"], nb_flat(g3, lq, 4), 26))
    # runs at clamped boundary home cells (queries outside the bbox, past
    # two corners and an edge): their radius-4 rows are mostly the all-pad
    # sentinel row, and the first run's mask leaves every third row out
    dims = g3["dims"].cpu().numpy().astype(np.float64)
    cq = torch.cat([in_cell_queries(g3, dims + 1.0, 40, 15),
                    in_cell_queries(g3, [-3.0, -3.0, -3.0], 40, 16),
                    in_cell_queries(g3, [dims[0] // 2, -2.0, dims[2] + 2.0],
                                    40, 17)])
    cflat = nb_flat(g3, cq, 4)
    out["clamped_sentinel_share"] = float(
        (cflat == g3["cell_list"].shape[0] - 1).double().mean())
    case("ring_select_clamped", "grid_select_blocked",
         (cq, g3["cell_pts"], g3["cell_list"], cflat, 26,
          torch.arange(120, device=cq.device) % 3 > 0))
    q = centred(i3, rng.uniform(bounds[0], bounds[1], (4320, 3)))
    case("blocked_select", "grid_select_blocked",
         (q, g3["cell_pts"], g3["cell_list"], nb_flat(g3, q, 1), 26), True)
    rows_pts, rows_cand = unsorted_rows(g3)
    q = centred(i3, rng.uniform(bounds[0], bounds[1], (71040, 3)))
    case("shard_grid_select", "grid_select_dilated",
         (q, rows_pts, rows_cand, dil_flat(g3, q), 26, False), True)
    eq = epoch_order_queries(i3, lo3, bounds[1], width3, 6, 71040)
    case("shard_grid_select_main_order", "grid_select_dilated",
         (eq, rows_pts, rows_cand, dil_flat(g3, eq), 26, False), True)
    del rows_pts, rows_cand
    # the edges of k on the 3D rows: one, and the queue's 256
    q = centred(i3, rng.uniform(bounds[0], bounds[1], (1024, 3)))
    flat = dil_flat(g3, q)
    case("k1", "grid_select_dilated",
         (q, g3["dil_pts"], g3["dil_cand"], flat, 1, True))
    case("k256", "grid_select_dilated",
         (q, g3["dil_pts"], g3["dil_cand"], flat, 256, True))
    case("ring_kk256", "grid_select_blocked",
         (ring_q[:256], g3["cell_pts"], g3["cell_list"], ring_flat[:256],
          248))
    del i3, g3
    xy, _, _ = synthetic_oat15()
    i2, g2 = layout(xy)
    out["layout_2d"] = {"C": g2["C"], "keep": g2["_dil_keep"],
                        "rows": int(g2["cell_list"].shape[0])}
    q = centred(i2, rng.uniform([-0.5, -0.5], [1.5, 0.5], (11520, 2)))
    case("grid_select_2d", "grid_select_dilated",
         (q, g2["dil_pts"], g2["dil_cand"], dil_flat(g2, q), 8, True), True)
    eq = epoch_order_queries(i2, [-0.5, -0.5], [1.5, 0.5], 2.0, 7, 11520)
    case("grid_select_2d_main_order", "grid_select_dilated",
         (eq, g2["dil_pts"], g2["dil_cand"], dil_flat(g2, eq), 8, True), True)
    case("ring_select_2d", "grid_select_blocked",
         (q[:1024], g2["cell_pts"], g2["cell_list"],
          nb_flat(g2, q[:1024], 4), 8), True)
    # the 2D ring in the main path's order: cells beside the airfoil
    mq = main_order_queries(i2, np.array([-0.5, -0.5]), 2.0, (0.5, 0.0),
                            (0.0, 0.1), None, 48, seed=18)
    case("ring_select_2d_main_order", "grid_select_blocked",
         (mq, g2["cell_pts"], g2["cell_list"], nb_flat(g2, mq, 4), 8), True)
    del i2, g2

    # lattices: every k-th place a tie; queries on lattice points and on
    # cell corners, some outside the bbox
    for d, n, k in ((3, 48, 26), (2, 320, 8)):
        pts = lattice(d, n)
        index, g = layout(pts)
        on = pts[rng.choice(pts.shape[0], 2048, replace=False)]
        off = rng.uniform(-3.0, n + 2.0, (512, d)).round()
        q = centred(index, np.concatenate([on, off]))
        rows_pts, rows_cand = unsorted_rows(g)
        flat = dil_flat(g, q)
        case(f"lattice{d}d_dilated", "grid_select_dilated",
             (q, g["dil_pts"], g["dil_cand"], flat, k, True))
        case(f"lattice{d}d_unsorted_rows", "grid_select_dilated",
             (q, rows_pts, rows_cand, flat, k, False))
        case(f"lattice{d}d_blocked", "grid_select_blocked",
             (q, g["cell_pts"], g["cell_list"], nb_flat(g, q, 1), k))
        case(f"lattice{d}d_ring_masked", "grid_select_blocked",
             (q[:512], g["cell_pts"], g["cell_list"], nb_flat(g, q[:512], 4),
              k, torch.arange(512, device=q.device) % 3 > 0))
        del index, g, rows_pts, rows_cand

    # pad-heavy rows (70 % of the slabs the sentinel's, cells part empty,
    # queries up to 5 units outside the unit cube): pads are selected,
    # and ties at equal (sq, idx) among them go to the lower slot
    for d, c, k in ((3, 16, 26), (2, 4, 30), (2, 4, 36)):
        cell_pts, cell_list = pad_heavy_layout(d, c, 64, seed=d * c + k)
        r = 3 ** d
        flat = torch.from_numpy(np.where(
            rng.uniform(size=(2048, r)) < 0.7, 64,
            rng.integers(0, 64, (2048, r)))).cuda()
        q = torch.from_numpy(rng.uniform(-5.0, 6.0, (2048, d)).astype(
            np.float32)).cuda()
        case(f"pad_heavy_{d}d_c{c}_k{k}", "grid_select_blocked",
             (q, cell_pts, cell_list, flat, k))
        # the same slabs as dilated rows: sorted by index (pads last) and
        # unsorted
        rows = flat[:64]
        keep = r * c
        dil_pts, dil_cand = knn._dilate_sorted(cell_pts, cell_list, rows,
                                               keep)
        row_of = torch.from_numpy(rng.integers(0, 64, 2048)).cuda()
        if k <= keep:
            case(f"pad_heavy_{d}d_c{c}_k{k}_sorted", "grid_select_dilated",
                 (q, dil_pts, dil_cand, row_of, k, True))
        case(f"pad_heavy_{d}d_c{c}_k{k}_unsorted", "grid_select_dilated",
             (q, cell_pts[rows].reshape(64, -1).contiguous(),
              cell_list[rows].reshape(64, -1).contiguous(), row_of, k,
              False))
    out["phase_wall_s"] = time.perf_counter() - t0
    return out


# H100 SXM data sheet: the f64 rate outside the tensor cores
F64_OPS_PER_S = 34e12


def grid_bound(entry: str, a: dict) -> dict:
    """Least time of a ``grid_select`` call, from its arguments ``a`` (by
    name): the bytes it must move over the memory rate against its
    operations over their rates.  Bytes: the scored rows' queries, row
    ids and mask, the candidates' coordinates, the selected candidates'
    ids, the outputs; the coordinates counted once for each distinct row
    or slab the call reads (``bound_ms``) and once for each query that
    reads them (``bound_rows_ms``: the candidate gather of the unfused
    chain).  Operations: per candidate d subtractions, a product and a
    compare in f32, d - 1 products and sums in f64.  Rows a mask leaves
    out count as their filler's writes."""
    queries, k, flat = a["queries"], a["k"], a["flat"]
    q, d = queries.shape
    if entry == "grid_select_dilated":
        w = a["dil_cand"].shape[1]
        kk = k if a["sorted_rows"] else min(k + 8, w)
        active, used = q, flat
        distinct = torch.unique(flat).numel() * w * d * 4
        ids = q * (8 + kk * 4)
    else:
        c = a["cell_list"].shape[1]
        w = flat.shape[1] * c
        kk = min(k + 8, w)
        mask = a["mask"]
        used = flat if mask is None else flat[mask]
        active = used.shape[0]
        distinct = torch.unique(used).numel() * c * d * 4
        ids = active * (flat.shape[1] * 8 + kk * 4) + (0 if mask is None
                                                       else q)
    fixed = active * d * 4 + ids + q * k * 16
    n = active * w
    t_ops = (n * (d + 2) / F32_OPS_PER_S
             + n * 2 * (d - 1) / F64_OPS_PER_S) * 1e3

    def bound(coords):
        t_bytes = (coords + fixed) / HBM_BYTES_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")
    (b, by), (b_rows, by_rows) = bound(distinct), bound(n * d * 4)
    return {"bound_ms": b, "bound_by": by, "bound_rows_ms": b_rows,
            "bound_rows_by": by_rows, "bound_bytes": distinct + fixed,
            "bound_rows_bytes": n * d * 4 + fixed, "scored_rows": active}


def run_stats(flat: torch.Tensor, mask=None) -> dict:
    """How the rows of a call share what they read.  A blocked row's
    neighbourhood ``flat[q]`` is a function of its home cell, the centre
    slab ``flat[q, (R - 1) / 2]``; a dilated row ``flat [Q]`` is its home
    cell's row itself.  Returns the rows, the unmasked rows, the distinct
    home cells among them and the rows per distinct home cell, the mean
    length of runs of equal home cell in the unmasked rows' order (a
    masked row is skipped, it does not end a run), and for chunks of 4, 8
    and 16 consecutive rows the unmasked rows per distinct home cell in a
    chunk (the rows of one block of the kernel that read the same
    slabs)."""
    rows = flat.shape[0]
    centre = flat if flat.dim() == 1 else flat[:, (flat.shape[1] - 1) // 2]
    keep = (torch.ones(rows, dtype=torch.bool, device=flat.device)
            if mask is None else mask)
    live = centre[keep]
    n = int(live.numel())
    n_runs = int((live[1:] != live[:-1]).sum()) + 1 if n else 0
    distinct = int(torch.unique(live).numel())
    out = {"rows": rows, "unmasked_rows": n, "distinct_home_cells": distinct,
           "rows_per_home_cell": n / distinct if distinct else 0.0,
           "mean_run": n / n_runs if n_runs else 0.0}
    for g in (4, 8, 16):
        pad = -(-rows // g) * g - rows
        ids = torch.cat([torch.where(keep, centre, -1),
                         centre.new_full((pad,), -1)]).view(-1, g)
        srt = torch.sort(ids, dim=1).values
        distinct = ((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)).sum()
        distinct = int(distinct + (srt[:, 0] >= 0).sum())
        out[f"rows_per_home_cell_in_chunks_of_{g}"] = (
            n / distinct if distinct else 0.0)
    return out


def unfused(entry: str, a: dict):
    """The call as the parent commit ran it (the ``unfused_ms`` route):
    the plain chain's gather and f64 distance arithmetic as eager
    operators, the selection through the ``topk_smallest`` kernel, the
    canonical sort and the filler as eager operators."""
    from sparsespatialsampling_torch.ops import grid_select as gs, topk
    queries, k, flat = a["queries"], a["k"], a["flat"]
    q, d = queries.shape
    if entry == "grid_select_dilated":
        sq = gs._sqsum(queries[:, None, :]
                       - a["dil_pts"][flat].reshape(q, -1, d))
        if a["sorted_rows"]:
            sq, sel = topk.topk_smallest(sq, k)
            return sq, a["dil_cand"][flat[:, None], sel.long()].long(), sel
        return gs.canonical_topk(sq, a["dil_cand"][flat], k,
                                 topk.topk_smallest)
    d2 = gs._sqsum(queries[:, None, None, :]
                   - a["cell_pts"][flat]).reshape(q, -1)
    out = gs.canonical_topk(d2, a["cell_list"][flat].reshape(q, -1), k,
                            topk.topk_smallest)
    return gs.fill_unmarked(a["mask"], *out)


def check_grid(entry: str, args: tuple, kwargs: dict = None,
               timed: bool = True) -> dict:
    """A ``grid_select`` entry (``grid_select_dilated`` or
    ``grid_select_blocked``) against its plain version on the card on the
    same input: ``sq``, ``idx`` and ``sel`` bitwise, filler rows included;
    CUDA-graph times of the kernel, the plain version and the unfused
    chain (:func:`unfused`), beside the bound (:func:`grid_bound`).  No
    single PyTorch call computes this function (these roundings, this tie
    order), so ``library_ms`` is None."""
    import inspect
    from sparsespatialsampling_torch.ops import grid_select as gs
    fn, plain = getattr(gs, entry), getattr(gs, entry + "_plain")
    bound_args = inspect.signature(fn).bind(*args, **(kwargs or {}))
    bound_args.apply_defaults()
    a = bound_args.arguments
    got, ref = fn(**a), plain(**a)
    torch.cuda.synchronize()
    same = [torch.equal(x, y) for x, y in zip(got, ref)]
    finite = torch.isfinite(ref[0])
    err = float((got[0][finite] - ref[0][finite]).abs().max()) \
        if finite.any() else 0.0
    q = a["queries"].shape[0]
    w = (a["dil_cand"].shape[1] if entry == "grid_select_dilated"
         else a["flat"].shape[1] * a["cell_list"].shape[1])
    if not all(same):
        bad = ~((got[0] == ref[0]) & (got[1] == ref[1])
                & (got[2] == ref[2])).all(dim=1)
        raise AssertionError(
            f"{entry} kernel disagrees with its plain version at [{q}, {w}] "
            f"k={a['k']}: sq, idx, sel equal {same}, {int(bad.sum())} rows "
            f"differ (first {torch.nonzero(bad).flatten()[:4].tolist()}), "
            f"max |dsq| {err}")
    res = {"entry": entry, "shape": [q, w], "k": a["k"],
           "bitwise_equal_plain": True, "max_abs_err": err}
    if entry == "grid_select_dilated":
        res["sorted_rows"] = a["sorted_rows"]
        res["run_stats"] = run_stats(a["flat"])
    else:
        if a["mask"] is not None:
            res["masked_out_rows"] = int((~a["mask"]).sum())
        res["run_stats"] = run_stats(a["flat"], a["mask"])
    if timed:
        pts = "dil_pts" if entry == "grid_select_dilated" else "cell_pts"

        def with_pts(call):
            return lambda t: call(**{**a, pts: t})
        res.update(
            ms=cuda_ms(with_pts(fn), a[pts]),
            plain_ms=cuda_ms(with_pts(plain), a[pts], min_reps=3),
            unfused_ms=cuda_ms(with_pts(lambda **b: unfused(entry, b)),
                               a[pts], min_reps=3),
            library_ms=None, **grid_bound(entry, a))
    return res


# The kNN function that calls a kernel → its call site's name
# (:func:`site_of`).  ``grid_select``'s dilated entry is called by
# ``_dilated_select``, for the single-device grid query (``_dilated_topk``)
# and a shard's (``_shard_grid_select``); its blocked entry by
# ``_blocked_topk``, whose radius tells the ring from the blocked layout.
# ``topk_smallest`` selects in ``_tile_select`` and ``_score_candidates``
# (the merge of the tiles' candidates), for the single-device full scan
# (``_search``) and a shard's (``_shard_candidates``), and in
# ``canonical_topk`` for the merge of a mesh's full route (``_shard_merge``).
RING, BLOCKED = "ring_select", "blocked_select"
SHARD_SITES = ("shard_tile", "shard_tile_merge", "shard_merge",
               "shard_grid_select")
GRID_SITES = ("grid_select", RING, BLOCKED, "shard_grid_select")
# the kernel each call site launches
KERNEL_OF = {**dict.fromkeys(GRID_SITES, "grid_select"),
             **dict.fromkeys(("full_scan_tile", "full_scan_merge",
                              "shard_tile", "shard_tile_merge",
                              "shard_merge"), "topk_smallest")}
# the sites every run of a phase must have launched from
MAIN_SITES = ("grid_select", RING, "full_scan_tile", "full_scan_merge")
# bench workload 6's (cells, iterations) on the port, on one device and
# sharded alike (its first card run; the cells are the JAX package's)
LARGE_PIN = (205_308, 16)
# ``oat2d``'s captured metric (the JAX package's BENCH_r05.json figure)
OAT2D_CAPTURED = 0.5643497087612296
# the JAX package's recorded cells of bench workload 6 (BENCH_r05.json,
# ``large_n_cells``)
LARGE_JAX_CELLS = 205_308
# (cells, iterations) of each grid phase's workload, the same whichever
# exact route answers each query
EXPECTED = {"grid3d": (151_557, 43), "grid2d_metric": (50_263, 67),
            "oat2d": (27_084, 33), "cylinder3d": (151_370, 43),
            "mdl2d": (28_406, 34), "stl3d": (40_202, 29),
            "c2d_reltol": (10_415, 135), "mdl2d_25k": (4_961, 25),
            "large_single": LARGE_PIN, "large_sharded": LARGE_PIN,
            "oat2d_sharded": (27_084, 33)}
# the fraction of a run's adaptive iterations the device loop must run
# where it is eligible (the rest only where a guard explains them)
LOOP_SHARE = 0.9


def site_of(frame) -> str:
    name, caller = frame.f_code.co_name, frame.f_back.f_code.co_name
    if name == "_dilated_select":
        return ("shard_grid_select" if caller == "_shard_grid_select"
                else "grid_select")
    if name == "_blocked_topk":
        return RING if frame.f_locals["radius"] > 1 else BLOCKED
    if name == "canonical_topk":
        # ``_topk_canonical`` of a mesh's merge; any other is an unfused
        # chain, which the main path never takes
        return ("shard_merge"
                if frame.f_back.f_back.f_code.co_name == "_shard_merge"
                else f"unfused_chain_of_{frame.f_back.f_back.f_code.co_name}")
    if name == "_score_candidates":
        return ("shard_tile_merge" if caller == "_shard_candidates"
                else "full_scan_merge")
    if name == "_tile_select":
        return ("shard_tile" if frame.f_back.f_back.f_code.co_name
                == "_shard_candidates" else "full_scan_tile")
    return name


class GraphTap:
    """Records made while a window's CUDA graph is captured belong to that
    graph (``engine/graphs.py``): a capture runs nothing, and each replay
    runs them again.  Inside a ``with`` block, :meth:`note` adds a record
    (a dict of counts) to ``self.totals`` outside a capture, or to the
    graph being captured, whose records each of its replays adds to
    ``self.totals``.  ``capturing`` says which."""

    def __init__(self):
        import weakref
        from sparsespatialsampling_torch.engine import graphs
        self._graphs = graphs
        self._per_graph = weakref.WeakKeyDictionary()
        self._bucket = None
        self.totals = {}

    @property
    def capturing(self) -> bool:
        return self._bucket is not None

    def note(self, counts: dict) -> None:
        into = self.totals if self._bucket is None else self._bucket
        for key, n in counts.items():
            into[key] = into.get(key, 0) + n

    def __enter__(self):
        cache, graph = self._graphs.WindowGraphs, self._graphs.WindowGraph
        self._orig = (cache._capture, graph.replay)
        capture, replay = self._orig
        tap = self

        def tapped_capture(obj, *args):
            tap._bucket = {}
            try:
                g = capture(obj, *args)
            finally:
                bucket, tap._bucket = tap._bucket, None
            tap._per_graph[g] = bucket
            return g

        def tapped_replay(g):
            out = replay(g)
            tap.note(tap._per_graph.get(g, {}))
            return out
        cache._capture, graph.replay = tapped_capture, tapped_replay
        return self

    def __exit__(self, *exc):
        self._graphs.WindowGraphs._capture, self._graphs.WindowGraph.replay = \
            self._orig


class KernelTap(GraphTap):
    """Holds the largest input each selection kernel got at each call site
    during a main-path run, and counts the launches per site (wraps the
    module functions the kNN calls: ``topk.topk_smallest`` and
    ``grid_select``'s two entries).  A site's count is what the wrapper's
    own launch counter gained during the site's calls; a call captured in
    a window's graph counts once for each replay (:class:`GraphTap`).  It
    holds inputs of eager calls only, references, not copies, so the
    run's walls carry no extra work: each is a fresh tensor, or the
    index's layout, that nothing writes to after the selection (a captured
    call's input is the graph's pool memory, which every replay
    rewrites).  ``inputs[site]`` is ``(entry, args, kwargs)``, ``entry``
    the wrapped function's name.  It also counts the calls of
    ``_select_sorted``, the stable sort that takes selections wider than
    the kernels' queue."""

    def __init__(self):
        super().__init__()
        from sparsespatialsampling_torch.ops import grid_select, knn, topk
        self._knn = knn
        self._modules = {"topk_smallest": topk,
                         "grid_select_dilated": grid_select,
                         "grid_select_blocked": grid_select}
        self._entries = {name: getattr(mod, name)
                      for name, mod in self._modules.items()}
        self._orig_sorted = knn._select_sorted
        self.inputs = {}
        self.launches = self.totals
        self.sorted_calls = 0

    def _tapped(self, name: str):
        mod, orig = self._modules[name], self._entries[name]

        def tapped(*args, **kwargs):
            site = site_of(sys._getframe(1))
            held = self.inputs.get(site)
            # a CPU shard's selection runs the plain version: nothing to
            # hold against it
            if args[0].is_cuda and not self.capturing and (
                    held is None
                    or work_of(name, args) > work_of(held[0], held[1])):
                self.inputs[site] = (name, args, kwargs)
            before = mod.launches
            out = orig(*args, **kwargs)
            self.note({site: mod.launches - before})
            return out
        return tapped

    def __enter__(self):
        super().__enter__()

        def sorted_tapped(x, kk):
            self.sorted_calls += 1
            return self._orig_sorted(x, kk)
        for name, mod in self._modules.items():
            setattr(mod, name, self._tapped(name))
        self._knn._select_sorted = sorted_tapped
        return self

    def __exit__(self, *exc):
        for name, mod in self._modules.items():
            setattr(mod, name, self._entries[name])
        self._knn._select_sorted = self._orig_sorted
        super().__exit__(*exc)


def work_of(entry: str, args: tuple) -> int:
    """The candidates a selection call scores: the elements of its score
    matrix, or its rows times their candidates."""
    if entry == "topk_smallest":
        return args[0].numel()
    if entry == "grid_select_dilated":
        return args[0].shape[0] * args[2].shape[1]
    return args[3].numel() * args[2].shape[1]


def reset_counts() -> None:
    from sparsespatialsampling_torch.ops import grid_select, topk, winding
    topk.launches = 0
    winding.launches = 0
    grid_select.launches = 0


def read_counts() -> dict:
    from sparsespatialsampling_torch.ops import grid_select, topk, winding
    return {"topk_smallest": topk.launches,
            "winding_number": winding.launches,
            "grid_select": grid_select.launches}


class WindowTap:
    """Runs each window of a device loop (``SamplingTree.<method>``:
    ``_run_window``, the adaptive loop's, or ``_run_geometry_window``,
    the geometry loop's) through :meth:`around` while in a ``with``
    block."""

    def __init__(self, method: str = "_run_window"):
        self._method = method

    def __enter__(self):
        from sparsespatialsampling_torch.engine.tree import SamplingTree
        self._cls = SamplingTree
        self._orig = SamplingTree.__dict__[self._method]
        run = self._orig.__func__
        setattr(self._cls, self._method,
                staticmethod(lambda *args: self.around(run, args)))
        return self

    def __exit__(self, *exc):
        setattr(self._cls, self._method, self._orig)

    def around(self, run, args):
        return run(*args)


class SyncTap(WindowTap):
    """Counts the synchronising CUDA operations inside the device loop's
    windows (``torch.cuda.set_sync_debug_mode("warn")``): copies from host
    memory, reads of device values, ``nonzero``.  The engine's own window
    reads wait on events and are not among them (the engine counts them,
    ``d2h_syncs``).  A probe read first shows whether the mode warns at
    all (``works``)."""

    def __init__(self, method: str = "_run_window"):
        super().__init__(method)
        self.syncs = 0
        self.works = len(self._warned(
            lambda: torch.ones(1, device="cuda").item())[1]) > 0

    @staticmethod
    def _warned(call) -> tuple:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [w for w in caught if "synchroniz" in str(w.message)]

    def around(self, run, args):
        out, syncs = self._warned(lambda: run(*args))
        self.syncs += len(syncs)
        return out


def profile_rows(prof, steps: int, wall_s: float) -> dict:
    """Per window step of a ``torch.profiler`` run: its device time, the
    device operations (kernels, copies, memsets) and host operators it
    issued; and the busy share, device time over the host-clock wall of
    the profiled steps (the profiler slows the host, so that wall is not
    the window's)."""
    rows = prof.key_averages()
    on_card = [e for e in rows if device_ms(e) > 0.0]
    device = sum(map(device_ms, rows))
    return {"steps": steps,
            "device_ms_per_step": device / max(steps, 1),
            "device_ops_per_step": sum(e.count for e in on_card)
            / max(steps, 1),
            "host_ops_per_step": sum(
                e.count for e in rows if e.key.startswith("aten::"))
            / max(steps, 1),
            "profiled_wall_ms_per_step": wall_s * 1e3 / max(steps, 1),
            "busy_share": device / max(wall_s * 1e3, 1e-9)}


class WindowProfile(WindowTap):
    """``torch.profiler`` over the first window of the device loop run
    inside it that has steps to profile: every step of an eager window,
    or the replays of a window's captured graph (``replays``: the steps
    after its key's warm-up and capture), each per step
    (:func:`profile_rows`)."""

    out = None

    def __init__(self, replays: bool = False):
        super().__init__()
        self._replays = replays

    def around(self, run, args):
        if self.out is not None:
            return run(*args)
        *head, step = args
        cache, key = step.func.__self__, step.args[0]
        state = {"prof": None, "steps": 0}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]

        def profiled(body, row):
            if state["prof"] is None and (not self._replays
                                          or cache.captured(key)):
                torch.cuda.synchronize()
                state["prof"] = torch.profiler.profile(activities=acts)
                state["prof"].__enter__()
                state["t0"] = time.perf_counter()
            if state["prof"] is not None:
                state["steps"] += 1
            return step(body, row)
        try:
            res = run(*head, profiled)
        finally:
            if state["prof"] is not None:
                torch.cuda.synchronize()
                wall = time.perf_counter() - state["t0"]
                state["prof"].__exit__(None, None, None)
        if state["prof"] is not None and state["steps"] > 1:
            self.out = {"iterations": res[0],
                        **profile_rows(state["prof"], state["steps"], wall)}
        return res


def graph_counters(stats: dict) -> dict:
    """A loop's CUDA-graph counters (``engine/graphs.py``): every step a
    window enqueued is an eager iteration (for a cause) or a replay."""
    return {"graph_captures": int(stats["captures"]),
            "graph_replays": int(stats["replays"]),
            "eager_iterations": int(stats["eager_iterations"]),
            "eager_causes": {k: int(v) for k, v in
                             stats["eager_causes"].items() if v},
            "capture_s": float(stats["capture_s"])}


def check_graphs(phase: str, route: dict, mesh: bool = False) -> None:
    """With the graphs on (``SamplingTree._LOOP_GRAPHS``) and one device,
    every window step is a replay but one eager warm-up for each key
    captured; on a mesh every step is eager, for the mesh.  No other
    operation inside the windows may synchronise."""
    from sparsespatialsampling_torch.engine.tree import SamplingTree
    g = route
    cause = ("mesh" if mesh else
             "warmup" if SamplingTree._LOOP_GRAPHS else "off")
    ok = g["eager_causes"].get(cause, 0) == g["eager_iterations"]
    if cause == "warmup":
        ok = ok and g["eager_iterations"] == g["graph_captures"]
    else:
        ok = ok and g["graph_replays"] == g["graph_captures"] == 0
    if not mesh and g.get("other_syncs_in_windows", 0) not in (
            0, "not measured"):
        ok = False
    if not ok:
        raise AssertionError(f"{phase}: the windows did not run as graph "
                             f"replays: {route}")


def adaptive_route(s3, sync=None) -> dict:
    """Which route ran the adaptive iterations, from the engine's
    counters: the device loop's windows, the iterations they ran, the host
    iterations and why, why each window ended, the state uploads and rows
    scattered on re-entry, the reads back to the host per window
    iteration (the engine's, and, with ``sync``, every other
    synchronising operation inside the windows), and the windows' CUDA
    graphs (:func:`graph_counters`)."""
    info = s3.data_final_mesh
    st = info["epoch_stats"]
    w_iters = int(st["window_iters"])
    out = {"route": "device_loop" if st["windows"] else "host_loop",
           "windows": int(st["windows"]), "window_iterations": w_iters,
           "host_iterations": int(info["iterations"]) - w_iters,
           "host_fallback": dict(st["host_fallback"]),
           "window_exits": dict(st["window_exits"]),
           "state_uploads": int(st["state_uploads"]),
           "rows_reuploaded": int(st["rows_reuploaded"]),
           "d2h_syncs": int(st["d2h_syncs"]),
           "d2h_syncs_per_window_iteration": st["d2h_syncs"] / max(w_iters, 1),
           "window_wall_s": float(info["adaptive_split"]["t_window"]),
           **graph_counters(st["graphs"])}
    if sync is not None:
        out["other_syncs_in_windows"] = (sync.syncs if sync.works
                                         else "not measured")
        if sync.works:
            out["other_syncs_per_window_iteration"] = (sync.syncs
                                                       / max(w_iters, 1))
    return out


def check_route(phase: str, route: dict, device_loop: bool,
                mesh: bool = False) -> None:
    """The device loop must have run the adaptive iterations where it is
    eligible: fewer windows than iterations and at least ``LOOP_SHARE`` of
    the iterations, unless host iterations at the level cap or past the
    loop's budget explain the rest; elsewhere the host loop alone.  On a
    mesh (``mesh``), which has no ring, a window also ends at the first
    epoch that meets a bad row (the JAX package's sharded loop): there
    every window but the last may end so, as many windows as
    iterations."""
    if not device_loop:
        if route["windows"]:
            raise AssertionError(f"{phase}: the device loop ran where the "
                                 f"host loop must: {route}")
        return
    w, iters = route["windows"], (route["window_iterations"]
                                  + route["host_iterations"])
    fb = route["host_fallback"]
    explained = fb["level_cap"] + fb["disabled"]
    many = w < iters or (mesh and route["window_exits"]["bad_rows"] >= w - 1)
    if not (0 < w <= iters and many) or (
            route["window_iterations"] < LOOP_SHARE * iters
            and route["host_iterations"] > explained):
        raise AssertionError(f"{phase}: the device loop did not carry the "
                             f"adaptive iterations: {route}")


def geometry_route(s3, sync=None) -> dict:
    """Which route ran the geometry-refinement levels, from the engine's
    counters: the geometry loop's windows and their levels, the host
    levels and why, why each window ended, the reads back, the walls of
    both routes (``geometry_split``), the windows' CUDA graphs and, with
    ``sync``, every other synchronising operation inside the windows."""
    info = s3.data_final_mesh
    st = info["epoch_stats"]["geometry_route"]
    out = {"route": ("device_loop" if st["windows"] else "host_walk"
                     if st["host_levels"] else "none"),
           "windows": int(st["windows"]),
           "window_levels": int(st["window_levels"]),
           "levels_per_window": st["window_levels"] / max(st["windows"], 1),
           "host_levels": int(st["host_levels"]),
           "host_fallback": dict(st["host_fallback"]),
           "window_exits": dict(st["window_exits"]),
           "d2h_syncs": int(st["d2h_syncs"]),
           "split_s": {k: float(v) for k, v in info["geometry_split"].items()},
           **graph_counters(st["graphs"])}
    if sync is not None:
        out["other_syncs_in_windows"] = (sync.syncs if sync.works
                                         else "not measured")
    return out


def check_geometry_route(phase: str, route: dict, loop: bool) -> None:
    """Where the JAX package runs its geometry loop (``loop``: the device
    loop on, no 2:1 balance unless ``GEO_MDL_LOOP``) the loop must have run
    the levels, or a counted exit explain each host level (a surface wider
    than the window, the level cap, the 2:1 guard); a phase without a
    window must owe every host level to a surface wider than the window,
    which the JAX package's sizes also leave to its host walk.  Elsewhere
    the host walk alone."""
    fb = route["host_fallback"]
    explained = route["host_levels"] == sum(fb.values())
    if loop:
        ok = explained and fb["route"] == 0 and (
            route["windows"] >= 1 or route["host_levels"] == fb["overflow"])
    else:
        ok = explained and route["windows"] == 0
    if not ok:
        raise AssertionError(f"{phase}: the geometry levels took the wrong "
                             f"route: {route}")


def geometry_loop_on(kw: dict) -> bool:
    """Whether the JAX package's default geometry route for grid arguments
    ``kw`` is its loop, with the port's switches as they stand."""
    from sparsespatialsampling_torch.engine.tree import SamplingTree
    return SamplingTree.DEVICE_LOOP and (not kw.get("max_delta_level")
                                         or SamplingTree.GEO_MDL_LOOP)


def cylinder_wake_3d(n_points: int = 500_000, seed: int = 1):
    """The cylinder-wake cloud of ``bench.py:291-301``."""
    bounds = [[0.0, 0.0, 0.0], [2.2, 0.41, 0.41]]
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(bounds[0], bounds[1], size=(int(n_points * 1.01), 3))
    r = np.linalg.norm(xyz[:, :2] - [0.2, 0.2], axis=1)
    xyz = xyz[r > 0.05][:n_points]
    x, y, z = xyz.T
    metric = ((x > 0.2) * np.exp(-np.maximum(x - 0.25, 0) / 0.8)
              * np.exp(-((y - 0.2) ** 2) / 0.02) + 0.01).astype(np.float64)
    return xyz, metric, bounds


def channel_wake_2d(n_points: int = 250_000, seed: int = 3):
    """2D channel cloud with a circular hole and a wake metric (the clean
    field of ``bench.py:341-368`` at 10x its point count)."""
    bounds = [[0.0, 0.0], [2.2, 0.41]]
    rng = np.random.default_rng(seed)
    xy = rng.uniform(bounds[0], bounds[1], size=(int(n_points * 1.02), 2))
    r = np.linalg.norm(xy - [0.2, 0.2], axis=1)
    xy = xy[r > 0.05][:n_points]
    x, y = xy.T
    wake = ((x > 0.2) * np.exp(-np.maximum(x - 0.25, 0.0) / 0.6)
            * (np.exp(-((y - 0.2) ** 2) / 0.01)
               + 0.4 * np.cos(12.0 * (x - 0.25))
               * np.exp(-((y - 0.2) ** 2) / 0.02)))
    return xy, (np.abs(wake) + 0.02).astype(np.float64), bounds


def calibrated_cylinder2d(n_points: int = 25_000, seed: int = 3):
    """Bench workload 3's field (``bench.py:341-388``, ``calibrated=True``)
    through the port's Morton code: the clean wake of
    :func:`channel_wake_2d` plus a ± component on Morton-adjacent point
    pairs, scaled so the captured metric levels off at about 0.565 and
    ``min_metric=0.75`` stops on the relTol rule."""
    from sparsespatialsampling_torch.ops import morton
    xy, metric, bounds = channel_wake_2d(n_points, seed)
    lo, ext = xy.min(0), xy.max(0) - xy.min(0)
    depth = morton.MAX_DEPTH[2]
    grid = np.clip(((xy - lo) / ext * ((1 << depth) - 1))
                   .astype(np.uint64), 0, (1 << depth) - 1)
    order = np.argsort(morton.encode(grid), kind="stable")
    nrng = np.random.default_rng(42)
    n = len(xy)
    a = np.repeat(np.abs(nrng.standard_normal(n // 2 + 1)), 2)[:n]
    sgn = np.tile([1.0, -1.0], n // 2 + 1)[:n]
    pm = np.empty(n)
    pm[order] = a * sgn
    b = 1.40 * np.sqrt((metric ** 2).sum() / (pm ** 2).sum())
    return xy, np.maximum(metric + b * pm, 0.004), bounds


def airfoil_polygon(n: int = 240) -> np.ndarray:
    """NACA-0012-like closed profile on the chord [0, 1] (the synthetic OAT15
    airfoil of ``bench.py:222-230``)."""
    xc = (1 - np.cos(np.linspace(0.0, np.pi, n // 2))) / 2
    t = 0.12
    yt = 5 * t * (0.2969 * np.sqrt(xc) - 0.1260 * xc - 0.3516 * xc ** 2
                  + 0.2843 * xc ** 3 - 0.1036 * xc ** 4)
    upper = np.stack([xc, yt], axis=1)
    lower = np.stack([xc[::-1], -yt[::-1]], axis=1)
    return np.concatenate([upper, lower[1:-1]])


def synthetic_oat15(n_points: int = 245_000, seed: int = 0):
    """The synthetic 2D transonic-buffet cloud of ``bench.py:233-272``: a
    shock ridge, a wake and a broadband texture around the airfoil, no
    points inside it.  Returns ``(points, metric, polygon)``."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform([-0.5, -0.5], [1.5, 0.5], size=(int(n_points * 1.02), 2))
    poly = airfoil_polygon()
    x, y = xy[:, 0:1], xy[:, 1:2]
    x1, y1 = poly[:-1, 0][None], poly[:-1, 1][None]
    x2, y2 = poly[1:, 0][None], poly[1:, 1][None]
    straddle = (y1 > y) != (y2 > y)
    xcross = (x2 - x1) * (y - y1) / np.where(y2 == y1, 1.0, y2 - y1) + x1
    inside = (np.sum(straddle & (x < xcross), axis=1) % 2) == 1
    xy = xy[~inside][:n_points]
    x, y = xy[:, 0], xy[:, 1]
    shock = (np.exp(-((x - 0.45) ** 2) / 0.002)
             * np.exp(-(y - 0.05) ** 2 / 0.01))
    wake = (x > 0.9) * np.exp(-(x - 0.9) / 0.4) * np.exp(-y ** 2 / 0.02)
    tex = np.zeros_like(x)
    trng = np.random.default_rng(7)
    for _ in range(12):
        kx, ky = trng.uniform(4, 40, 2)
        ph = trng.uniform(0, 2 * np.pi, 2)
        tex += np.sin(kx * x + ph[0]) * np.sin(ky * y + ph[1])
    metric = (shock + 0.6 * wake + 0.071 * np.abs(tex) / 12
              + 0.05).astype(np.float64)
    return xy, metric, poly


def unbalanced(centers, levels, lo, width) -> int:
    """Neighbour positions (across a face, an edge or a corner, at the
    leaf's own level) that a leaf two or more levels coarser covers; 0 on
    a grid that keeps the 2:1 balance."""
    levels = np.asarray(levels).ravel().astype(np.int64)
    d = centers.shape[1]
    h = width / 2.0 ** levels
    coords = np.rint((centers - lo) / h[:, None] - 0.5).astype(np.int64)

    def keys(c, level):
        k = c[:, 0]
        for a in range(1, d):
            k = k * (1 << level) + c[:, a]
        return k
    leaves = {int(lv): np.sort(keys(coords[levels == lv], int(lv)))
              for lv in np.unique(levels)}
    dirs = np.stack(np.meshgrid(*([np.array([-1, 0, 1])] * d),
                                indexing="ij"), -1).reshape(-1, d)
    dirs = dirs[(dirs != 0).any(axis=1)]
    bad = 0
    for lv in leaves:
        mine = coords[levels == lv]
        for step in dirs:
            nb = mine + step
            nb = nb[((nb >= 0) & (nb < (1 << lv))).all(axis=1)]
            for coarse in range(lv - 1):
                if coarse in leaves:
                    bad += int(np.isin(keys(nb >> (lv - coarse), coarse),
                                       leaves[coarse]).sum())
    return bad


def grid_summary(s3, phase_t: dict) -> dict:
    info = s3.data_final_mesh
    st = info["epoch_stats"]
    return {"n_cells": int(info["n_cells"]),
            "iterations": int(info["iterations"]),
            "captured_metric": float(info["metric_per_iter"][-1]),
            "epoch_core": st["core"],
            "ring_queries": int(st["ring_queries"]),
            "rescued_queries": int(st["rescued_queries"]),
            "bad_cells_escalated": int(st["n_bad_cells"]),
            "n_calls_ring": int(st["n_calls_ring"]),
            "bad_cells_to_full_scan": int(st["full_scan_cells"]),
            "epoch_queries": int(st["queries"]),
            "epoch_passes": {"grid_or_main": int(st["n_calls_main"]),
                             "host_ring": int(st["n_calls_ring"]),
                             "full_scan_retry": int(st["n_calls_full"])},
            "epoch_wall_s": float(st["wall_s"]),
            "retry_wall_s": float(st["t_retry_s"]),
            "adaptive_split_s": {key: float(v) for key, v in
                                 info["adaptive_split"].items()
                                 if key.startswith("t_")},
            "adaptive_route": phase_t.get("adaptive_route"),
            "geometry_route": phase_t.get("geometry_route"),
            "max_level": int(info["max_level"]),
            "wall_s": {"init": phase_t["init"],
                       "knn_build": float(info["t_knn_build"]),
                       "uniform": float(info["t_uniform"]),
                       "adaptive": float(info["t_adaptive"]),
                       "geometry": (None if info["t_geometry"] is None
                                    else float(info["t_geometry"])),
                       "renumber": float(info["t_renumbering"]),
                       "refine_total": phase_t["refine"],
                       **({"export": phase_t["export"]}
                          if "export" in phase_t else {})}}


def check_export(tmp: str, name: str, xyz, snaps, s3, field,
                 n_snap: int) -> dict:
    """Read the HDF5 file back (where h5py is installed; else take the
    ``[M, 1, S]`` field ``ExportData.interpolate`` returned) and hold 2 000
    cells against a float64 k-d-tree IDW reference."""
    from scipy.spatial import cKDTree
    n_cells = s3.centers.shape[0]
    if HAVE_H5PY:
        from sparsespatialsampling_torch import Dataloader
        loader = Dataloader(tmp, f"{name}.h5")
        field = loader.load_snapshot("k")
        if loader.faces.shape != (n_cells, 8) or loader.nodes.shape[1] != 3:
            raise AssertionError("exported grid has the wrong shape")
    else:
        field = field[:, 0, :]
    if field.shape != (n_cells, n_snap):
        raise AssertionError(f"exported field shape {field.shape}, "
                             f"expected {(n_cells, n_snap)}")
    if not np.isfinite(field).all():
        raise AssertionError("exported field holds non-finite values")
    pick = np.random.default_rng(0).choice(n_cells, 2000, replace=False)
    dist, idx = cKDTree(xyz).query(s3.centers[pick], k=26)
    w = 1.0 / np.clip(dist, 1e-12, None)
    w /= w.sum(axis=1, keepdims=True)
    ref = np.einsum("qk,qks->qs", w, snaps[idx].astype(np.float64))
    rel = np.abs(field[pick] - ref) / np.abs(ref).max()
    if rel.max() > 1e-4:
        raise AssertionError(f"exported field deviates from the float64 "
                             f"IDW reference by {rel.max():.3e} (relative)")
    return {"field_shape": list(field.shape),
            "hdf5": ("written and read back" if HAVE_H5PY else
                     "not written: h5py is not installed here"),
            "ref_idw_max_rel_err": float(rel.max())}


EXPORT_KEYS = ("t_weights", "t_upload", "t_metric", "t_kernel",
               "t_readback", "t_h5", "interp_bytes", "interp_outputs")


def export_summary(phase: str, exp, t: dict, prefetch: str = "consumed"
                   ) -> dict:
    """The export's timings and counters, which cache it used
    (``prefetch`` must read as given: a default export after
    ``execute_grid_generation`` consumes the prefetched one), the
    prefetch thread's build time and the checkpoint write it overlapped."""
    if exp.timings["prefetch"] != prefetch:
        raise AssertionError(f"{phase}: the export's weight cache was "
                             f"{exp.timings['prefetch']!r}, not {prefetch!r}")
    return {"export_route": exp.INTERP,
            "export_fallback_rows": int(exp.timings["n_fallback"]),
            "export_split_s": {key: exp.timings[key] for key in EXPORT_KEYS},
            "prefetch": exp.timings["prefetch"],
            "prefetch_build_s": t["prefetch_build"],
            "t_checkpoint": t["checkpoint"]}


def clear_index_cache() -> None:
    """Empty the engine's kNN index cache (``engine/tree.py``), so the
    next run builds its index cold and no index outlives its run."""
    from sparsespatialsampling_torch.engine import tree
    tree._KNN_INDEX_CACHE.clear()


def run_grid(tmp, name, pts, metric, geometries, export=None, device="cuda",
             warm: bool = False, **kw) -> tuple:
    """One grid generation (and export) through the public entry points.
    Returns ``(s3, export, field, walls, tree)``; ``tree`` is the engine,
    which ``execute_grid_generation`` detaches from ``s3``.  The engine's
    index cache is emptied before and after the run unless ``warm``, so
    a run builds its index cold and holds no index past its end, as every
    phase measured before the cache."""
    from sparsespatialsampling_torch import SparseSpatialSampling, ExportData
    if not warm:
        clear_index_cache()
    t = {}
    t0 = time.perf_counter()
    s3 = SparseSpatialSampling(pts, metric, geometries, save_path=tmp,
                               save_name=name, device=device, **kw)
    t["init"] = time.perf_counter() - t0
    tree = s3._sampling
    s3.execute_grid_generation()
    t["refine"] = time.perf_counter() - t0
    exp = field = None
    if export is not None:
        snaps, times = export
        t1 = time.perf_counter()
        exp = ExportData(s3, write_times=times, device=device)
        if HAVE_H5PY:
            exp.export(pts, snaps[:, None, :], "k",
                       n_snapshots_total=len(times))
        else:
            field = exp.interpolate(pts, snaps[:, None, :])
        if device == "cuda":
            torch.cuda.synchronize()
        t["export"] = time.perf_counter() - t1
    # the weight-cache prefetch of execute_grid_generation ends inside the
    # run (its kernel launches count here), whether or not it was consumed
    pf = s3._knn_prefetch
    if pf["thread"] is not None:
        pf["thread"].join()
    t["prefetch_build"] = pf["t_build"]
    t["checkpoint"] = s3.data_final_mesh["t_checkpoint"]
    if not warm:
        clear_index_cache()
    return s3, exp, field, t, tree


def main_path_run(phase: str, tmp: str, name: str, pts, metric, geometries,
                  export=None, sites=MAIN_SITES, kernels=None,
                  device_loop=True, mesh=False, **kw):
    """One main-path run with the counters set to 0 just before it and read
    just after; each of ``kernels`` (those of the run's path; by default
    the kernels of ``sites``) and each of ``sites`` must have launched,
    each kernel's launches must add up over its call sites, and no
    selection may have taken the stable sort.  The adaptive iterations must have taken the device loop
    where ``device_loop`` (and ``SamplingTree.DEVICE_LOOP``) says so, else
    the host loop (:func:`check_route`, with ``mesh`` for a sharded run);
    the route goes into the walls' ``adaptive_route``.  A geometry phase's levels must have taken the JAX
    package's route (:func:`check_geometry_route`), reported as
    ``geometry_route``."""
    from sparsespatialsampling_torch.engine.tree import SamplingTree
    with KernelTap() as tap, SyncTap() as sync, \
            SyncTap("_run_geometry_window") as geo_sync:
        reset_counts()
        s3, exp, field, t, tree = run_grid(tmp, name, pts, metric,
                                           geometries, export, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
    t["adaptive_route"] = adaptive_route(s3, sync)
    check_route(phase, t["adaptive_route"],
                device_loop and SamplingTree.DEVICE_LOOP, mesh)
    check_graphs(phase, t["adaptive_route"], mesh)
    if s3.data_final_mesh["t_geometry"] is not None:
        t["geometry_route"] = geometry_route(s3, geo_sync)
        check_geometry_route(phase, t["geometry_route"], geometry_loop_on(kw))
        check_graphs(phase, t["geometry_route"], mesh)
    if kernels is None:
        kernels = sorted({KERNEL_OF[s] for s in sites})
    missing = [n for n in kernels if counts[n] == 0]
    missing += [s for s in sites if not tap.launches.get(s)]
    if missing:
        raise AssertionError(f"{phase}: kernels or call sites never "
                             f"launched on the main path: {missing}")
    unknown = [s for s in tap.launches if s not in KERNEL_OF]
    if unknown:
        raise AssertionError(f"{phase}: selections at unknown call sites "
                             f"{unknown} (an unfused chain)")
    for kernel in ("topk_smallest", "grid_select"):
        per_site = {s: n for s, n in tap.launches.items()
                    if KERNEL_OF[s] == kernel}
        if sum(per_site.values()) != counts[kernel]:
            raise AssertionError(f"{phase}: launches per call site "
                                 f"{per_site} do not add up to {kernel}'s "
                                 f"count {counts[kernel]}")
    if tap.sorted_calls:
        raise AssertionError(f"{phase}: {tap.sorted_calls} selections took "
                             f"the stable sort on the main path")
    return s3, exp, field, t, counts, tap, tree


def check_expected(phase: str, out: dict) -> None:
    """The grid must have the workload's known cells and iterations: the
    ring, the rescue and the full scan emit the same exact answers, so
    which of them answers a query may move no cell."""
    got = (out["n_cells"], out["iterations"])
    if got != EXPECTED[phase]:
        raise AssertionError(f"{phase}: {got[0]} cells after {got[1]} "
                             f"iterations, expected {EXPECTED[phase]}")


def check_site(entry: str, args: tuple, kwargs: dict) -> dict:
    """A held call of ``entry`` (:class:`KernelTap`) again: the kernel
    against its plain version, bitwise, and timed."""
    if entry == "topk_smallest":
        return check_topk(*args, **kwargs)
    return check_grid(entry, args, kwargs)


def check_sites(tap) -> dict:
    """Each call site's largest main-path input, checked and timed."""
    return {site: {**check_site(*held), "launches": tap.launches[site]}
            for site, held in sorted(tap.inputs.items())}


def device_ms(event) -> float:
    """Self device time of a profiler row of device work (kernels, copies),
    in ms; 0 for a host operator, whose row repeats its kernels' time (the
    attribute's name differs between torch versions)."""
    if getattr(event, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(event, attr, None)
        if v is not None:
            return v / 1e3
    return 0.0


def timed_call(call) -> float:
    """Host-clock seconds of one ``call()`` up to the card's last kernel."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_window(call) -> dict:
    """One ``call()`` timed after a warm-up call (``wall_s``), then
    ``torch.profiler`` over one more: the device time it holds and the
    five device operations with the most time."""
    call()
    out = {"wall_s": timed_call(call)}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=device_ms, reverse=True)
    total = sum(device_ms(e) for e in rows)
    out["device_ms_total"] = total
    if total == 0.0:
        out["note"] = "key_averages() shows no device time"
        return out
    out["top5"] = [{"name": e.key, "device_ms": device_ms(e),
                    "count": e.count} for e in rows[:5]]
    return out


def profile_full_scan(index, bounds) -> dict:
    """One full-scan call of 4 query blocks on the grid3d cloud."""
    from sparsespatialsampling_torch.ops import knn
    rng = np.random.default_rng(6)
    queries = rng.uniform(bounds[0], bounds[1], size=(4 * index._tile_q, 3))
    q = index._queries_f32(queries - index._shift)
    return {"n_queries": int(q.shape[0]), **profile_window(
        lambda: knn._search(q, index._points, index._points_sq, 26,
                            index._tile_n, index._tile_q))}


def profile_epoch(tree, axis_xy, n_cells: int = 4096) -> dict:
    """One grid epoch pass (grid query, ring, rescue, IDW, gain) over the
    ``n_cells`` alive cells of the finished grid3d tree nearest the cloud's
    cylindrical hole, whose queries the ring answers.  Each pass adds to
    the tree's counters; ``ring_queries`` is one pass's."""
    alive = tree._alive_idx()
    centers = tree._centers_of(tree._coords[alive], tree._level[alive])
    near = np.argsort(np.linalg.norm(centers[:, :2] - axis_xy, axis=1),
                      kind="stable")[:n_cells]
    cells = np.sort(alive[near])
    st = tree._epoch_stats
    before = st["ring_queries"]
    out = {"n_cells": int(cells.size),
           **profile_window(lambda: tree._epoch(cells, "grid"))}
    out["ring_queries"] = (st["ring_queries"] - before) // 3
    return out


def weights_rerun(s3) -> dict:
    """The export's kNN weights of every cell centre again, warm: the grid
    query alone, the full scan of its rejected rows alone, the whole
    ``weights_device`` (device route) and ``weights`` (host route) calls,
    the host route's selection alone (its indices read back), and the
    host cache with its CSR operator (``build_host_weight_cache``, what
    the prefetch thread builds)."""
    from sparsespatialsampling_torch.ops import knn
    from sparsespatialsampling_torch.ops.interpolate import (
        build_host_weight_cache)
    index = s3._knn_index
    q = np.asarray(s3.centers, dtype=np.float64) - index._shift
    qf, chunk = index._queries_f32(q), index._grid_chunk

    def grid_only():
        return [knn._dilated_topk(qf[lo:lo + chunk], index._grid, 26)
                for lo in range(0, qf.shape[0], chunk)]
    ok = torch.cat([r[3] for r in grid_only()])
    bad = torch.nonzero(~ok).flatten().cpu().numpy()
    return {"grid_query_s": timed_call(grid_only),
            "full_scan_fallback_s": timed_call(
                lambda: index._full_scan(q[bad], 26, "query")),
            "weights_device_s": timed_call(
                lambda: index.weights_device(s3.centers, 26)),
            "weights_host_s": timed_call(
                lambda: index.weights(s3.centers, 26)),
            "weights_host_select_s": timed_call(
                lambda: index._perm_dev[index._spatial_run(
                    s3.centers, 26, "query")[1]].cpu().numpy()),
            "host_cache_s": timed_call(
                lambda: build_host_weight_cache(index, s3.centers, 26)),
            "fallback_rows": int(bad.size)}


def grid3d_case():
    """The ``grid3d`` workload: ``(points, metric, geometries, grid
    arguments, bounds)``."""
    from sparsespatialsampling_torch import CubeGeometry, SphereGeometry
    xyz, metric, bounds = cylinder_wake_3d()
    geometries = [CubeGeometry("domain", True, bounds[0], bounds[1]),
                  SphereGeometry("hole", False, [0.2, 0.2, 0.2], 0.05,
                                 refine=True, min_refinement_level=7)]
    return (xyz, metric, geometries,
            {"uniform_levels": 5, "n_cells_max": 150_000}, bounds)


def cylinder3d_case():
    """Bench workload 2's grid: ``(points, metric, geometries, grid
    arguments)``."""
    from sparsespatialsampling_torch import CubeGeometry, CylinderGeometry3D
    xyz, metric, bounds = cylinder_wake_3d()
    geometries = [CubeGeometry("domain", True, bounds[0], bounds[1]),
                  CylinderGeometry3D("cylinder", False,
                                     [[0.2, 0.2, 0.0], [0.2, 0.2, 0.41]],
                                     0.05, refine=True,
                                     min_refinement_level=7)]
    return xyz, metric, geometries, {"uniform_levels": 5,
                                     "n_cells_max": 150_000}


def grid2d_metric_case():
    """The ``grid2d_metric`` workload: ``(points, metric, geometries, grid
    arguments)``."""
    from sparsespatialsampling_torch import CubeGeometry, SphereGeometry
    xy, metric, bounds = channel_wake_2d()
    geometries = [CubeGeometry("domain", True, bounds[0], bounds[1]),
                  SphereGeometry("cylinder", False, [0.2, 0.2], 0.05,
                                 refine=True, min_refinement_level=9)]
    return xy, metric, geometries, {"uniform_levels": 5, "min_metric": 0.75}


def phase_grid3d(tmp: str) -> tuple:
    xyz, metric, geometries, kw, bounds = grid3d_case()
    n_snap = 10
    phases = np.linspace(0, 2 * np.pi, n_snap, endpoint=False)
    snaps = (metric[:, None]
             * (1 + 0.2 * np.sin(phases)[None, :])).astype(np.float32)
    times = [f"{t:.4f}" for t in np.arange(n_snap) * 5e-4]
    s3, exp, field, t, counts, tap, tree = main_path_run(
        "grid3d", tmp, "c3d", xyz, metric, geometries, export=(snaps, times),
        **kw)
    out = {"phase": "grid3d", "n_points": int(xyz.shape[0]),
           **grid_summary(s3, t), **export_summary("grid3d", exp, t),
           "launches": counts,
           **check_export(tmp, "c3d", xyz, snaps, s3, field, n_snap)}
    check_expected("grid3d", out)
    out["kernel_at_call_sites"] = check_sites(tap)
    out["export_weights_rerun"] = weights_rerun(s3)
    out["profile_epoch"] = profile_epoch(tree, np.array([0.2, 0.2]))
    out["profile_full_scan"] = profile_full_scan(s3._knn_index, bounds)
    return out, counts


def phase_grid2d_metric(tmp: str) -> tuple:
    xy, metric, geometries, kw = grid2d_metric_case()
    # no export here, and the ring may leave the full scan nothing to do
    s3, _, _, t, counts, tap, _ = main_path_run(
        "grid2d_metric", tmp, "c2d", xy, metric, geometries,
        sites=("grid_select", RING), **kw)
    out = {"phase": "grid2d_metric", "n_points": int(xy.shape[0]),
           **grid_summary(s3, t), "launches": counts}
    check_expected("grid2d_metric", out)
    out["kernel_at_call_sites"] = check_sites(tap)
    return out, counts


RESCUE_MODES = ("auto", "1", "0")


def phase_rescue_modes(tmp: str) -> tuple:
    """``grid2d_metric`` under each of ``SamplingTree.FULL_RESCUE``'s modes
    (the JAX package's ``S3_TPU_FULL_RESCUE``): "auto" (the default, which
    turns the in-epoch full-scan rescue on at the first cell escalation,
    as this case's does), "1" (on from the first epoch: every window's
    epochs run the rescue's full scan) and "0" (never: every bad cell
    takes the host escalation).  Each mode is a main-path run and must
    grow the pinned grid, cell for cell, with the same iterations and
    windows as graph replays; "1" and "0" run again with the loop bodies
    eager, row for row and bitwise their graphs' grids.  Returns the
    phase's line and each mode's launches."""
    from sparsespatialsampling_torch.engine.tree import SamplingTree
    xy, metric, geometries, kw = grid2d_metric_case()
    out = {"phase": "rescue_modes", "case": "grid2d_metric",
           "n_points": int(xy.shape[0])}
    keys, counts_of = {}, {}
    t0 = time.perf_counter()
    try:
        for mode in RESCUE_MODES:
            SamplingTree.FULL_RESCUE = mode
            # "0" never rescues, and the ring leaves the full scan nothing
            sites = (MAIN_SITES if mode == "1" else ("grid_select", RING))
            s3, _, _, t, counts, tap, tree = main_path_run(
                f"rescue_modes_{mode}", tmp, f"rm{mode}", xy, metric,
                geometries, sites=sites, **kw)
            line = {**grid_summary(s3, t), "launches": counts,
                    "launches_per_site": dict(tap.launches),
                    "rescue_active": bool(tree._rescue_active)}
            check_expected("grid2d_metric", line)
            keys[mode] = grid_key(s3)
            counts_of[f"rescue_{mode}"] = counts
            if mode == "auto" and not line["rescue_active"]:
                raise AssertionError("rescue_modes: the auto run never "
                                     "turned the rescue on")
            if mode == "1" and not line["rescue_active"]:
                raise AssertionError("rescue_modes: mode 1 ran without "
                                     "the rescue")
            if mode == "0" and (line["rescue_active"]
                                or line["rescued_queries"]):
                raise AssertionError("rescue_modes: mode 0 rescued "
                                     f"{line['rescued_queries']} queries")
            if mode != "auto":
                line.update(compare_routes(f"rescue_modes: {mode} and auto",
                                           keys[mode], keys["auto"]))
                rows = grid_rows(s3)
                SamplingTree._LOOP_GRAPHS = False
                try:
                    s3, _, _, te, _ = run_grid(tmp, f"rm{mode}e", xy, metric,
                                               geometries, **kw)
                finally:
                    SamplingTree._LOOP_GRAPHS = True
                line["eager_body"] = {
                    "refine_total": te["refine"],
                    **compare_bitwise(f"rescue_modes: {mode}, graphs and "
                                      "eager body", rows, grid_rows(s3))}
            out[mode] = line
            del s3, tree
    finally:
        SamplingTree.FULL_RESCUE = "auto"
    out["phase_wall_s"] = time.perf_counter() - t0
    return out, counts_of


def phase_full_scan() -> dict:
    """The full scan on the card against the same scan on the CPU."""
    from sparsespatialsampling_torch.ops import knn
    xyz, _, bounds = cylinder_wake_3d(120_000, seed=4)
    queries = np.random.default_rng(5).uniform(bounds[0], bounds[1],
                                               size=(2048, 3))
    k = 26
    out, got = {"phase": "full_scan", "n_points": 120_000,
                "n_queries": 2048, "k": k}, {}
    for dev in ("cuda", "cpu"):
        index = knn.KNNIndex(xyz, device=dev)
        q = index._queries_f32(queries - index._shift)

        def call():
            return knn._search(q, index._points, index._points_sq, k,
                               index._tile_n, index._tile_q)
        if dev == "cuda":
            call()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sq, idx = call()
        if dev == "cuda":
            torch.cuda.synchronize()
        out[f"{dev}_wall_s"] = time.perf_counter() - t0
        got[dev] = (sq.cpu(), idx.cpu())
    (sa, ia), (sb, ib) = got["cuda"], got["cpu"]
    if not (torch.equal(sa, sb) and torch.equal(ia, ib)):
        raise AssertionError(
            f"full scan differs between cuda and cpu: sq equal "
            f"{torch.equal(sa, sb)}, idx equal {torch.equal(ia, ib)}")
    if not bool(torch.isfinite(sa).all()):
        raise AssertionError("full scan returned non-finite distances")
    out["bitwise_equal_cpu"] = True
    return out


def compare_case():
    """The 60 000-point 3D case of ``cuda_vs_cpu`` and ``blocked_layout``:
    ``(points, metric, geometries, grid arguments)``."""
    from sparsespatialsampling_torch import CubeGeometry, SphereGeometry
    xyz, metric, bounds = cylinder_wake_3d(60_000, seed=2)
    geometries = [CubeGeometry("domain", True, bounds[0], bounds[1]),
                  SphereGeometry("hole", False, [0.2, 0.2, 0.2], 0.05)]
    return xyz, metric, geometries, {"uniform_levels": 4, "n_cells_max": 8000}


def grid_key(s3) -> tuple:
    """``(levels, centres, iterations, metric trace)``, cells lexsorted."""
    lv = np.asarray(s3.levels).ravel()
    order = np.lexsort((lv,) + tuple(s3.centers.T))
    return (lv[order], s3.centers[order], s3.data_final_mesh["iterations"],
            np.asarray(s3.data_final_mesh["metric_per_iter"]))


def compare_grids(what: str, a: tuple, b: tuple) -> dict:
    (la, ca, ia, ma), (lb, cb, ib, mb) = a, b
    same = (la.shape == lb.shape and np.array_equal(la, lb)
            and np.array_equal(ca, cb) and ia == ib)
    if not same:
        raise AssertionError(f"{what} grids differ: cells {la.size} vs "
                             f"{lb.size}, iterations {ia} vs {ib}")
    return {"identical": True,
            "metric_trace_max_abs_diff": float(np.abs(ma - mb).max())}


def case_summary(s3, t) -> dict:
    st = s3.data_final_mesh["epoch_stats"]
    return {"n_cells": int(s3.centers.shape[0]),
            "iterations": int(s3.data_final_mesh["iterations"]),
            "ring_queries": int(st["ring_queries"]),
            "bad_cells_escalated": int(st["n_bad_cells"]),
            "bad_cells_to_full_scan": int(st["full_scan_cells"]),
            "route": "device_loop" if st["windows"] else "host_loop",
            "windows": int(st["windows"]),
            "refine_s": t["refine"]}


def phase_cuda_vs_cpu(tmp: str) -> tuple:
    """Returns the phase's line, the card's grid in row order, and both
    devices' grids (for ``export_routes``)."""
    xyz, metric, geometries, kw = compare_case()
    keys, grids, out = {}, {}, {"phase": "cuda_vs_cpu", "n_points": 60_000}
    for dev in ("cuda", "cpu"):
        s3, _, _, t, _ = run_grid(tmp, f"cmp_{dev}", xyz, metric, geometries,
                                  device=dev, **kw)
        keys[dev], grids[dev] = grid_key(s3), s3
        out[dev] = case_summary(s3, t)
        if dev == "cuda":
            rows = grid_rows(s3)
    out.update(compare_grids("cuda and cpu", keys["cuda"], keys["cpu"]))
    return out, rows, grids


def count_differing(a: np.ndarray, b: np.ndarray) -> int:
    """Values whose bytes differ (so -0.0 and 0.0 count as different)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"arrays of {a.shape} {a.dtype} and {b.shape} "
                             f"{b.dtype} compared")
    width = {4: np.uint32, 8: np.uint64}[a.dtype.itemsize]
    return int((np.ascontiguousarray(a).view(width)
                != np.ascontiguousarray(b).view(width)).sum())


def phase_export_routes(grids: dict) -> dict:
    """Both export routes (``ExportData.INTERP``) on ``cuda_vs_cpu``'s two
    grids, 10 snapshots at the cell centres and vertices.  On the host
    route the card's centre and vertex weights, neighbours, f64 metric
    and ``[M, 1, 10]`` fields must be the CPU run's bit for bit, and the
    host weights contracted on the card (``interpolate_data``, the device
    route's and the mesh's left-to-right sum) must equal the host route's
    CSR product; the device route's values of the card against the CPU
    are counted.  Walls and the export's timings of every run."""
    from sparsespatialsampling_torch import ExportData
    from sparsespatialsampling_torch.ops.interpolate import interpolate_data
    xyz, metric, _, _ = compare_case()
    n_snap = 10
    phases = np.linspace(0, 2 * np.pi, n_snap, endpoint=False)
    snaps = (metric[:, None] * (1 + 0.2 * np.sin(phases))[None, :]
             + 0.1 * xyz[:, :1] * np.cos(phases)[None, :]).astype(
                 np.float32)[:, None, :]
    times = [str(i) for i in range(n_snap)]
    out = {"phase": "export_routes", "n_points": int(xyz.shape[0]),
           "n_snapshots": n_snap}
    got = {}
    saved = ExportData.INTERP
    try:
        for dev, s3 in grids.items():
            for route in ("host", "device"):
                ExportData.INTERP = route
                exp = ExportData(s3, write_times=times, device=dev,
                                 interpolate_at_vertices=True)
                t0 = time.perf_counter()
                field = exp.interpolate(xyz, snaps)
                if dev == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got[dev, route] = {
                    "w_centers": host(exp._w_centers),
                    "idx_centers": host(exp._idx_centers),
                    "w_vertices": host(exp._w_vertices),
                    "idx_vertices": host(exp._idx_vertices),
                    "metric": np.asarray(exp._metric),
                    "centers": field,
                    "vertices": exp._interpolated_fields.vertices}
                out[f"{dev}_{route}"] = {
                    "wall_s": wall, "prefetch": exp.timings["prefetch"],
                    "n_cells": int(s3.centers.shape[0]),
                    "n_vertices": int(s3.vertices.shape[0]),
                    **{key: exp.timings[key] for key in EXPORT_KEYS
                       if key != "t_h5"}}
    finally:
        ExportData.INTERP = saved
    card, cpu = got["cuda", "host"], got["cpu", "host"]
    if card["metric"].dtype != np.float64:
        raise AssertionError("export_routes: the host route's metric is "
                             f"{card['metric'].dtype}, not float64")
    differ = {key: count_differing(card[key].astype(cpu[key].dtype,
                                                    copy=False), cpu[key])
              for key in card}
    out["host_route_card_vs_cpu_differing"] = differ
    if any(differ.values()) or any(card[key].dtype != cpu[key].dtype
                                   for key in card):
        raise AssertionError(f"export_routes: the host route differs "
                             f"between the card and the CPU: {differ}")
    dev = torch.device("cuda")
    data = torch.from_numpy(snaps).to(dev)
    contracted = {
        part: interpolate_data(
            torch.from_numpy(card[f"w_{part}"]).to(dev),
            torch.from_numpy(card[f"idx_{part}"]).to(dev),
            data).cpu().numpy()
        for part in ("centers", "vertices")}
    n_diff = sum(count_differing(contracted[part], card[part])
                 for part in contracted)
    out["card_contraction_vs_host_csr_differing"] = n_diff
    out["card_contraction_values"] = int(sum(v.size for v in
                                             contracted.values()))
    if n_diff:
        raise AssertionError(f"export_routes: the host weights contracted "
                             f"on the card differ from the CSR product in "
                             f"{n_diff} values")
    card, cpu = got["cuda", "device"], got["cpu", "device"]
    out["device_route_card_vs_cpu_differing"] = {
        key: count_differing(card[key], cpu[key]) for key in card}
    out["device_route_metric_dtype"] = str(card["metric"].dtype)
    return out


def phase_blocked_layout(tmp: str) -> tuple:
    """The ``cuda_vs_cpu`` case on the card with the dilated layout and
    without it (``KNNIndex.DIL_MAX_BYTES = 0``): every epoch query and every
    ring then selects over blocked slabs, and the grid must not move."""
    from sparsespatialsampling_torch.ops.knn import KNNIndex
    xyz, metric, geometries, kw = compare_case()
    out = {"phase": "blocked_layout", "n_points": 60_000}
    s3, _, _, t, _ = run_grid(tmp, "dil", xyz, metric, geometries, **kw)
    dilated = grid_key(s3)
    out["dilated"] = case_summary(s3, t)
    saved = KNNIndex.DIL_MAX_BYTES
    KNNIndex.DIL_MAX_BYTES = 0
    try:
        s3, _, _, t, counts, tap, _ = main_path_run(
            "blocked_layout", tmp, "blk", xyz, metric, geometries,
            sites=(BLOCKED,), device_loop=False, **kw)
    finally:
        KNNIndex.DIL_MAX_BYTES = saved
    if "dil_pts" in s3._knn_index._grid:
        raise AssertionError("blocked_layout: the index built a dilated "
                             "layout")
    out["blocked"] = {**case_summary(s3, t), "launches": counts,
                      "launches_per_site": dict(tap.launches),
                      "adaptive_route": t["adaptive_route"]}
    out.update(compare_grids("dilated and blocked", dilated, grid_key(s3)))
    out["kernel_at_call_sites"] = check_sites(tap)
    return out, counts


def phase_large_k() -> dict:
    """``KNNIndex.query`` at k = 300 on the card against the CPU: the full
    scan selects k + 8 = 308 candidates, above the kernel's queue, through
    the stable sort."""
    from sparsespatialsampling_torch.ops import knn
    xyz, _, bounds = cylinder_wake_3d(40_000, seed=7)
    queries = np.random.default_rng(8).uniform(bounds[0], bounds[1],
                                               size=(1024, 3))
    k = 300
    out, got = {"phase": "large_k", "n_points": 40_000,
                "n_queries": 1024, "k": k}, {}
    for dev in ("cuda", "cpu"):
        index = knn.KNNIndex(xyz, device=dev)
        with KernelTap() as tap:
            t0 = time.perf_counter()
            got[dev] = index.query(queries, k)
            out[f"{dev}_wall_s"] = time.perf_counter() - t0
        out[f"{dev}_sorted_selections"] = tap.sorted_calls
    (da, ia), (db, ib) = got["cuda"], got["cpu"]
    if not out["cuda_sorted_selections"]:
        raise AssertionError("large_k: no selection took the stable sort")
    if not (np.array_equal(da, db) and np.array_equal(ia, ib)):
        raise AssertionError(
            f"large_k: card and CPU differ: dists equal "
            f"{np.array_equal(da, db)}, idx equal {np.array_equal(ia, ib)}")
    if da.shape != (1024, k) or not np.isfinite(da).all():
        raise AssertionError(f"large_k: dists of shape {da.shape}, finite "
                             f"{bool(np.isfinite(da).all())}")
    out["bitwise_equal_cpu"] = True
    return out


def oat2d_case():
    """Bench workload 1's grid (``bench.py:275-288``): ``(points, metric,
    geometries, grid arguments)``."""
    from sparsespatialsampling_torch import (CubeGeometry,
                                             GeometryCoordinates2D)
    xy, metric, poly = synthetic_oat15()
    geometries = [CubeGeometry("domain", True, [-0.5, -0.5], [1.5, 0.5]),
                  GeometryCoordinates2D("airfoil", False, poly,
                                        refine=True)]
    return xy, metric, geometries, {"uniform_levels": 6,
                                    "n_cells_max": 25_000,
                                    "pre_select_cells": True}


def phase_oat2d(tmp: str) -> tuple:
    """Bench workload 1 (``bench.py:275-288``, ``:816-837``) end to end:
    the OAT15 configuration with the bbox pre-select route, 50 snapshots
    interpolated, then the rank-20 weighted SVD and a DMD."""
    xy, metric, geometries, kw = oat2d_case()
    snaps = bench_snapshots(metric)
    s3, exp, field, t, counts, tap, _ = main_path_run(
        "oat2d", tmp, "oat", xy, metric, geometries,
        export=snaps, sites=("grid_select", RING), **kw)
    out = {"phase": "oat2d", "n_points": int(xy.shape[0]),
           **grid_summary(s3, t), **export_summary("oat2d", exp, t),
           "launches": counts, "launches_per_site": dict(tap.launches)}
    check_expected("oat2d", out)
    out["analysis"] = analysis(tmp, "oat", s3, field, t)
    out["kernel_at_call_sites"] = check_sites(tap)
    return out, counts, export_result(s3, exp, field, xy, snaps)


def phase_cylinder3d(tmp: str) -> tuple:
    """Bench workload 2 (``bench.py:304-338``) end to end: the ``grid3d``
    cloud around the cylinder it was cut for, 50 snapshots interpolated,
    then the rank-20 weighted SVD and a DMD."""
    xyz, metric, geometries, kw = cylinder3d_case()
    s3, exp, field, t, counts, tap, _ = main_path_run(
        "cylinder3d", tmp, "cyl", xyz, metric, geometries,
        export=bench_snapshots(metric), sites=("grid_select", RING), **kw)
    out = {"phase": "cylinder3d", "n_points": int(xyz.shape[0]),
           **grid_summary(s3, t), **export_summary("cylinder3d", exp, t),
           "launches": counts, "launches_per_site": dict(tap.launches)}
    check_expected("cylinder3d", out)
    out["analysis"] = analysis(tmp, "cyl", s3, field, t)
    out["kernel_at_call_sites"] = check_sites(tap)
    return out, counts


def phase_mdl2d(tmp: str) -> tuple:
    """The tutorial-3 configuration (``bench.py:391-420``) at 10x its
    points: the 2:1 balance in the adaptive loop and the geometry
    refinement."""
    xy, metric, bounds, geometries, kw = mdl_case(250_000)
    s3, _, _, t, counts, tap, _ = main_path_run(
        "mdl2d", tmp, "mdl", xy, metric, geometries,
        sites=("grid_select", RING), **kw)
    out = {"phase": "mdl2d", "n_points": int(xy.shape[0]),
           **grid_summary(s3, t), "launches": counts,
           "launches_per_site": dict(tap.launches),
           "t_expand_s": float(
               s3.data_final_mesh["adaptive_split"]["t_expand"])}
    check_expected("mdl2d", out)
    out["unbalanced_neighbours"] = check_balanced("mdl2d", s3, bounds)
    out["kernel_at_call_sites"] = check_sites(tap)
    return out, counts


def check_balanced(phase: str, s3, bounds) -> int:
    """No two leaves that share a face, an edge or a corner may lie more
    than one level apart (``max_delta_level``)."""
    width = s3.size_initial_cell
    lo = (np.asarray(bounds[0]) + np.asarray(bounds[1])) / 2 - width / 2
    bad = unbalanced(s3.centers, s3.levels, lo, width)
    if bad:
        raise AssertionError(f"{phase}: {bad} neighbour positions break the "
                             f"2:1 balance")
    return bad


def mdl_case(n_points: int):
    """The tutorial-3 configuration (``bench.py:391-420``) on the clean
    wake cloud: ``(points, metric, bounds, geometries, arguments)``;
    ``channel_wake_2d(25_000)`` is ``bench.synthetic_cylinder2d(
    calibrated=False)``."""
    from sparsespatialsampling_torch import CubeGeometry, SphereGeometry
    xy, metric, bounds = channel_wake_2d(n_points)
    geometries = [CubeGeometry("domain", True, bounds[0], bounds[1]),
                  SphereGeometry("cylinder", False, [0.2, 0.2], 0.05,
                                 refine=True, min_refinement_level=12)]
    return xy, metric, bounds, geometries, {
        "uniform_levels": 5, "min_metric": 0.5, "max_delta_level": True}


def phase_mdl2d_25k(tmp: str) -> tuple:
    """Bench workload 5 at its own 25 000 points: the 2:1 closure inside
    the device loop over the full-scan core (the cloud is under
    ``GRID_MIN_POINTS``).  The grid must be the JAX package's 4 961 cells
    after 25 iterations (``BENCH_r04.json``, and both of its loops on the
    CPU).  Returns the phase's line and its launches."""
    xy, metric, bounds, geometries, kw = mdl_case(25_000)
    s3, _, _, t, counts, tap, _ = main_path_run(
        "mdl2d_25k", tmp, "mdl25k", xy, metric, geometries,
        sites=("full_scan_tile", "full_scan_merge"), **kw)
    out = {"phase": "mdl2d_25k", "n_points": int(xy.shape[0]),
           **grid_summary(s3, t), "launches": counts,
           "launches_per_site": dict(tap.launches),
           "jax_recorded": {"n_cells": 4961, "iterations": 25,
                            "captured": 0.501, "source": "BENCH_r04.json"}}
    check_expected("mdl2d_25k", out)
    out["unbalanced_neighbours"] = check_balanced("mdl2d_25k", s3, bounds)
    out["kernel_at_call_sites"] = check_sites(tap)
    return out, counts


def compare_routes(what: str, loop: tuple, host: tuple) -> dict:
    """The device loop's grid against the host loop's: the same cells,
    levels and iterations, the metric trace to rtol 1e-5."""
    out = compare_grids(what, loop, host)
    ma, mb = loop[3], host[3]
    if ma.shape != mb.shape or not np.allclose(ma, mb, rtol=1e-5, atol=0.0):
        raise AssertionError(f"{what}: metric traces differ beyond rtol "
                             f"1e-5 (lengths {ma.size}, {mb.size})")
    out["metric_trace_max_rel_diff"] = float(
        (np.abs(ma - mb) / np.abs(mb)).max())
    return out


def compare_bitwise(what: str, a: tuple, b: tuple) -> dict:
    """Two runs of the same kernels in the same order: the same cells,
    levels and iterations row for row, the metric trace bitwise."""
    out = compare_grids(what, a, b)
    if not (a[0].shape == b[0].shape and np.array_equal(a[0], b[0])
            and np.array_equal(a[1], b[1]) and a[3].shape == b[3].shape
            and np.array_equal(a[3].view(np.uint64), b[3].view(np.uint64))):
        raise AssertionError(f"{what}: rows or metric traces differ")
    out["rows_and_metric_trace_bitwise"] = True
    return out


ROUTES = {"graphs": (True, True), "eager_body": (True, False),
          "host_loop": (False, True)}


def check_failed_capture() -> dict:
    """A window body that reads a device value cannot be captured: the
    graph cache must raise, naming the key and the operation, and run
    nothing eagerly in its place (the warm-up step before it is eager by
    design)."""
    from sparsespatialsampling_torch.engine import graphs
    cache = graphs.WindowGraphs(torch.device("cuda"))
    stats = graphs.new_stats()
    x = torch.zeros(4, device="cuda")

    def body():
        x.add_(1.0)
        if float(x.sum()) < 0:          # reads a device value: a sync
            x.zero_()
    key = ("probe", 4)
    cache.step(key, body, lambda: x[:1].long(), stats)
    try:
        cache.step(key, body, lambda: x[:1].long(), stats)
    except RuntimeError as exc:
        msg = str(exc)
    else:
        raise AssertionError("a capture that reads a device value did not "
                             "raise")
    torch.cuda.synchronize()
    out = {"raised": msg[:300], "eager_iterations": stats["eager_iterations"],
           "x": float(x[0])}
    if not ("'probe'" in msg and "float(x.sum())" in msg
            and stats["eager_iterations"] == 1 and out["x"] == 1.0):
        raise AssertionError(f"failed capture: {out}")
    return out


def phase_device_loop_vs_host(tmp: str, stl_path: str) -> dict:
    """The ``cuda_vs_cpu`` case, ``mdl2d_25k`` and ``stl3d`` on the card
    on three routes: the device loops' windows as graph replays (the
    default), their bodies run eagerly (``SamplingTree._LOOP_GRAPHS =
    False``), and the host loop (``DEVICE_LOOP = False``; ``stl3d``'s is
    in ``geometry_loop_vs_host``).  The graphs must equal the eager body
    row for row with the metric trace bitwise (the same kernels in the
    same order) and launch each kernel as often; the host loop must give
    the same grid.  The eager body's first window and the first window
    replaying a captured graph are profiled (:class:`WindowProfile`)."""
    from sparsespatialsampling_torch.engine.tree import SamplingTree
    out = {"phase": "device_loop_vs_host",
           "failed_capture": check_failed_capture()}

    def run(name, pts, metric, geometries, route, **kw):
        SamplingTree.DEVICE_LOOP, SamplingTree._LOOP_GRAPHS = ROUTES[route]
        try:
            with WindowProfile(replays=route == "graphs") as prof:
                reset_counts()
                s3, _, _, t, _ = run_grid(tmp, f"{name}_{route}", pts,
                                          metric, geometries, **kw)
                torch.cuda.synchronize()
                counts = read_counts()
            rows = grid_rows(s3)
        finally:
            SamplingTree.DEVICE_LOOP, SamplingTree._LOOP_GRAPHS = True, True
        res = {**case_summary(s3, t), "launches": counts,
               "adaptive_route": adaptive_route(s3),
               "t_window_s": float(
                   s3.data_final_mesh["adaptive_split"]["t_window"])}
        if s3.data_final_mesh["t_geometry"] is not None:
            res["geometry_route"] = geometry_route(s3)
        if prof.out is not None:
            res["window_profile"] = prof.out
        check_route(f"{name} ({route})", res["adaptive_route"],
                    route != "host_loop")
        return rows, res
    xyz, metric, geometries, kw = compare_case()
    xy, m25, _, g25, kw25 = mdl_case(25_000)
    stl_pts, stl_metric, stl_geoms, stl_kw, _ = stl3d_case(stl_path)
    cases = {"cuda_vs_cpu_case": (xyz, metric, geometries, kw, True),
             "mdl2d_25k": (xy, m25, g25, kw25, True),
             "stl3d": (stl_pts, stl_metric, stl_geoms, stl_kw, False)}
    for name, (pts, met, geoms, ckw, host) in cases.items():
        keys, res = {}, {}
        for route in ROUTES if host else ("graphs", "eager_body"):
            keys[route], res[route] = run(name, pts, met, geoms, route,
                                          **ckw)
        res["graphs_vs_eager_body"] = compare_bitwise(
            f"{name}: graphs and eager body", keys["graphs"],
            keys["eager_body"])
        if res["graphs"]["launches"] != res["eager_body"]["launches"]:
            raise AssertionError(f"{name}: launches under graphs "
                                 f"{res['graphs']['launches']}, eager "
                                 f"{res['eager_body']['launches']}")
        # the same window steps: the eager body's, all but one warm-up a
        # key replays under the graphs
        for loop in ("adaptive_route", "geometry_route"):
            if loop not in res["graphs"]:
                continue
            g, e = res["graphs"][loop], res["eager_body"][loop]
            check_graphs(f"{name} ({loop})", g)
            if g["graph_replays"] + g["eager_iterations"] != \
                    e["eager_iterations"]:
                raise AssertionError(f"{name}: {loop} steps differ between "
                                     f"graphs {g} and eager body {e}")
        if host:
            res["graphs_vs_host_loop"] = compare_routes(
                f"{name}: device and host loop", keys["graphs"],
                keys["host_loop"])
        if name in EXPECTED:
            check_expected(name, res["graphs"])
        out[name] = res
    return out


def bench_snapshots(metric, n_snap: int = 50) -> tuple:
    """The 50 snapshots and write times of bench workloads 1 and 2
    (``bench.py:321-325``, ``:822-826``)."""
    phases = np.linspace(0, 2 * np.pi, n_snap, endpoint=False)
    snaps = (metric[:, None]
             * (1 + 0.2 * np.sin(phases)[None, :])).astype(np.float32)
    return snaps, [f"{t:.4f}" for t in np.arange(n_snap) * 5e-4]


def check_matmul_precision() -> dict:
    """The analysis matmuls (the f32 mode product, the sketch) rely on
    PyTorch's default of no TF32; a TF32 product would still pass a loose
    tolerance, so the default is asserted."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    if tf32 or precision != "highest":
        raise AssertionError(f"f32 matmuls may use TF32 (allow_tf32={tf32}, "
                             f"float32_matmul_precision={precision!r})")
    return {"allow_tf32": tf32, "float32_matmul_precision": precision}


class SvdTap:
    """Times the three parts of the tall-skinny SVD (the f64 Gram on the
    card, the host ``eigh``, the f32 mode product) and counts the routes
    ``compute_svd`` takes, by wrapping the module functions as
    :class:`KernelTap` does; each wrapped call is timed between two
    synchronisations."""

    def __init__(self):
        from sparsespatialsampling_torch import utils
        from sparsespatialsampling_torch.ops import svd
        self._targets = [(svd, "_gram", "t_gram"),
                         (svd, "_eigh_descending", "t_eigh"),
                         (svd, "_modes", "t_modes"),
                         (utils, "economy_svd_device", "economy_svd"),
                         (utils, "randomized_svd_device", "randomized_svd"),
                         (utils, "distributed_rsvd_device",
                          "distributed_rsvd"),
                         (utils, "optimal_rank_sketched", "sketched_rank")]
        self.seconds, self.calls, self._saved = {}, {}, []

    def _wrap(self, fn, key):
        def tapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[key] = (self.seconds.get(key, 0.0)
                                 + time.perf_counter() - t0)
            self.calls[key] = self.calls.get(key, 0) + 1
            return out
        return tapped

    def __enter__(self):
        for module, name, key in self._targets:
            self._saved.append((module, name, getattr(module, name)))
            setattr(module, name, self._wrap(getattr(module, name), key))
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def sorted_eigenvalues(ev: np.ndarray) -> np.ndarray:
    return ev[np.lexsort((ev.imag, ev.real))]


def check_dmd(card: dict, cpu: dict) -> float:
    """The card's DMD against the port's CPU run of the same input: the
    same rank, eigenvalues sorted by (real, imag) to 1e-4 (relative, and
    of the largest); returns the largest difference."""
    if card["rank"] != cpu["rank"]:
        raise AssertionError(f"DMD rank {card['rank']} on the card, "
                             f"{cpu['rank']} on the CPU")
    a = sorted_eigenvalues(card["eigenvalues"])
    b = sorted_eigenvalues(cpu["eigenvalues"])
    err = np.abs(a - b)
    if (err > 1e-4 * (np.abs(b) + np.abs(b).max())).any():
        raise AssertionError(f"DMD eigenvalues differ from the CPU's by "
                             f"{err.max():.3e}")
    return float(err.max())


def analysis(tmp: str, name: str, s3, field, t: dict, rank: int = 20,
             dmd_rank: int = 10) -> dict:
    """Bench workloads 1-2's analysis of the interpolated snapshots on the
    card: ``compute_svd(rank=20)`` (twice: the first call pays the f64
    kernels' first use) and ``compute_dmd(rank=10)``.  ``s`` must lie
    within 1e-5·s[0] of a float64 host SVD of the same weighted, mean-free
    matrix; each of the first five modes whose gap to its neighbours
    exceeds 1e-3·s[0] must have ``|cos| ≥ 1 - 1e-4`` with the reference's;
    the DMD eigenvalues must match the port's CPU run."""
    from sparsespatialsampling_torch import compute_dmd, compute_svd
    if field is None:
        from sparsespatialsampling_torch import Dataloader
        field = Dataloader(tmp, f"{name}.h5").load_snapshot("k")
    else:
        field = field[:, 0, :]
    area = np.squeeze((s3.size_initial_cell
                       / np.power(2.0, np.asarray(s3.levels, np.float64)))
                      ** s3.n_dimensions)
    walls = []
    for _ in range(2):
        with SvdTap() as tap:
            t0 = time.perf_counter()
            s, u, v = compute_svd(field, area, rank=rank)
            walls.append(time.perf_counter() - t0)
    if tap.calls.get("economy_svd") != 1 or "t_gram" not in tap.calls:
        raise AssertionError(f"compute_svd took the routes {tap.calls}, "
                             f"not the tall-skinny Gram route")
    dmd_walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        dmd = compute_dmd(field, area, rank=dmd_rank)
        dmd_walls.append(time.perf_counter() - t0)
    dmd_err = check_dmd(dmd, compute_dmd(field, area, rank=dmd_rank,
                                         device="cpu"))

    w = np.sqrt(area.astype(np.float32)).astype(np.float64)
    x = field.astype(np.float64)
    x = (x - x.mean(axis=1, keepdims=True)) * w[:, None]
    u_ref, s_ref, _ = np.linalg.svd(x, full_matrices=False)
    if s.shape != (rank,) or u.shape != (field.shape[0], rank) \
            or v.shape != (field.shape[1], rank) \
            or not (np.isfinite(s).all() and np.isfinite(u).all()):
        raise AssertionError(f"compute_svd gave s {s.shape}, U {u.shape}, "
                             f"V {v.shape}, or non-finite values")
    s_err = float(np.abs(s - s_ref[:rank]).max() / s_ref[0])
    if s_err > 1e-5:
        raise AssertionError(f"s deviates from the float64 host SVD by "
                             f"{s_err:.3e}·s[0]")
    cosines = {}
    for i in range(5):
        gap = min(s_ref[i - 1] - s_ref[i] if i else np.inf,
                  s_ref[i] - s_ref[i + 1]) / s_ref[0]
        if gap <= 1e-3:
            cosines[f"mode_{i + 1}"] = f"gap {gap:.3e}·s[0]: not compared"
            continue
        uw = u[:, i] * w
        cos = float(abs(uw @ u_ref[:, i]) / np.linalg.norm(uw))
        if cos < 1 - 1e-4:
            raise AssertionError(f"mode {i + 1}: |cos| {cos} with the "
                                 f"float64 reference")
        cosines[f"mode_{i + 1}"] = cos
    return {"field_shape": list(field.shape),
            "wall_s": {"grid": t["refine"], "interpolate": t["export"],
                       "svd": walls, "dmd": dmd_walls},
            "svd_split_s": tap.seconds, "svd_routes": tap.calls,
            "rank": int(s.shape[0]), "s_top5": s[:5].tolist(),
            "s_ref_top5": s_ref[:5].tolist(),
            "s_max_err_over_s0": s_err, "mode_cosines": cosines,
            "dmd_rank": int(dmd["rank"]),
            "dmd_eigenvalues": [str(e) for e in
                                sorted_eigenvalues(dmd["eigenvalues"])],
            "dmd_eigenvalue_max_err_vs_cpu": dmd_err,
            "hdf5": ("export written; write_svd_s_cube_to_file is held on "
                     "the CPU (tests/test_torch_analysis.py)" if HAVE_H5PY
                     else "not written: h5py is not installed here, so "
                     "write_svd_s_cube_to_file is held on the CPU only "
                     "(tests/test_torch_analysis.py)")}


# the planted singular values of svd_routes: the weakest stands about 32x
# above the 1e-3 noise's floor of about 0.78 (so the planted modes are
# recovered to 1e-2), and the strongest within about 80x of it, so the f32
# rounding that both devices add to the noise part of the sketch stays
# near eps32·80 ≈ 1e-5 of the noise singular values
PLANTED = (60.0, 45.0, 35.0, 25.0)


def planted_matrix(m: int = 600_000, n: int = 50, noise: float = 1e-3,
                   seed: int = 5, device: str = "cuda") -> tuple:
    """``[m, n]`` f32 on the card: ``U0 diag(PLANTED) V0ᵀ`` with orthonormal
    U0 and V0 (V0's columns mean-free, so ``compute_svd``'s removal of the
    temporal mean keeps the planted modes) plus Gaussian noise."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float64)
    u0 = torch.linalg.qr(randn(m, len(PLANTED))).Q
    v0 = randn(n, len(PLANTED))
    v0 = torch.linalg.qr(v0 - v0.mean(dim=0)).Q
    sigma = torch.tensor(PLANTED, dtype=torch.float64, device=device)
    a = ((u0 * sigma) @ v0.T + noise * randn(m, n)).float()
    return a, u0.cpu().numpy(), v0.cpu().numpy()


def subspace_cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cosines of the principal angles between two column spaces."""
    qa = np.linalg.qr(np.asarray(a, np.float64))[0]
    qb = np.linalg.qr(np.asarray(b, np.float64))[0]
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def phase_svd_routes() -> dict:
    """The randomized route, which neither workload reaches: a seeded
    [600000, 50] matrix with four planted modes through
    ``compute_svd(rank=None)`` on the card (it must take
    ``randomized_svd`` and the sketched rank), against the planted
    spectrum and ``economy_svd`` (top four values to rtol 1e-2, subspace
    cosines ≥ 0.999); then ``randomized_svd(rank=20)`` on the card against
    the port's CPU run (the same sketch), ``s`` to rtol 1e-4."""
    from sparsespatialsampling_torch import compute_svd
    from sparsespatialsampling_torch.ops.svd import (economy_svd,
                                                     randomized_svd)
    a, u0, v0 = planted_matrix()
    ones = np.ones(a.shape[0], dtype=np.float32)
    walls = {}
    with SvdTap() as tap:
        t0 = time.perf_counter()
        s, u, v = compute_svd(a, ones)
        walls["compute_svd_auto"] = time.perf_counter() - t0
    if (tap.calls.get("randomized_svd") != 1
            or tap.calls.get("sketched_rank") != 1
            or "economy_svd" in tap.calls):
        raise AssertionError(f"compute_svd took the routes {tap.calls}, not "
                             f"randomized_svd with the sketched rank")
    k = len(PLANTED)
    if s.shape[0] < k:
        raise AssertionError(f"the sketched rank is {s.shape[0]}, below the "
                             f"{k} planted modes")
    t0 = time.perf_counter()
    u_e, s_e, v_e = economy_svd(a)
    walls["economy_svd"] = time.perf_counter() - t0
    cos = {"planted_u": subspace_cosines(u[:, :k], u0).min(),
           "planted_v": subspace_cosines(v[:, :k], v0).min(),
           "economy_u": subspace_cosines(u[:, :k], u_e[:, :k]).min(),
           "economy_v": subspace_cosines(v[:, :k], v_e[:, :k]).min()}
    rel = {"planted": np.abs(s[:k] / np.asarray(PLANTED) - 1).max(),
           "economy": np.abs(s[:k] / s_e[:k] - 1).max()}
    if max(rel.values()) > 1e-2 or min(cos.values()) < 0.999:
        raise AssertionError(f"svd_routes: top {k} values off by {rel}, "
                             f"subspace cosines {cos}")
    t0 = time.perf_counter()
    _, s_card, _ = randomized_svd(a, rank=20)
    walls["randomized_svd_rank20"] = time.perf_counter() - t0
    a_cpu = a.cpu()
    t0 = time.perf_counter()
    _, s_cpu, _ = randomized_svd(a_cpu, rank=20, device="cpu")
    walls["randomized_svd_rank20_cpu"] = time.perf_counter() - t0
    rsvd_err = float(np.abs(s_card / s_cpu - 1).max())
    if rsvd_err > 1e-4:
        raise AssertionError(f"randomized_svd(rank=20) on the card differs "
                             f"from the CPU's by {rsvd_err:.3e} (relative)")
    return {"phase": "svd_routes", "shape": list(a.shape),
            "planted": list(PLANTED), "routes": tap.calls,
            "sketched_rank": int(s.shape[0]), "s_top": s[:k + 1].tolist(),
            "s_economy_top": s_e[:k + 1].tolist(),
            "max_rel_err_top4": {key: float(v) for key, v in rel.items()},
            "min_subspace_cos": {key: float(v) for key, v in cos.items()},
            "rank20_s_max_rel_err_vs_cpu": rsvd_err,
            "rank20_s": s_card.tolist(), "wall_s": walls,
            "split_s": tap.seconds}


def phase_c2d_reltol(tmp: str) -> tuple:
    """Bench workload 3 (``bench.py:341-430``) at its own 25 000 points:
    the tutorial-1 configuration on the field calibrated to stall, which
    must stop on the relTol rule below ``min_metric``.  The cloud is under
    ``GRID_MIN_POINTS``, so the full scan answers every query."""
    from sparsespatialsampling_torch import CubeGeometry, SphereGeometry
    xy, metric, bounds = calibrated_cylinder2d()
    geometries = [CubeGeometry("domain", True, bounds[0], bounds[1]),
                  SphereGeometry("cylinder", False, [0.2, 0.2], 0.05,
                                 refine=True, min_refinement_level=9)]
    s3, _, _, t, counts, tap, _ = main_path_run(
        "c2d_reltol", tmp, "c2d", xy, metric, geometries,
        sites=("full_scan_tile", "full_scan_merge"), uniform_levels=5,
        min_metric=0.75)
    out = {"phase": "c2d_reltol", "n_points": int(xy.shape[0]),
           **grid_summary(s3, t), "launches": counts,
           "launches_per_site": dict(tap.launches)}
    check_expected("c2d_reltol", out)
    trace = np.asarray(s3.data_final_mesh["metric_per_iter"])
    stall = abs(trace[-1] - trace[-2])
    if not (0.75 * 0.75 <= trace[-1] < 0.75 and stall <= 1e-3):
        raise AssertionError(f"c2d_reltol: stopped at {trace[-1]} captured "
                             f"after a step of {stall}, not on the relTol "
                             f"rule")
    out["reltol_stop"] = {"captured": float(trace[-1]),
                          "last_step": float(stall),
                          "jax_recorded_captured": 0.5652,
                          "jax_recorded_source": "BENCH_r05.json",
                          "jax_tpu_recorded_iterations": 72,
                          "jax_tpu_recorded_source": "BENCH_r04.json"}
    out["kernel_at_call_sites"] = check_sites(tap)
    return out, counts


# every closed-form geometry class, in 2D and 3D where it exists:
# (name, class, arguments after the polarity)
GEOMETRY_CASES = [
    ("cube2d", "CubeGeometry", ([0.1, 0.2], [0.7, 0.6])),
    ("cube3d", "CubeGeometry", ([0.1, 0.2, 0.3], [0.7, 0.6, 0.8])),
    ("circle", "SphereGeometry", ([0.4, 0.45], 0.17)),
    ("sphere", "SphereGeometry", ([0.4, 0.45, 0.5], 0.17)),
    ("cylinder", "CylinderGeometry3D",
     ([[0.2, 0.2, 0.0], [0.2, 0.2, 0.41]], 0.05)),
    ("frustum", "CylinderGeometry3D",
     ([[0.1, 0.3, 0.2], [0.7, 0.5, 0.6]], [0.2, 0.05])),
    ("triangle", "TriangleGeometry", ([[0.1, 0.2], [0.8, 0.3],
                                       [0.4, 0.9]],)),
    ("tetrahedron", "TetrahedronGeometry3D",
     ([[0.1, 0.1, 0.1], [0.9, 0.2, 0.1], [0.3, 0.8, 0.2],
       [0.4, 0.4, 0.9]],)),
    ("prism", "PrismGeometry3D",
     ([[[0.1, 0.2, 0.1], [0.8, 0.3, 0.1], [0.4, 0.9, 0.1]],
       [[0.1, 0.2, 0.7], [0.8, 0.3, 0.7], [0.4, 0.9, 0.7]]],)),
    ("pyramid", "PyramidGeometry3D",
     ([(0.1, 0.1, 0.2), (0.9, 0.15, 0.2), (0.85, 0.9, 0.2), (0.2, 0.8, 0.2),
       (0.5, 0.5, 0.9)],)),
    ("airfoil", "GeometryCoordinates2D", (airfoil_polygon(),)),
]


def lattice_points(lower, upper, n: int, rng) -> list:
    """``n`` / 20 corner nodes of the unit lattice in the box at each of the
    levels 5-12, f32 (``c·h`` rounded once)."""
    parts = []
    for level in range(5, 13):
        h = np.float32(1.0 / 2 ** level)
        c = rng.integers(np.floor(lower / h), np.ceil(upper / h) + 1,
                         size=(n // 20, lower.size))
        parts.append((c * np.float64(h)).astype(np.float32))
    return parts


def geometry_points(g, n: int = 1_000_000, seed: int = 0) -> np.ndarray:
    """``n`` seeded f32 points around geometry ``g``'s bounding box: corner
    nodes of the unit lattice at levels 5-12 (``c·h`` rounded once), points
    within a few ulps of the surface (10 000 bisected in f64 between an
    inside and an outside sample, each moved by up to 4 ulps per axis in
    ``n`` / 50 000 copies), and uniform points."""
    rng = np.random.default_rng(seed)
    lower, upper = g.bounding_box()
    lower, upper = np.asarray(lower) - 0.05, np.asarray(upper) + 0.05
    d = lower.size
    parts = lattice_points(lower, upper, n, rng)
    p = rng.uniform(lower, upper, size=(200_000, d))
    m = g.mask_points(p)
    k = min(int(m.sum()), int((~m).sum()), 10_000)
    a, b = p[m][:k], p[~m][:k]
    for _ in range(60):
        mid = 0.5 * (a + b)
        mm = g.mask_points(mid)[:, None]
        a, b = np.where(mm, mid, a), np.where(mm, b, mid)
    near = a.astype(np.float32)
    for _ in range(max(1, n // 50_000)):
        steps = rng.integers(-4, 5, size=near.shape).astype(np.int32)
        parts.append((near.view(np.int32)
                      + np.where(near >= 0, steps, -steps)).view(np.float32))
    rest = n - sum(x.shape[0] for x in parts)
    parts.append(rng.uniform(lower, upper, size=(rest, d)).astype(np.float32))
    return np.concatenate(parts)


def phase_geometry_cuda_vs_cpu(tmp: str) -> dict:
    """Every closed-form geometry on the card against the CPU, bitwise,
    then a small grid with a cylinder obstacle and the 2:1 balance."""
    import sparsespatialsampling_torch as tpkg
    out = {"phase": "geometry_cuda_vs_cpu", "cases": {}}
    for name, cls, args in GEOMETRY_CASES:
        pts = geometry_points(getattr(tpkg, cls)("g", False, *args))
        d = pts.shape[1]
        # each of the first 125 000 points the first corner of a cell one
        # level-9 lattice step wide
        offs = np.stack(np.meshgrid(*([[0.0, 1.0]] * d), indexing="ij"),
                        -1).reshape(-1, d)
        nodes = (pts[:125_000, None, :].astype(np.float64)
                 + offs[None] / 2 ** 9).astype(np.float32)
        case = {"n_points": int(pts.shape[0]), "n_cells": nodes.shape[0]}
        for keep in (False, True):
            g = getattr(tpkg, cls)("g", keep, *args)
            got = {}
            for dev in ("cuda", "cpu"):
                p = torch.from_numpy(pts).to(dev)
                c = torch.from_numpy(nodes).to(dev)
                t0 = time.perf_counter()
                mask = g.mask_points(p)
                flags = [g.check_cells(c, r) for r in (False, True)]
                if dev == "cuda":
                    torch.cuda.synchronize()
                case[f"{dev}_s_keep_inside_{keep}"] = time.perf_counter() - t0
                got[dev] = [mask.cpu()] + [f.cpu() for f in flags]
            same = [torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"])]
            if not all(same):
                raise AssertionError(
                    f"geometry_cuda_vs_cpu: {name} (keep_inside={keep}) "
                    f"differs between the card and the CPU: mask, removal, "
                    f"surface equal {same}")
            case[f"inside_keep_inside_{keep}"] = int(got["cpu"][0].sum())
        out["cases"][name] = case
    out["bitwise_equal_cpu"] = True
    xyz, metric, bounds = cylinder_wake_3d(60_000, seed=2)
    geometries = [tpkg.CubeGeometry("domain", True, bounds[0], bounds[1]),
                  tpkg.CylinderGeometry3D(
                      "cylinder", False, [[0.2, 0.2, 0.0], [0.2, 0.2, 0.41]],
                      0.05, refine=True, min_refinement_level=6)]
    keys = {}
    for dev in ("cuda", "cpu"):
        s3, _, _, t, _ = run_grid(tmp, f"geo_{dev}", xyz, metric, geometries,
                                  device=dev, uniform_levels=4,
                                  n_cells_max=8000, max_delta_level=True)
        keys[dev] = grid_key(s3)
        out[f"grid_{dev}"] = case_summary(s3, t)
    out["grid"] = compare_grids("cylinder max_delta_level cuda and cpu",
                                keys["cuda"], keys["cpu"])
    return out


# the STL obstacle of bench workload 4: a closed lat-lon sphere
STL_CENTER = np.array([0.2, 0.2, 0.2])
STL_RADIUS = 0.05
# f32 operations per (point, triangle) pair of the winding number: 9
# differences, 3 norms of 6 (3 products, 2 sums, a root), the cross
# product's 9, four dot products of 5, denom's 8 (5 products, 3 sums), and
# the atan2 and the running sum counted as one each
WINDING_OPS_PER_PAIR = 66


def sphere_stl(path: str, n_lat: int = 180, n_lon: int = 144) -> int:
    """Write the closed sphere STL of ``bench.py:431-457`` (r 0.05 at
    (0.2, 0.2, 0.2): interior latitude rings as quad pairs, the poles as
    fans, the seam shared by index wrap) with the port's ``write_stl``;
    51 552 triangles by default, 5 664 at 60 x 48.  Returns the count."""
    from sparsespatialsampling_torch.geometry.stl import write_stl
    th = np.linspace(0.0, np.pi, n_lat + 1)[1:-1]
    ph = np.arange(n_lon) / n_lon * 2.0 * np.pi
    t, p = np.meshgrid(th, ph, indexing="ij")
    ring = (np.stack([STL_RADIUS * np.sin(t) * np.cos(p),
                      STL_RADIUS * np.sin(t) * np.sin(p),
                      STL_RADIUS * np.cos(t)], axis=-1)
            + STL_CENTER).astype(np.float32)
    nxt = np.roll(np.arange(n_lon), -1)
    top = (STL_CENTER + [0, 0, STL_RADIUS]).astype(np.float32)
    bot = (STL_CENTER - [0, 0, STL_RADIUS]).astype(np.float32)
    tris = [np.stack([np.broadcast_to(top, (n_lon, 3)),
                      ring[0], ring[0][nxt]], axis=1),
            np.stack([np.broadcast_to(bot, (n_lon, 3)),
                      ring[-1][nxt], ring[-1]], axis=1)]
    a, b = ring[:-1], ring[1:]
    tris.append(np.stack([a, b, b[:, nxt]], axis=2).reshape(-1, 3, 3))
    tris.append(np.stack([a, b[:, nxt], a[:, nxt]], axis=2).reshape(-1, 3, 3))
    tris = np.concatenate(tris)
    write_stl(path, tris)
    return tris.shape[0]


def stl_cloud():
    """The cloud of bench workload 4 (``bench.py:466-473``): 220 000
    uniform points (seed 2) minus the ball, the first 200 000 kept, and the
    metric ``exp(-max(r - 0.05, 0) / 0.1) + 0.01``."""
    bounds = [[0.0, 0.0, 0.0], [0.6, 0.4, 0.4]]
    rng = np.random.default_rng(2)
    xyz = rng.uniform(bounds[0], bounds[1], size=(220_000, 3))
    xyz = xyz[np.linalg.norm(xyz - STL_CENTER, axis=1) > STL_RADIUS][:200_000]
    r = np.linalg.norm(xyz - STL_CENTER, axis=1)
    metric = np.exp(-np.maximum(r - STL_RADIUS, 0) / 0.1) + 0.01
    return xyz, metric, bounds


def winding_points(tris: np.ndarray, m: int, seed: int) -> np.ndarray:
    """``m`` seeded f32 points, shuffled: a quarter uniform in the
    ``stl3d`` domain, half within 1e-4 of the sphere's radius, an eighth
    on triangle vertices and an eighth on triangle edges."""
    rng = np.random.default_rng(seed)
    n_u, n_v, n_e = m // 4, m // 8, m // 8
    n_s = m - n_u - n_v - n_e
    uniform = rng.uniform([0, 0, 0], [0.6, 0.4, 0.4], size=(n_u, 3))
    d = rng.normal(size=(n_s, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    shell = STL_CENTER + d * (STL_RADIUS
                              + rng.uniform(-1e-4, 1e-4, size=(n_s, 1)))
    t = rng.integers(0, tris.shape[0], size=n_v)
    verts = tris[t, rng.integers(0, 3, size=n_v)]
    t = rng.integers(0, tris.shape[0], size=n_e)
    j = rng.integers(0, 3, size=n_e)
    s = rng.uniform(size=(n_e, 1))
    edges = tris[t, j] + s * (tris[t, (j + 1) % 3] - tris[t, j])
    pts = np.concatenate([uniform, shell, verts, edges]).astype(np.float32)
    return pts[rng.permutation(m)]


def far_from_mesh(pts: np.ndarray, tris: np.ndarray,
                  margin: float = 1e-5) -> np.ndarray:
    """Whether each point lies farther than ``margin`` from every triangle
    of a mesh around ``STL_CENTER`` (any subset of the sphere's): beyond
    the farthest vertex's radius by more than ``margin``, or inside the
    nearest triangle plane's distance by more than ``margin``."""
    r_out = np.linalg.norm(tris.reshape(-1, 3) - STL_CENTER, axis=1).max()
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    r_in = np.abs(np.einsum("td,td->t", tris[:, 0] - STL_CENTER, n)).min()
    r = np.linalg.norm(pts.astype(np.float64) - STL_CENTER, axis=1)
    return (r > r_out + margin) | (r < r_in - margin)


def winding_bound(m: int, t: int):
    """Least time for ``m`` points' winding numbers over ``t`` triangles:
    points and vertices read once and ``w`` written once, against
    ``WINDING_OPS_PER_PAIR`` f32 operations per pair at the f32 rate.
    Returns ``(bound_ms, bound_by)``."""
    t_bytes = (m * 12 + t * 36 + m * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = WINDING_OPS_PER_PAIR * m * t / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_winding(p: torch.Tensor, count: int = None, tris: np.ndarray = None,
                  seed: int = 0, timed: bool = True) -> dict:
    """Kernel against its plain version on the card on CUDA points ``p``
    and the f32 triangles ``tris``: ``|Δw| ≤ 1e-4``, flags ``w > 0.5``
    equal at every point farther than 1e-5 from the mesh, and a shuffled
    batch and a prefix batch bitwise equal point for point; CUDA-graph
    device times.  With ``count`` the kernel gets the batch ``p`` and the
    count in device memory, as the STL test calls it: its first ``count``
    rows are held so (and against the kernel on those rows alone,
    bitwise), the rest must be 0; the times are the counted call's, its
    bound that of the ``count`` rows, the plain version's time that of
    the ``count`` rows alone."""
    from sparsespatialsampling_torch.ops import winding
    v = [torch.from_numpy(np.ascontiguousarray(tris[:, i], dtype=np.float32)
                          ).cuda() for i in range(3)]
    batch = p
    if count is not None:
        cnt = torch.tensor([count], dtype=torch.int32, device="cuda")
        got = winding.winding_number(batch, *v, count=cnt)
        p = batch[:count].contiguous()
        counted = {"batch_rows": int(batch.shape[0]), "count": count,
                   "bitwise_uncounted": count == 0 or torch.equal(
                       got[:count], winding.winding_number(p, *v)),
                   "zeros_past_count": bool((got[count:] == 0).all())}
        if not (counted["bitwise_uncounted"]
                and counted["zeros_past_count"]):
            raise AssertionError(f"winding_number with a count disagrees "
                                 f"with it on the rows below: {counted}")
        if count == 0:
            return {"shape": [0, tris.shape[0]], **counted}
    m, t = p.shape[0], tris.shape[0]
    w = winding.winding_number(p, *v)
    wp = winding.winding_number_plain(p, *v)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(m)).cuda()
    head = max(1, m // 3)
    same = (torch.equal(winding.winding_number(p[perm].contiguous(), *v),
                        w[perm])
            and torch.equal(winding.winding_number(p[:head].contiguous(), *v),
                            w[:head]))
    err = float((w - wp).abs().max())
    far = torch.from_numpy(far_from_mesh(p.cpu().numpy(), tris)).cuda()
    differ = (w > 0.5) != (wp > 0.5)
    res = {"shape": [m, t], "max_abs_err": err,
           "far_points": int(far.sum()),
           "flags_differ_far": int((differ & far).sum()),
           "flags_differ_near": int((differ & ~far).sum()),
           "batch_bitwise": same, "inside": int((w > 0.5).sum())}
    if not (err <= 1e-4 and res["flags_differ_far"] == 0 and same
            and bool(torch.isfinite(w).all())):
        raise AssertionError(f"winding_number kernel disagrees with its "
                             f"plain version: {res}")
    if count is not None:
        res.update(counted)
    if timed:
        bound, by = winding_bound(m, t)
        res.update(
            ms=(replay_ms(lambda i: winding.winding_number(p, *v), 10)
                if count is None else replay_ms(
                    lambda i: winding.winding_number(batch, *v, count=cnt),
                    10)),
            plain_ms=replay_ms(lambda i: winding.winding_number_plain(p, *v),
                               2),
            bound_ms=bound, bound_by=by, library_ms=None)
    return res


def winding_meshes(tmp: str) -> list:
    """``(path, triangles)`` of the 51 552-, 5 664- and 258 480-triangle
    spheres, written to ``tmp``; the last is the largest lat-lon sphere
    under ``_FW_MIN_TRIS``, so the exact route takes it."""
    from sparsespatialsampling_torch.geometry.stl import read_stl
    meshes = []
    for n_lat, n_lon, n_tri in ((180, 144, 51_552), (60, 48, 5_664),
                                (360, 360, 258_480)):
        path = os.path.join(tmp, f"sphere_{n_tri}.stl")
        if sphere_stl(path, n_lat, n_lon) != n_tri:
            raise AssertionError(f"sphere {n_lat}x{n_lon} is not {n_tri} "
                                 f"triangles")
        meshes.append((path, read_stl(path)))
    return meshes


# the rows of the batch the STL test hands the winding kernel inside an
# adaptive window of ``stl3d`` (256 selected cells' 8 children, 8 nodes
# each), whose near band is counted on the device
STL3D_WINDOW_ROWS = 16_384


def winding_cases(meshes: list) -> tuple:
    """``(triangles, points, seed, timed, count)`` of the
    ``winding_kernel`` cases: the ``stl3d`` mesh at the JAX package's
    near-band batch, at ``stl3d``'s median and largest near-band calls
    (as the batches of the compaction's old route, and in a window's
    batch with the count on the device, as the STL test calls it now), a
    large batch on the small sphere, a large mesh, and edge shapes (one
    point, and spans and point tiles left partly empty)."""
    (_, big), (_, small), (_, huge) = meshes
    rows = STL3D_WINDOW_ROWS
    return ((big, 1024, 0, True, None), (small, 16384, 1, True, None),
            (small[:1003], 1, 2, False, None),
            (small[:1025], 257, 3, False, None),
            (big, 15, 4, True, None), (big, 481, 5, True, None),
            (big, rows, 8, True, 15), (big, rows, 9, True, 481),
            (big, rows, 10, False, rows - 1), (huge, 1024, 6, True, None),
            (big[:40001], 999, 7, False, None))


def phase_winding_kernel(tmp: str) -> tuple:
    """The winding kernel against its plain version.  Returns the phase's
    line and the meshes of :func:`winding_meshes`."""
    from sparsespatialsampling_torch.ops import winding
    meshes = winding_meshes(tmp)
    cases = []
    for tris, m, seed, timed, count in winding_cases(meshes):
        p = torch.from_numpy(winding_points(tris, m, seed)).cuda()
        cases.append(check_winding(p, count, tris=tris, seed=seed,
                                   timed=timed))
    # a count of 0: every row 0, nothing evaluated
    empty = check_winding(p, 0, tris=tris)
    # the wrapper's slices of a batch whose partial sums exceed its scratch
    # bound: the last case's points, 64 a launch, bitwise the whole batch
    v = [torch.from_numpy(np.ascontiguousarray(tris[:, i], dtype=np.float32)
                          ).cuda() for i in range(3)]
    whole = winding.winding_number(p, *v)
    spans = winding._kernel_entry()[1](tris.shape[0])
    saved, before = winding._PART_BYTES, winding.launches
    winding._PART_BYTES = 8 * spans * 64
    try:
        sliced = winding.winding_number(p, *v)
    finally:
        winding._PART_BYTES = saved
    slices = {"shape": [m, tris.shape[0]], "points_a_launch": 64,
              "launches": winding.launches - before,
              "bitwise": torch.equal(sliced, whole)}
    if slices["launches"] != -(-m // 64) or not slices["bitwise"]:
        raise AssertionError(f"winding_number's slices differ: {slices}")
    return ({"phase": "winding_kernel",
             "ops_per_pair": WINDING_OPS_PER_PAIR, "cases": cases,
             "count_zero": empty, "slices": slices}, meshes)


class WindingCalls:
    """The winding-number calls of one scope (``name``): each eager call's
    batch and near-band count (a device copy, read after the run), the
    calls replayed in window graphs (``replays[name]``, kept by
    :class:`WindingTap`) and the launches both made (a batch larger than
    the kernel's scratch bound launches in slices)."""

    def __init__(self, name: str, replays: dict):
        self.name, self._replays = name, replays
        self.eager, self.eager_launches = [], 0

    def add(self, points: torch.Tensor, count, launches: int) -> None:
        self.eager.append((points, None if count is None else count.clone()))
        self.eager_launches += launches

    @property
    def replayed(self) -> int:
        return self._replays.get(self.name, 0)

    @property
    def launches(self) -> int:
        return self.eager_launches + self._replays.get(
            f"{self.name}:launches", 0)

    @property
    def calls(self) -> int:
        return len(self.eager) + self.replayed

    def sizes(self) -> list:
        """Near-band points of each eager call (read back)."""
        return [p.shape[0] if c is None else int(c) for p, c in self.eager]

    def largest(self) -> tuple:
        """``(batch, near-band points)`` of the eager call with the most."""
        sizes = self.sizes()
        i = int(np.argmax(sizes))
        return self.eager[i][0], sizes[i]

    def summary(self) -> dict:
        """The eager calls' near-band points, the calls replayed and the
        largest batch (the fixed-size compaction's rows)."""
        if not self.eager:
            return {"calls": 0, "calls_replayed": self.replayed}
        return {**size_summary(self.sizes()), "calls_replayed": self.replayed,
                "batch_rows_max": max(p.shape[0] for p, _ in self.eager)}


class WindingTap(GraphTap):
    """Records the winding-number calls of a main-path run (``all``), of
    its geometry-refinement phase (``geometry``:
    ``SamplingTree._refine_geometries``) and of the geometry loop's
    windows within it (``windows``: ``SamplingTree._run_geometry_window``);
    a call captured in a window's graph counts once for each replay."""

    def __init__(self):
        super().__init__()
        from sparsespatialsampling_torch.engine.tree import SamplingTree
        from sparsespatialsampling_torch.ops import winding
        self._winding, self._tree = winding, SamplingTree
        self._orig_wn = winding.winding_number
        self._orig_geo = SamplingTree._refine_geometries
        self._orig_win = SamplingTree.__dict__["_run_geometry_window"]
        self.all, self.geometry, self.windows = (
            WindingCalls(n, self.totals)
            for n in ("all", "geometry", "windows"))
        self._open = []

    def _scoped(self, calls: WindingCalls, run):
        """``run`` with the calls made inside it recorded in ``calls``."""
        def scoped(*args):
            self._open.append(calls)
            try:
                return run(*args)
            finally:
                self._open.remove(calls)
        return scoped

    def __enter__(self):
        super().__enter__()

        def tapped(points, v0, v1, v2, count=None):
            scopes = [self.all] + self._open
            before = self._winding.launches
            out = self._orig_wn(points, v0, v1, v2, count)
            n = self._winding.launches - before
            if self.capturing:
                for calls in scopes:
                    self.note({calls.name: 1, f"{calls.name}:launches": n})
            else:
                for calls in scopes:
                    calls.add(points, count, n)
            return out
        self._winding.winding_number = tapped
        self._tree._refine_geometries = self._scoped(self.geometry,
                                                     self._orig_geo)
        self._tree._run_geometry_window = staticmethod(
            self._scoped(self.windows, self._orig_win.__func__))
        return self

    def __exit__(self, *exc):
        self._winding.winding_number = self._orig_wn
        self._tree._refine_geometries = self._orig_geo
        self._tree._run_geometry_window = self._orig_win
        super().__exit__(*exc)


def size_summary(sizes: list) -> dict:
    sizes = np.asarray(sizes)
    return {"calls": int(sizes.size), "total": int(sizes.sum()),
            "min": int(sizes.min()), "median": float(np.median(sizes)),
            "max": int(sizes.max())}


def stl3d_case(stl_path: str):
    """Bench workload 4's grid (``bench.py:460-498``): ``(points, metric,
    geometries, grid arguments)`` and the wall of the STL geometry's
    build."""
    from sparsespatialsampling_torch import CubeGeometry, GeometrySTL3D
    xyz, metric, bounds = stl_cloud()
    t0 = time.perf_counter()
    stl = GeometrySTL3D("sphere", False, stl_path, refine=True,
                        min_refinement_level=6)
    t_stl = time.perf_counter() - t0
    return xyz, metric, [CubeGeometry("domain", True, bounds[0], bounds[1]),
                         stl], {"uniform_levels": 4,
                                "n_cells_max": 40_000}, t_stl


def phase_stl3d(tmp: str, stl_path: str) -> tuple:
    """Bench workload 4 (``bench.py:460-498``), not cut.  The winding
    kernel runs in the epochs and inside the geometry loop's windows; it
    is held against its plain version at the largest call of each."""
    xyz, metric, geometries, kw, t_stl = stl3d_case(stl_path)
    stl = geometries[1]
    with WindingTap() as wtap:
        s3, _, _, t, counts, tap, _ = main_path_run(
            "stl3d", tmp, "stl", xyz, metric, geometries,
            sites=("grid_select",), kernels=("grid_select", "winding_number"),
            **kw)
    if wtap.all.launches != counts["winding_number"]:
        raise AssertionError(f"stl3d: the winding calls' launches "
                             f"{wtap.all.launches} do not add up to the "
                             f"kernel's count {counts['winding_number']}")
    # on the default route the geometry phase's winding calls run inside
    # the loop's windows
    if not wtap.windows.launches and geometry_loop_on(kw):
        raise AssertionError(f"stl3d: the winding kernel launched no time "
                             f"inside the geometry loop's windows, route "
                             f"{t['geometry_route']}")
    out = {"phase": "stl3d", "n_points": int(xyz.shape[0]),
           "n_triangles": int(stl.triangles.shape[0]),
           "stl_build_s": t_stl, **grid_summary(s3, t),
           "launches": counts, "launches_per_site": dict(tap.launches),
           "winding_calls": wtap.all.calls,
           "winding_launches_geometry_phase": wtap.geometry.launches,
           "winding_launches_geometry_windows": wtap.windows.launches,
           "sign_grid": {"n_near_vox": stl._sg["n_near_vox"],
                         "n_vox": stl._sg["n_vox"]},
           "near_band_points_per_call": wtap.all.summary(),
           "near_band_points_per_geometry_call": wtap.geometry.summary()}
    check_expected("stl3d", out)
    out["kernel_at_call_sites"] = check_sites(tap)
    out["winding_at_largest_call"] = check_winding(
        *wtap.all.largest(), tris=stl.triangles, seed=4)
    if wtap.windows.eager:
        out["near_band_points_per_window_call"] = wtap.windows.summary()
        out["winding_at_largest_window_call"] = check_winding(
            *wtap.windows.largest(), tris=stl.triangles, seed=5)
    return out, counts


def stl_points(tris: np.ndarray, n: int = 1_000_000,
               seed: int = 0) -> np.ndarray:
    """``n`` seeded f32 points around the sphere STL ``tris``: corner
    nodes of the unit lattice at levels 5-12 (``lattice_points``), 5 000
    points on the mesh (barycentric in f64, rounded to f32), each moved by
    up to 4 ulps per axis, 5 000 within 1e-4 of the radius, and uniform
    points in the bounding box grown by 0.05."""
    rng = np.random.default_rng(seed)
    lower, upper = tris.reshape(-1, 3).min(0) - 0.05, \
        tris.reshape(-1, 3).max(0) + 0.05
    parts = lattice_points(lower, upper, n, rng)
    bary = rng.dirichlet([1.0, 1.0, 1.0], size=5_000)
    on = np.einsum("nk,nkd->nd", bary,
                   tris[rng.integers(0, tris.shape[0], 5_000)]).astype(np.float32)
    steps = rng.integers(-4, 5, size=on.shape).astype(np.int32)
    parts.append((on.view(np.int32)
                  + np.where(on >= 0, steps, -steps)).view(np.float32))
    parts.append(winding_points(tris, 5_000, seed + 1))
    rest = n - sum(x.shape[0] for x in parts)
    parts.append(rng.uniform(lower, upper, size=(rest, 3)).astype(np.float32))
    return np.concatenate(parts)


def phase_stl_cuda_vs_cpu(tmp: str, stl_path: str, tris: np.ndarray) -> dict:
    """The 5 664-triangle sphere STL on the card against the CPU: flags of
    both routes, then a small grid."""
    import sparsespatialsampling_torch as tpkg
    from sparsespatialsampling_torch.geometry import stl as tstl
    pts = stl_points(tris)
    rng = np.random.default_rng(1)
    offs = np.stack(np.meshgrid(*([[0.0, 1.0]] * 3), indexing="ij"),
                    -1).reshape(-1, 3)
    # 25 000 points, each the first corner of a cell one level-9 step wide
    nodes = (pts[rng.permutation(pts.shape[0])[:25_000], None, :]
             .astype(np.float64) + offs[None] / 2 ** 9).astype(np.float32)
    out = {"phase": "stl_cuda_vs_cpu", "n_points": int(pts.shape[0]),
           "n_cells": int(nodes.shape[0]), "routes": {}}
    saved = tstl._FW_MIN_TRIS
    for route, fw_min in (("exact", saved), ("fast_winding", 4096)):
        case = {}
        for keep in (False, True):
            tstl._FW_MIN_TRIS = fw_min
            try:
                g = tpkg.GeometrySTL3D("s", keep, stl_path)
            finally:
                tstl._FW_MIN_TRIS = saved
            if (g._fw is not None) != (route == "fast_winding"):
                raise AssertionError(f"stl_cuda_vs_cpu: {route} route not "
                                     f"taken")
            got = {}
            for dev in ("cuda", "cpu"):
                p = torch.from_numpy(pts).to(dev)
                c = torch.from_numpy(nodes).to(dev)
                t0 = time.perf_counter()
                mask = g.mask_points(p)
                flags = [g.check_cells(c, r) for r in (False, True)]
                if dev == "cuda":
                    torch.cuda.synchronize()
                case[f"{dev}_s_keep_inside_{keep}"] = time.perf_counter() - t0
                got[dev] = [mask.cpu()] + [f.cpu() for f in flags]
            same = [torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"])]
            if not all(same):
                raise AssertionError(
                    f"stl_cuda_vs_cpu: {route} (keep_inside={keep}) differs "
                    f"between the card and the CPU: mask, removal, surface "
                    f"equal {same}")
            case[f"inside_keep_inside_{keep}"] = int(got["cpu"][0].sum())
        out["routes"][route] = case
    out["flags_equal_cpu"] = True
    xyz, metric, bounds = stl_cloud()
    xyz, metric = xyz[:30_000], metric[:30_000]
    keys, states = {}, {}
    for dev in ("cuda", "cpu"):
        stl = tpkg.GeometrySTL3D("sphere", False, stl_path, refine=True,
                                 min_refinement_level=6, device=dev)
        states[dev] = stl._sg["state"]
        geometries = [tpkg.CubeGeometry("domain", True, bounds[0], bounds[1]),
                      stl]
        s3, _, _, t, _ = run_grid(tmp, f"stl_{dev}", xyz, metric, geometries,
                                  device=dev, uniform_levels=3,
                                  n_cells_max=6_000)
        keys[dev] = grid_key(s3)
        out[f"grid_{dev}"] = case_summary(s3, t)
    if not np.array_equal(states["cuda"], states["cpu"]):
        raise AssertionError("stl_cuda_vs_cpu: the sign grids built on the "
                             "card and on the CPU differ")
    out["grid"] = compare_grids("STL cuda and cpu", keys["cuda"], keys["cpu"])
    return out


def grid_rows(s3) -> tuple:
    """``(levels, centres, iterations, metric trace)`` in row order, which
    the export's face ids follow."""
    return (np.asarray(s3.levels).ravel(), np.asarray(s3.centers),
            s3.data_final_mesh["iterations"],
            np.asarray(s3.data_final_mesh["metric_per_iter"]))


def phase_geometry_loop_vs_host(tmp: str, stl_path: str) -> dict:
    """``oat2d`` (the polygon on the pre-select route), ``stl3d`` (the STL
    sphere: the winding kernel inside the loop) and ``mdl2d`` (the 2:1
    variant, ``GEO_MDL_LOOP``) at their published sizes with the geometry
    loop on and then off: ``DEVICE_LOOP = False`` for the first two (the
    JAX package's ``S3_TPU_DEVICE_LOOP=0``, which takes the adaptive host
    loop too), ``GEO_MDL_LOOP = False`` for ``mdl2d``.  Both grids pinned
    and identical row for row; each route's geometry wall and counters;
    the winding kernel against its plain version at the largest call of
    ``stl3d``'s geometry loop."""
    from sparsespatialsampling_torch.engine.tree import SamplingTree
    xy, metric, _, geometries, kw = mdl_case(250_000)
    cases = {"oat2d": (*oat2d_case(), "DEVICE_LOOP"),
             "stl3d": (*stl3d_case(stl_path)[:4], "DEVICE_LOOP"),
             "mdl2d": (xy, metric, geometries, kw, "GEO_MDL_LOOP")}
    out = {"phase": "geometry_loop_vs_host"}
    for name, (pts, metric, geoms, kw, switch) in cases.items():
        keys, res = {}, {"switch": switch}
        for loop in (True, False):
            route = "geometry_loop" if loop else "host_walk"
            saved = getattr(SamplingTree, switch)
            setattr(SamplingTree, switch, loop)
            try:
                with WindingTap() as wtap, \
                        SyncTap("_run_geometry_window") as sync:
                    s3, _, _, t, _ = run_grid(tmp, f"glh_{name}_{route}",
                                              pts, metric, geoms, **kw)
            finally:
                setattr(SamplingTree, switch, saved)
            info = s3.data_final_mesh
            rt = geometry_route(s3, sync)
            check_geometry_route(f"{name} ({route})", rt, loop)
            check_expected(name, {"n_cells": int(info["n_cells"]),
                                  "iterations": int(info["iterations"])})
            keys[loop] = grid_rows(s3)
            res[route] = {"wall_s_geometry": float(info["t_geometry"]),
                          "refine_total_s": t["refine"],
                          "geometry_route": rt}
            if loop and wtap.windows.eager:
                res[route].update(
                    winding_launches_geometry_phase=wtap.geometry.launches,
                    winding_launches_geometry_windows=wtap.windows.launches,
                    near_band_points_per_window_call=wtap.windows.summary(),
                    winding_at_largest_window_call=check_winding(
                        *wtap.windows.largest(), tris=geoms[1].triangles,
                        seed=6))
        res.update(compare_grids(f"{name}: geometry loop and host walk",
                                 keys[True], keys[False]))
        res["n_cells"], res["iterations"] = EXPECTED[name]
        out[name] = res
    return out


def host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def export_result(s3, exp, field, pts, snaps) -> dict:
    """What a sharded export is held to: the grid's rows, the export's
    weights and neighbours of the cell centres, its interpolated metric,
    and the interpolated ``[M, 1, S]`` field (again through
    ``ExportData.interpolate`` where the export wrote HDF5)."""
    if field is None:
        field = exp.interpolate(pts, snaps[0][:, None, :])
    return {"rows": grid_rows(s3), "field": np.asarray(field),
            "w": host(exp._w_centers), "idx": host(exp._idx_centers),
            "metric": np.asarray(exp._metric)}


def jax_sharded_weights(pts, q, idx) -> np.ndarray:
    """The JAX package's sharded inverse-distance weights
    (``parallel/knn.py:237-285``) of the neighbours ``idx``, in numpy: the
    cloud cast to f32 and centred on its f32 mean, the queries alike."""
    p32 = np.asarray(pts, dtype=np.float32)
    shift = p32.mean(axis=0)
    delta = (np.asarray(q, dtype=np.float32) - shift)[:, None, :] - (
        p32 - shift)[idx]
    w = 1.0 / np.clip(np.sqrt(np.maximum((delta * delta).sum(-1), 0.0)),
                      1e-12, None)
    return w / w.sum(axis=1, keepdims=True)


class VirtualMesh:
    """``parallel.mesh.VIRTUAL_SHARDS`` set to ``shards`` (a count of
    shards on the card, or a list of devices) inside a ``with`` block."""

    def __init__(self, shards):
        self.shards = shards

    def __enter__(self):
        from sparsespatialsampling_torch.parallel import mesh
        self._mesh, self._saved = mesh, mesh.VIRTUAL_SHARDS
        mesh.VIRTUAL_SHARDS = self.shards
        return self

    def __exit__(self, *exc):
        self._mesh.VIRTUAL_SHARDS = self._saved


def large_case():
    """Bench workload 6 (``bench.py:501-527``, the reference's
    ``examples/s3_synthetic_large_scale.py`` configuration) at its own
    size: 2 000 000 points (seed 0) in [4, 1, 1] with its metric, a
    ``CubeGeometry`` domain, ``uniform_levels=4``, ``n_cells_max=200_000``,
    ``n_cells_iter_start=2000``.  ``(points, metric, geometries, grid
    arguments)``."""
    from sparsespatialsampling_torch import CubeGeometry
    rng = np.random.default_rng(0)
    xyz = rng.uniform([0, 0, 0], [4, 1, 1],
                      size=(2_000_000, 3)).astype(np.float32)
    metric = (np.exp(-np.maximum(xyz[:, 0] - 0.5, 0))
              * np.exp(-((xyz[:, 1] - 0.5) ** 2
                         + (xyz[:, 2] - 0.5) ** 2) / 0.1)
              + 0.01).astype(np.float64)
    return (xyz, metric, [CubeGeometry("domain", True, [0, 0, 0], [4, 1, 1])],
            {"uniform_levels": 4, "n_cells_max": 200_000,
             "n_cells_iter_start": 2000})


def sharded_summary(s3, t, counts, tap) -> dict:
    """A sharded run's line: the grid summary, the launches per call site
    and what the escalation to the sharded full scan cost."""
    st = s3.data_final_mesh["epoch_stats"]
    return {**grid_summary(s3, t), "launches": counts,
            "launches_per_site": dict(tap.launches),
            "escalated_to_sharded_full_scan": {
                "cells": int(st["full_scan_cells"]),
                "passes": int(st["n_calls_full"]),
                "wall_s": float(st["t_retry_s"])}}


def check_core(case: str, out: dict, core: str) -> None:
    if out["epoch_core"] != core:
        raise AssertionError(f"{case}: the epochs ran the {out['epoch_core']}"
                             f" core, not {core}")


def case_large(tmp: str) -> tuple:
    """Workload 6 on one device, then over 4 shards on the card: rows,
    iterations and the metric trace equal, the sharded run on the
    ``shard_grid`` core.  Returns the case's line and its runs' taps."""
    from sparsespatialsampling_torch.engine.tree import SamplingTree
    xyz, metric, geometries, kw = large_case()

    def peaks() -> dict:
        """The run's peak device memory: allocated tensors, and reserved
        (the graphs' pool too, whose blocks count as allocated only
        while a capture holds them)."""
        return {"peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s3, _, _, t, counts, tap1, _ = main_path_run(
        "large_single", tmp, "large1", xyz, metric, geometries,
        sites=("grid_select",), **kw)
    single = {**grid_summary(s3, t), "launches": counts,
              "launches_per_site": dict(tap1.launches), **peaks()}
    rows = grid_rows(s3)
    del s3
    torch.cuda.empty_cache()
    # the same run with the loop bodies eager: its peak and walls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    SamplingTree._LOOP_GRAPHS = False
    try:
        s3, _, _, t, _ = run_grid(tmp, "large1e", xyz, metric, geometries,
                                  **kw)
    finally:
        SamplingTree._LOOP_GRAPHS = True
    eager = {**peaks(), "refine_total": t["refine"],
             "t_window_s": float(
                 s3.data_final_mesh["adaptive_split"]["t_window"]),
             "adaptive_route": adaptive_route(s3),
             **compare_bitwise("large_single: graphs and eager body", rows,
                               grid_rows(s3))}
    del s3
    torch.cuda.empty_cache()
    with VirtualMesh(4):
        s3, _, _, t, counts, tap4, _ = main_path_run(
            "large_sharded", tmp, "large4", xyz, metric, geometries,
            sites=("shard_grid_select",), mesh=True, **kw)
    sharded = sharded_summary(s3, t, counts, tap4)
    check_core("large_sharded", sharded, "shard_grid")
    out = {"case": "large", "n_points": int(xyz.shape[0]), "shards": 4,
           "jax_recorded_cells": LARGE_JAX_CELLS,
           "jax_recorded_source": "BENCH_r05.json (large_n_cells)",
           "port_cells": {"single": single["n_cells"],
                          "sharded": sharded["n_cells"]},
           "pin": {"cells": LARGE_PIN[0], "iterations": LARGE_PIN[1]},
           "wall_s_refine_total": {
               "single": single["wall_s"]["refine_total"],
               "sharded": sharded["wall_s"]["refine_total"]},
           "single": single, "single_eager_body": eager,
           "sharded": sharded,
           **compare_routes("large: single device and 4 shards", rows,
                            grid_rows(s3))}
    del s3
    torch.cuda.empty_cache()
    check_expected("large_single", single)
    check_expected("large_sharded", sharded)
    return out, [tap4], {"large_single": single["launches"],
                         "large_sharded": counts}


def case_oat2d_sharded(tmp: str, oat_ref: dict) -> tuple:
    """``oat2d`` over 3 shards (its 245 000 points pad to a multiple of
    3): the pins, rows identical to ``oat2d``'s, and the 50 snapshots
    through the sharded index and ``sharded_interpolate``: the neighbours
    bitwise ``oat2d``'s, the weights the JAX package's sharded weights
    (:func:`jax_sharded_weights`), the metric and the fields the host
    route's formulas on them, bit for bit."""
    from sparsespatialsampling_torch.parallel import ShardedKNNIndex
    xy, metric, geometries, kw = oat2d_case()
    snaps = bench_snapshots(metric)
    with VirtualMesh(3):
        s3, exp, field, t, counts, tap, _ = main_path_run(
            "oat2d_sharded", tmp, "oat3", xy, metric, geometries,
            export=snaps, sites=("shard_grid_select",), mesh=True, **kw)
    out = {"case": "oat2d_sharded", "n_points": int(xy.shape[0]),
           "shards": 3, **sharded_summary(s3, t, counts, tap),
           **export_summary("oat2d_sharded", exp, t, prefetch="built")}
    check_expected("oat2d_sharded", out)
    check_core("oat2d_sharded", out, "shard_grid")
    if out["captured_metric"] != OAT2D_CAPTURED:
        raise AssertionError(f"oat2d_sharded: captured "
                             f"{out['captured_metric']!r}, not "
                             f"{OAT2D_CAPTURED!r}")
    if not (isinstance(exp._knn, ShardedKNNIndex) and exp._mesh.size == 3):
        raise AssertionError("oat2d_sharded: the export did not index the "
                             "cloud over the 3-shard mesh")
    from sparsespatialsampling_torch.ops.interpolate import interpolate_host
    got = export_result(s3, exp, field, xy, snaps)
    out.update(compare_routes("oat2d: single device and 3 shards",
                              got["rows"], oat_ref["rows"]))
    # the mesh's neighbours are oat2d's; its weights the JAX package's
    # sharded weights, its metric the f64 host sum over them, and its
    # fields (contracted on the card) the host route's CSR product of them
    w, idx = got["w"], got["idx"]
    same = {"idx_oat2d": bool(np.array_equal(idx, oat_ref["idx"])),
            "w_jax_sharded_formula": bool(np.array_equal(
                w, jax_sharded_weights(xy, s3.centers, idx))),
            "metric_host_sum": bool(np.array_equal(
                got["metric"], (w * metric[idx]).sum(axis=1))),
            "field_host_contraction": bool(np.array_equal(
                got["field"], interpolate_host(w, idx,
                                               snaps[0][:, None, :])))}
    if not all(same.values()):
        raise AssertionError(f"oat2d_sharded: the export is not the JAX "
                             f"package's mesh export: bitwise equal {same}")
    out["export_bitwise"] = same
    # against oat2d's (the single device's cloud is centred in f64): the
    # largest difference over the largest value
    out["export_vs_oat2d_max_rel"] = {
        key: float(np.abs(got[key] - oat_ref[key]).max()
                   / np.abs(oat_ref[key]).max())
        for key in ("w", "metric", "field")}
    return out, [tap], {"oat2d_sharded": counts}


def case_svd_distributed() -> dict:
    """``svd_routes``' planted matrix through ``compute_svd(rank=None)``
    with 4 shards on the card: it must take ``distributed_rsvd`` and the
    sketched rank; the top four values to rtol 1e-2 of the planted
    spectrum and of ``economy_svd``, subspace cosines ≥ 0.999;
    ``distributed_rsvd(rank=20)`` on the card against the CPU's (the
    same sketch over 4 CPU shards), ``s`` to rtol 1e-4.  Walls beside the
    single-device route's on the same matrix, two calls of each in turns
    (single, sharded, sharded, single)."""
    from sparsespatialsampling_torch import compute_svd
    from sparsespatialsampling_torch.ops.svd import economy_svd
    from sparsespatialsampling_torch.parallel import (distributed_rsvd,
                                                      make_mesh)
    a, u0, v0 = planted_matrix()
    ones = np.ones(a.shape[0], dtype=np.float32)
    walls = {"compute_svd_auto_single_device": [],
             "compute_svd_auto_4_shards": []}
    for shards in (None, 4, 4, None):
        key = ("compute_svd_auto_4_shards" if shards else
               "compute_svd_auto_single_device")
        with VirtualMesh(shards), SvdTap() as one:
            t0 = time.perf_counter()
            res = compute_svd(a, ones)
            walls[key].append(time.perf_counter() - t0)
        if shards:
            s, u, v = res
            tap = one
        else:
            single_tap = one
    if (tap.calls.get("distributed_rsvd") != 1
            or tap.calls.get("sketched_rank") != 1
            or "randomized_svd" in tap.calls or "economy_svd" in tap.calls
            or single_tap.calls.get("randomized_svd") != 1):
        raise AssertionError(f"compute_svd took the routes {tap.calls} over "
                             f"4 shards and {single_tap.calls} on one "
                             f"device")
    k = len(PLANTED)
    u_e, s_e, v_e = economy_svd(a)
    cos = {"planted_u": subspace_cosines(u[:, :k], u0).min(),
           "planted_v": subspace_cosines(v[:, :k], v0).min(),
           "economy_u": subspace_cosines(u[:, :k], u_e[:, :k]).min(),
           "economy_v": subspace_cosines(v[:, :k], v_e[:, :k]).min()}
    rel = {"planted": np.abs(s[:k] / np.asarray(PLANTED) - 1).max(),
           "economy": np.abs(s[:k] / s_e[:k] - 1).max()}
    if s.shape[0] < k or max(rel.values()) > 1e-2 or min(cos.values()) < 0.999:
        raise AssertionError(f"svd_distributed: {s.shape[0]} values, top "
                             f"{k} off by {rel}, subspace cosines {cos}")
    with VirtualMesh(4):
        walls["distributed_rsvd_rank20"] = []
        for _ in range(2):
            t0 = time.perf_counter()
            _, s_card, _ = distributed_rsvd(a, 20, make_mesh(device="cuda"))
            walls["distributed_rsvd_rank20"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _, s_cpu, _ = distributed_rsvd(a.cpu(), 20, make_mesh(device="cpu"))
        walls["distributed_rsvd_rank20_cpu"] = time.perf_counter() - t0
    err = float(np.abs(s_card / s_cpu - 1).max())
    if err > 1e-4:
        raise AssertionError(f"distributed_rsvd(rank=20) on the card differs "
                             f"from the CPU's by {err:.3e} (relative)")
    return {"case": "svd_distributed", "shape": list(a.shape), "shards": 4,
            "routes": tap.calls, "routes_single_device": single_tap.calls,
            "sketched_rank": int(s.shape[0]), "s_top": s[:k + 1].tolist(),
            "max_rel_err_top4": {key: float(v) for key, v in rel.items()},
            "min_subspace_cos": {key: float(v) for key, v in cos.items()},
            "rank20_s_max_rel_err_vs_cpu": err, "wall_s": walls,
            "split_s": tap.seconds}


def case_mixed_mesh(tmp: str, cmp_rows: tuple) -> tuple:
    """The ``cuda_vs_cpu`` case over the mesh ``[cuda:0, cpu]``: every
    shard operation crosses devices by an explicit move or raises; rows
    and iterations equal ``cuda_vs_cpu``'s card run."""
    xyz, metric, geometries, kw = compare_case()
    with VirtualMesh([torch.device("cuda", 0), torch.device("cpu")]):
        s3, _, _, t, counts, tap, _ = main_path_run(
            "mixed_mesh", tmp, "mixed", xyz, metric, geometries,
            sites=("shard_grid_select",), mesh=True, **kw)
    out = {"case": "mixed_mesh", "mesh": ["cuda:0", "cpu"],
           "n_points": int(xyz.shape[0]),
           **sharded_summary(s3, t, counts, tap),
           **compare_routes("mixed mesh and cuda_vs_cpu", grid_rows(s3),
                            cmp_rows)}
    check_core("mixed_mesh", out, "shard_grid")
    return out, [tap], {"mixed_mesh": counts}


def phase_sharded(tmp: str, oat_ref: dict, cmp_rows: tuple) -> tuple:
    """The multi-device layer over virtual meshes of the card.  Returns
    the phase's line, each sharded call site's largest input checked and
    timed, and the launches of each case's main-path runs."""
    out, taps, counts = {"phase": "sharded"}, [], {}
    t0 = time.perf_counter()
    for key, run in (("large", lambda: case_large(tmp)),
                     ("oat2d_sharded", lambda: case_oat2d_sharded(tmp,
                                                                  oat_ref)),
                     ("mixed_mesh", lambda: case_mixed_mesh(tmp, cmp_rows))):
        t1 = time.perf_counter()
        out[key], case_taps, case_counts = run()
        out[key]["case_wall_s"] = time.perf_counter() - t1
        taps += case_taps
        counts.update(case_counts)
    t1 = time.perf_counter()
    out["svd_distributed"] = case_svd_distributed()
    out["svd_distributed"]["case_wall_s"] = time.perf_counter() - t1
    launches = {site: sum(tap.launches.get(site, 0) for tap in taps)
                for site in SHARD_SITES}
    missing = [site for site, n in launches.items() if not n]
    if missing:
        raise AssertionError(f"sharded: call sites never launched: {missing}")
    out["launches_per_sharded_site"] = launches
    # each site's largest input over the sharded runs (the taps hold
    # references), checked and timed after the runs
    largest = {}
    for tap in taps:
        for site, held in tap.inputs.items():
            if site in SHARD_SITES and (
                    site not in largest
                    or work_of(*held[:2]) > work_of(*largest[site][:2])):
                largest[site] = held
    sites = {site: {**check_site(*held), "launches": launches[site]}
             for site, held in sorted(largest.items())}
    out["kernel_at_call_sites"] = sites
    out["phase_wall_s"] = time.perf_counter() - t0
    return out, counts


# ``min_metric`` of each run of ``examples/s3_for_OAT15_airfoil.py:63-72``
SWEEP = (0.25, 0.5, 0.75)


def sweep_case():
    """The example's sweep on the ``oat2d`` cloud: ``uniform_levels=5``,
    the airfoil refined to level 8, ``pre_select_cells``; the geometries
    made anew for each run, as the example makes them.  ``(points,
    metric, geometries factory, grid arguments)``."""
    from sparsespatialsampling_torch import (CubeGeometry,
                                             GeometryCoordinates2D)
    xy, metric, poly = synthetic_oat15()

    def geometries():
        return [CubeGeometry("domain", True, [-0.5, -0.5], [1.5, 0.5]),
                GeometryCoordinates2D("airfoil", False, poly, refine=True,
                                      min_refinement_level=8)]
    return xy, metric, geometries, {"uniform_levels": 5,
                                    "pre_select_cells": True}


def reuse_line(s3, t, tree, counts, reused: bool) -> dict:
    info = s3.data_final_mesh
    return {"n_cells": int(info["n_cells"]),
            "iterations": int(info["iterations"]),
            "captured_metric": float(info["metric_per_iter"][-1]),
            "init": t["init"], "knn_build": float(info["t_knn_build"]),
            "refine_total": t["refine"], "epoch_core": tree._epoch_stats[
                "core"], "index_reused": reused, "launches": counts}


def phase_index_reuse(tmp: str) -> tuple:
    """The engine's size-1 kNN index cache (``engine/tree.py``,
    ``_KNN_INDEX_CACHE``) on the card: the ``oat2d`` cloud swept over
    ``min_metric`` 0.25, 0.5 and 0.75 as the reference's example sweeps
    it, one index for the three runs, the warm 0.75 run row for row and
    bitwise a cold one; bench workload 6's single-device tree built cold
    and then warm, the warm run at its pinned cells and iterations; and
    the key's device and policy: the same cloud on the card and on the
    CPU gives two indices, and ``KNNIndex.DIL_MAX_BYTES`` changed gives
    a rebuild.  Every grid run is a main-path run.  The cache is empty
    when the phase ends.  Returns the phase's line and the launches of
    the warm runs."""
    from sparsespatialsampling_torch import SparseSpatialSampling
    from sparsespatialsampling_torch.ops.knn import KNNIndex
    out, counts_of = {"phase": "index_reuse"}, {}
    t0 = time.perf_counter()
    try:
        xy, metric, geometries, kw = sweep_case()
        clear_index_cache()
        index, runs = None, []
        for m in SWEEP:
            s3, _, _, t, counts, _, tree = main_path_run(
                f"index_reuse_{m}", tmp, f"sw{m}", xy, metric, geometries(),
                sites=("grid_select",), warm=True, min_metric=m, **kw)
            reused = tree._knn is index
            if reused != (index is not None):
                raise AssertionError(f"index_reuse: min_metric {m} "
                                     f"{'reused' if reused else 'rebuilt'} "
                                     f"the index")
            index = tree._knn
            runs.append({"min_metric": m,
                         **reuse_line(s3, t, tree, counts, reused)})
            warm_rows = grid_rows(s3)
            del s3, tree
        counts_of["index_reuse_sweep"] = counts
        out["sweep"] = runs
        s3, _, _, t, counts, _, tree = main_path_run(
            "index_reuse_cold", tmp, "swc", xy, metric, geometries(),
            sites=("grid_select",), min_metric=SWEEP[-1], **kw)
        if tree._knn is index:
            raise AssertionError("index_reuse: the cold run reused the index")
        out["cold"] = {"min_metric": SWEEP[-1],
                       **reuse_line(s3, t, tree, counts, False),
                       **compare_bitwise("index_reuse: the warm and the cold "
                                         f"min_metric {SWEEP[-1]} runs",
                                         warm_rows, grid_rows(s3))}
        del s3, tree, index

        # workload 6 on one device: built cold, then the warm run
        xyz, lmetric, lgeoms, lkw = large_case()
        clear_index_cache()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s3 = SparseSpatialSampling(xyz, lmetric, lgeoms, save_path=tmp,
                                   save_name="lr0", device="cuda", **lkw)
        torch.cuda.synchronize()
        index = s3._sampling._knn
        cold = {"init": time.perf_counter() - t1,
                "knn_build": float(s3._sampling._times["t_knn_build"])}
        del s3
        s3, _, _, t, counts, _, tree = main_path_run(
            "index_reuse_large", tmp, "lr1", xyz, lmetric, lgeoms,
            sites=("grid_select",), warm=True, **lkw)
        warm = {**reuse_line(s3, t, tree, counts, tree._knn is index),
                "adaptive_route": t["adaptive_route"]}
        if not warm["index_reused"]:
            raise AssertionError("index_reuse: workload 6's second tree "
                                 "rebuilt its index")
        check_expected("large_single", warm)
        counts_of["index_reuse_large"] = counts
        out["large_single"] = {"n_points": int(xyz.shape[0]), "cold": cold,
                               "warm": warm}
        del s3, tree, index, xyz
        clear_index_cache()
        torch.cuda.empty_cache()

        # the key: the device, then the dilated layout's budget
        cxyz, cmetric, cgeoms, ckw = compare_case()

        def built(dev):
            s3 = SparseSpatialSampling(cxyz, cmetric, cgeoms, save_path=tmp,
                                       save_name="key", device=dev, **ckw)
            return s3._sampling._knn
        card, cpu = built("cuda"), built("cpu")
        card2, card3 = built("cuda"), built("cuda")
        budget = KNNIndex.DIL_MAX_BYTES
        KNNIndex.DIL_MAX_BYTES = 0
        try:
            blocked = built("cuda")
        finally:
            KNNIndex.DIL_MAX_BYTES = budget
        dilated = built("cuda")
        key = {"cuda_then_cpu_two_indices": cpu is not card,
               "cpu_index_device": str(cpu.device),
               "cuda_after_cpu_rebuilt": card2 is not card,
               "cuda_again_reused": card3 is card2,
               "dil_max_bytes_0_rebuilt": (blocked is not card3
                                           and "dil_pts" not in blocked._grid),
               "dil_max_bytes_restored_rebuilt": (
                   dilated is not blocked and "dil_pts" in dilated._grid)}
        if not all(v for k, v in key.items() if k != "cpu_index_device") \
                or key["cpu_index_device"] != "cpu":
            raise AssertionError(f"index_reuse: the key failed: {key}")
        out["key"] = {"n_points": int(cxyz.shape[0]), **key}
        del card, cpu, card2, card3, blocked, dilated
    finally:
        clear_index_cache()
    out["phase_wall_s"] = time.perf_counter() - t0
    return out, counts_of


def winding_entry(cases: list, stl: dict, counts_stl: dict) -> dict:
    """The ``kernels`` line's entry of ``winding_number``: the top-level
    times are at [1024, 51552], the ``stl3d`` mesh at the JAX package's
    near-band batch; ``cases`` holds every timed shape, the largest
    near-band batches of the ``stl3d`` run and of its geometry loop's
    windows included."""
    geo = stl["winding_at_largest_window_call"]
    checks = cases + [geo, stl["winding_at_largest_call"]]
    timed = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def name(c):
        """``MxT``, or ``CofBxT`` for C counted rows of a batch of B."""
        m, t = c["shape"]
        return (f"{m}x{t}" if "count" not in c else
                f"{m}of{c['batch_rows']}x{t}")
    return {
        "name": "winding_number", "route": "cuda",
        "source": "sparsespatialsampling_torch/csrc/winding_number.cu",
        "replaces": "sparsespatialsampling_tpu/geometry/stl.py:129",
        "replaces_what": "_omega and _winding_number (:312), an XLA "
                         "program, not a Pallas kernel",
        "launches": counts_stl["winding_number"],
        "launches_stl3d": counts_stl["winding_number"],
        "launches_stl3d_geometry_phase": stl[
            "winding_launches_geometry_phase"],
        "launches_stl3d_geometry_windows": stl[
            "winding_launches_geometry_windows"],
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "flags_differ_far": sum(c["flags_differ_far"] for c in checks),
        "flags_differ_near": sum(c["flags_differ_near"] for c in checks),
        "batch_bitwise": all(c["batch_bitwise"] for c in checks),
        "ops_per_pair": WINDING_OPS_PER_PAIR,
        **{key: cases[0][key] for key in timed},
        "cases": {("stl3d_largest_call" if c is checks[-1] else
                   "stl3d_largest_geometry_window_call" if c is geo else
                   name(c)):
                  {key: c[key] for key in timed + ("batch_rows",)
                   if key in c}
                  for c in checks if "ms" in c}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script runs the "
              "port on the card and has no CPU mode.", file=sys.stderr)
        return 2
    from sparsespatialsampling_torch import _build

    smi = nvidia_smi_line()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})
    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()},
          "sass": sass_counts()})

    tmp = tempfile.mkdtemp(prefix="s3_smoke_")
    try:
        kernel = phase_kernel()
        emit(kernel)
        grid_kernel = phase_grid_select_kernel()
        emit(grid_kernel)
        emit(phase_full_scan())
        grid3d, counts3d = phase_grid3d(tmp)
        emit(grid3d)
        grid2d, counts2d = phase_grid2d_metric(tmp)
        emit(grid2d)
        rescue, counts_rescue = phase_rescue_modes(tmp)
        emit(rescue)
        cmp, cmp_rows, cmp_grids = phase_cuda_vs_cpu(tmp)
        emit(cmp)
        emit(phase_export_routes(cmp_grids))
        del cmp_grids
        blocked, counts_blk = phase_blocked_layout(tmp)
        emit(blocked)
        emit(phase_large_k())
        emit({"phase": "matmul_precision", **check_matmul_precision()})
        oat, counts_oat, oat_ref = phase_oat2d(tmp)
        emit(oat)
        cyl, counts_cyl = phase_cylinder3d(tmp)
        emit(cyl)
        mdl, counts_mdl = phase_mdl2d(tmp)
        emit(mdl)
        mdl25k, counts_mdl25k = phase_mdl2d_25k(tmp)
        emit(mdl25k)
        emit(phase_svd_routes())
        c2d, counts_c2d = phase_c2d_reltol(tmp)
        emit(c2d)
        emit(phase_geometry_cuda_vs_cpu(tmp))
        wk, ((big_path, _), (small_path, small), _) = \
            phase_winding_kernel(tmp)
        emit(wk)
        stl, counts_stl = phase_stl3d(tmp, big_path)
        emit(stl)
        emit(phase_device_loop_vs_host(tmp, big_path))
        emit(phase_stl_cuda_vs_cpu(tmp, small_path, small))
        emit(phase_geometry_loop_vs_host(tmp, big_path))
        sharded, counts_sharded = phase_sharded(tmp, oat_ref, cmp_rows)
        emit(sharded)
        reuse, counts_reuse = phase_index_reuse(tmp)
        emit(reuse)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # every number below was measured in this run.  topk_smallest: the
    # top-level times are those at the grid3d full-scan tile, the call site
    # with the most work, and "sites" holds each of its call sites' largest
    # main-path input; grid_select: the top-level times are those at the
    # grid3d ring pass, and "sites" holds each grid call site's largest
    # main-path input (the blocked layout's from the blocked_layout run, a
    # shard's from the sharded phase) and "cases" the kernel phase's
    sites3d = grid3d["kernel_at_call_sites"]
    sites = {**sites3d,
             BLOCKED: blocked["kernel_at_call_sites"][BLOCKED],
             **sharded["kernel_at_call_sites"]}
    phases = {"grid3d": (grid3d, counts3d), "grid2d_metric": (grid2d, counts2d),
              "blocked_layout": (blocked, counts_blk), "oat2d": (oat, counts_oat),
              "cylinder3d": (cyl, counts_cyl), "mdl2d": (mdl, counts_mdl),
              "mdl2d_25k": (mdl25k, counts_mdl25k),
              "c2d_reltol": (c2d, counts_c2d), "stl3d": (stl, counts_stl),
              "sharded": (sharded, None)}
    at_sites = [c for phase, _ in phases.values()
                for c in phase["kernel_at_call_sites"].values()]

    def launches(kernel):
        return {**{f"launches_{name}": counts[kernel]
                   for name, (_, counts) in phases.items() if counts},
                **{f"launches_{case}": c[kernel]
                   for case, c in {**counts_sharded, **counts_rescue,
                                   **counts_reuse}.items()}}

    def site_lines(kernel, keys):
        return {site: {key: c[key] for key in keys + ("launches", "run_stats")
                       if key in c}
                for site, c in sites.items() if KERNEL_OF[site] == kernel}
    topk_checks = kernel["cases"] + [c for c in at_sites if "entry" not in c]
    grid_checks = (list(grid_kernel["cases"].values())
                   + [c for c in at_sites if "entry" in c])
    timed = ("shape", "k", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    grid_timed = timed + ("unfused_ms", "bound_rows_ms", "bound_rows_by")
    epoch = kernel["cases"][0]
    emit({"kernels": [{
        "name": "topk_smallest", "route": "cuda",
        "source": "sparsespatialsampling_torch/csrc/topk_smallest.cu",
        "replaces": "sparsespatialsampling_tpu/ops/pallas_topk.py:62",
        "launches": counts3d["topk_smallest"], **launches("topk_smallest"),
        "launches_route": "device loop, blocked_layout's the host loop",
        "bitwise_equal_plain": all(c["bitwise_equal_plain"]
                                   for c in topk_checks),
        "max_abs_err": max(c["max_abs_err"] for c in topk_checks),
        **{key: sites3d["full_scan_tile"][key] for key in timed},
        "sites": site_lines("topk_smallest", timed),
        "epoch_shape": {key: epoch[key] for key in timed}}, {
        "name": "grid_select", "route": "cuda",
        "source": "sparsespatialsampling_torch/csrc/grid_select.cu",
        "replaces": "sparsespatialsampling_tpu/ops/knn.py:593",
        "replaces_what": "_dilated_select (:593), _grid_candidates (:317) + "
                         "_topk_canonical (:341) of _grid_query_kernel "
                         "(:360), and the ring's do_ring "
                         "(engine/tree.py:1124-1163): XLA programs the JAX "
                         "package fuses, not Pallas kernels",
        "launches": counts3d["grid_select"], **launches("grid_select"),
        "launches_route": "device loop, blocked_layout's the host loop",
        "bitwise_equal_plain": all(c["bitwise_equal_plain"]
                                   for c in grid_checks),
        "max_abs_err": max(c["max_abs_err"] for c in grid_checks),
        **{key: sites3d[RING][key] for key in grid_timed},
        "sites": site_lines("grid_select", grid_timed),
        "cases": {name: {key: c[key] for key in grid_timed if key in c}
                  for name, c in grid_kernel["cases"].items() if "ms" in c}},
        winding_entry(wk["cases"], stl, counts_stl)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
