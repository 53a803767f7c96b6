"""Times builds of ``grid_select``'s two entries on one card, side by side.

    python3 grid_select_compare.py OLD.cu [NEW.cu]   # OLD against NEW (default csrc/grid_select.cu)
    python3 grid_select_compare.py --ablate SRC.cu [blocked|dilated]
                                                     # SRC with parts of an entry's path cut

Every source must export the C entry points ``grid_select_blocked_f32``
and ``grid_select_dilated_f32`` of ``sparsespatialsampling_torch/csrc/
grid_select.cu``.  Each is compiled with the port's ``nvcc`` flags
(``-Xptxas -v`` among them) into the git-ignored ``_build/`` directory (a
source may include the headers of ``csrc/``), and the script prints the
registers, spills and shared memory ``ptxas`` gives each blocked and
dilated instantiation.

The inputs are both entries' call sites, each with its row statistics
(``chip_smoke.run_stats``: rows per distinct home cell, ``mean_run`` in
call order) and bound (``chip_smoke.grid_bound``):

- blocked: the largest ring pass of the ``grid3d``, ``cylinder3d``,
  ``stl3d`` and ``grid2d_metric`` runs and the largest radius-1 call of
  the blocked layout's run (``chip_smoke.KernelTap`` over each workload's
  grid, without the export), and seeded rows of ``chip_smoke.py``'s
  ``grid_select_kernel`` phase: 1,024 ring rows beside ``grid3d``'s hole
  in random order, whole and half masked, and 2,304 in the main path's
  order;
- dilated, sorted rows: the largest epoch call of the ``grid3d``,
  ``grid2d_metric`` and ``oat2d`` grids and the largest call of
  ``grid3d``'s export (``KernelTap``, site ``grid_select``), and seeded
  epoch rows of the ``grid3d`` and ``oat2d`` layouts in random and in the
  main path's order (``chip_smoke.epoch_order_queries``);
- dilated, unsorted rows with the k + 8 slack (a shard's): seeded rows of
  the ``grid3d`` layout's 3^3 slabs [71040, 864] k=26 in random and in the
  main path's order.

Without ``--ablate``, both builds are checked against the plain version
(``sq``, ``idx``, ``sel`` bitwise) at every site and timed by
``chip_smoke.cuda_ms`` (CUDA-graph replays over copies of the candidates'
coordinates that do not fit in L2 together) in the order old, new, new,
old.

With ``--ablate``, the source is built as it is and with parts of an
entry's path cut by text substitution (``ABLATIONS``; the cut sources are
written to ``_build/``, never into the package), and each build is timed
at that entry's sites in turns (whole, cuts, cuts reversed, whole); the
cut builds compute other numbers and are not checked.  A cut applies to a
source that holds each of its texts exactly once; the others are skipped
and listed.

It prints one JSON line a site, the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true}`` last; without a card it exits 2.  The card's
machine gets no ``.git/``: write an older source into a git-ignored
directory first, e.g. ``git show HEAD~1:sparsespatialsampling_torch/csrc/
grid_select.cu > _smoke_checkout/parent_grid_select.cu``.
"""
import ctypes
import hashlib
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke

BLOCKED, DILATED = "grid_select_blocked", "grid_select_dilated"
# entry: (C function, pointer arguments, int arguments), the stream last
ENTRIES = {BLOCKED: ("grid_select_blocked_f32", 8, 6),
           DILATED: ("grid_select_dilated_f32", 7, 6)}

# name: (entry whose sites time it, [(text in the source, its
# replacement), ...]).  The blocked cuts: the first five cut the first
# blocked design (8 warps a row, slabs in index order): the f64 chain, the
# queue, the coordinate loads, the warps a row; the rest cut the current
# one: its slab order, its f32 pre-filter, its rows a block.  The dilated
# cuts (prefix ``dil_``): the first dilated design's (one warp a row, its
# candidates offered to the queue as scored) f64 chain, queue, loads and
# rows a block, then the current design's.
_NO_F64 = [(
    "    const double da = (double)__fsub_rn(qv[a], coord<D>(v, t * D + a));\n"
    "    out = __double2float_rn(__dadd_rn(__dmul_rn(da, da), (double)out));",
    "    const float da = __fsub_rn(qv[a], coord<D>(v, t * D + a));\n"
    "    out = __fmaf_rn(da, da, out);")]
# the current source's f64 chain (exact_sq, both entries') in f32 FMAs
_EXACT_F32 = [(
    "    const double da = (double)__fsub_rn(qv[a], c[a]);\n"
    "    out = __double2float_rn(__dadd_rn(__dmul_rn(da, da), (double)out));",
    "    const float da = __fsub_rn(qv[a], c[a]);\n"
    "    out = __fmaf_rn(da, da, out);")]
_NO_SELECT = [("if (__any_sync(kFull, near)) {",
               "if (__any_sync(kFull, near) && ws.k < 0) {")]
_NO_LOAD = [(
    "for (int a = 0; a < D; ++a) v[u][a] = __ldg(p + a);",
    "for (int a = 0; a < D; ++a) {\n"
    "          const float f = (float)((size_t)(p + a) & 0xffffu) * 1e-5f;\n"
    "          v[u][a] = make_float4(f, f + 1e-3f, f + 2e-3f, f + 3e-3f);\n"
    "        }")]
_WPR4 = [("a.wpr = warps_per_row(a.width);",
          "a.wpr = warps_per_row(a.width) < 4 ? warps_per_row(a.width) : 4;")]
_CHUNK = ("  int chunk = kBlockWarps;\n"
          "  while (chunk > 1 && (q + chunk - 1) / chunk < kMinBlocksPerSm * sms)\n"
          "    chunk /= 2;\n"
          "  return chunk;")
# the first dilated design's queue: its offers (unique to select_row)
_DIL_NO_SELECT = [(
    "        if (__any_sync(kFull, near)) {\n"
    "          const unsigned c0 = 4u * (unsigned)i;",
    "        if (__any_sync(kFull, near) && ws.k < 0) {\n"
    "          const unsigned c0 = 4u * (unsigned)i;")]
# present only in the first dilated design (a no-op that confines a cut to it)
_FIRST_DILATED = [("          const unsigned c0 = 4u * (unsigned)i;",
                   "          const unsigned c0 = 4u * (unsigned)i;")]
_DIL_ROWS = "      a.wpr == 1 ? kNarrowRowsPerBlock * kWarp : a.wpr * kWarp;"
ABLATIONS = {
    "whole": (None, []),
    "no_f64": (BLOCKED, _NO_F64),    # the distance in f32 FMAs: no conversions
    "exact_f32": (BLOCKED, _EXACT_F32),  # the same in the current source
    "no_select": (BLOCKED, _NO_SELECT),  # distances and the vote, no queue
    "load_only": (BLOCKED, _NO_F64 + _NO_SELECT),
    "compute_only": (BLOCKED, _NO_LOAD + _NO_SELECT),  # no loads, no queue
    "wpr4": (BLOCKED, _WPR4),        # at most 4 warps a row (more rows a card)
    "index_order": (BLOCKED, [("order_offset(d, r),", "-1,")]),
    "no_prefilter": (BLOCKED, [("return th < 1e38f ?", "return th < -1.0f ?")]),
    **{f"chunk{n}": (BLOCKED, [(_CHUNK, f"  return {n};")])
       for n in (8, 4, 2, 1)},
    "dil_no_f64": (DILATED, _NO_F64 + _FIRST_DILATED),
    "dil_no_select": (DILATED, _DIL_NO_SELECT),
    "dil_load_only": (DILATED, _NO_F64 + _DIL_NO_SELECT),
    "dil_compute_only": (DILATED, _NO_LOAD + _DIL_NO_SELECT),
    "dil_no_load": (DILATED, _NO_LOAD),
    **{f"dil_rows{n}": (DILATED, [(
        _DIL_ROWS, f"      a.wpr == 1 ? {n} * kWarp : a.wpr * kWarp;")])
       for n in (2, 8)},
    # the seeded design: one or two lane bests in either dimension; no
    # seed (the bound from the counts alone); the seed on a shard's rows
    # too; no bound from the queue's threshold; no f64 chain; no queue;
    # the first merge through the queue's full merge; the refinement of a
    # loose bound never, or down to one batch; the registers unbounded or
    # bounded by 3 or 5 blocks of 256 threads a multiprocessor
    "dil_seed1": (DILATED, [("  return D == 2 ? 1 : 2;", "  return 1;")]),
    "dil_seed2": (DILATED, [("  return D == 2 ? 1 : 2;", "  return 2;")]),
    "dil_no_seed": (DILATED, [("if (kk > P * kWarp) return ~0u;",
                               "if (kk > 0) return ~0u;")]),
    "dil_seed_unsorted": (DILATED, [("a.wpr, !a.canonical, lane);",
                                     "a.wpr, true, lane);")]),
    "dil_no_queue_bound": (DILATED, [(
        "const float queue_lim = skip_above(ws.thresh_value);",
        "const float queue_lim = __uint_as_float(0x7f800000u);")]),
    "dil_exact_f32": (DILATED, _EXACT_F32),
    "dil_no_merge": (DILATED, [
        ("  if (fresh) {", "  if (fresh && ws.k < 0) {"),
        ("} else if (__any_sync(kFull, take)) {",
         "} else if (__any_sync(kFull, take) && ws.k < 0) {")]),
    "dil_no_fresh": (DILATED, [("  if (fresh) {", "  if (fresh && ws.k < 0) {")]),
    "dil_no_refine": (DILATED, [(
        "lane) > kRefineAbove) {", "lane) > kRefineAbove && ws.k < 0) {")]),
    "dil_refine32": (DILATED, [("constexpr int kRefineAbove = 2 * kWarp;",
                                "constexpr int kRefineAbove = kWarp;")]),
    "dil_unbounded_registers": (DILATED, [(
        "__launch_bounds__(kMaxWarpsPerRow * kWarp, kDilatedMinBlocks)",
        "__launch_bounds__(kMaxWarpsPerRow * kWarp)")]),
    **{f"dil_min_blocks{n}": (DILATED, [("constexpr int kDilatedMinBlocks = 4;",
                                         f"constexpr int kDilatedMinBlocks = {n};")])
       for n in (3, 5)},
}
# the sites at which the blocked cuts are timed
BLOCKED_ABLATION_SITES = ("ring_grid3d", "ring_stl3d", "ring_random",
                          "ring_random_half_masked", "ring_main_order")


def _library(text: str, tag: str) -> tuple:
    """Writes ``text`` to ``_build/`` and starts its ``nvcc``; returns
    ``(library path, process or None if already built)``."""
    from sparsespatialsampling_torch import _build
    headers = sorted(_build.SOURCE_DIR.glob("*.cuh"))
    digest = hashlib.sha1(text.encode() + b"".join(
        h.read_bytes() for h in headers)).hexdigest()[:12]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f"libgrid_select_{tag}_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, None
    src = _build.BUILD_DIR / f"grid_select_{tag}_{digest}.cu"
    src.write_text(text)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build.BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.SOURCE_DIR}",
         "-o", tmp, str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return lib, (proc, tmp, log)


def build(sources: dict) -> dict:
    """``{name: source text}`` compiled together (one ``nvcc`` each);
    returns ``{name: ({entry: function}, ptxas of its kernels)}``."""
    started = {name: _library(text, name) for name, text in sources.items()}
    for name, (lib, pending) in started.items():
        if pending is None:
            continue
        proc, tmp, log = pending
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        os.replace(tmp, lib)
        log.write_text(out)
    built = {}
    for name, (lib, _) in started.items():
        dll = ctypes.CDLL(str(lib))
        setup = getattr(dll, "grid_select_setup", None)
        if setup is not None:  # once, before a launch
            setup.restype = ctypes.c_int
            if setup() != 0:
                raise RuntimeError(f"grid_select_setup failed for {name}")
        fns = {}
        for entry, (cname, n_ptr, n_int) in ENTRIES.items():
            fn = getattr(dll, cname)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[entry] = fn
        built[name] = (fns, ptxas_of(lib.with_suffix(".log").read_text()))
    return built


def ptxas_of(log: str) -> dict:
    """Registers, spill bytes and shared memory of each blocked and
    dilated kernel instantiation in a ``-Xptxas -v`` log, by
    ``blocked_Q<queue>_D<d>`` and ``dilated_Q<queue>_D<d>``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"ILi(\d+)ELi(\d+)E", m.group(1))
            kind = ("blocked" if "blocked" in m.group(1) else
                    "dilated" if "ilated" in m.group(1) else None)
            name = (f"{kind}_Q{k.group(1)}_D{k.group(2)}"
                    if k and kind else None)
            continue
        if name is None:
            continue
        entry = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_stores"] = int(m.group(1))
            entry["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["smem_static"] = int(m.group(1)) if m else 0
    return out


def launch(fns: dict, entry: str, args: tuple):
    """``(sq, idx, sel)`` of one launch of a build's ``entry`` on the
    wrapper's arguments: blocked ``(queries, cell_pts, cell_list, flat,
    k[, mask])``, dilated ``(queries, dil_pts, dil_cand, flat, k,
    sorted_rows)``, as ``ops/grid_select.py`` passes them."""
    queries, pts, cand, flat, k = args[:5]
    q, d = queries.shape
    out = (torch.empty((q, k), dtype=torch.float32, device=queries.device),
           torch.empty((q, k), dtype=torch.int64, device=queries.device),
           torch.empty((q, k), dtype=torch.int32, device=queries.device))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (queries, pts, cand, flat)]
    if entry == BLOCKED:
        mask = args[5] if len(args) > 5 else None
        r, c = flat.shape[1], cand.shape[1]
        ints = [q, d, r, c, k, min(k + 8, r * c)]
        ptrs.append(None if mask is None else mask.data_ptr())
    else:
        sorted_rows, w = args[5], cand.shape[1]
        ints = [q, d, w, k, k if sorted_rows else min(k + 8, w),
                int(not sorted_rows)]
    rc = fns[entry](*ptrs, *(t.data_ptr() for t in out), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{ENTRIES[entry][0]} failed: CUDA error {rc} at "
                           f"queries [{q}, {d}], ints {ints}")
    return out


def _tap(tmp: str, name: str, case, export: bool = False) -> tuple:
    """The largest call at each site of one grid run of ``case`` (and of
    the export of its cell centres, 10 snapshots, when ``export``):
    ``(grid's taps, export's taps)``."""
    from sparsespatialsampling_torch import ExportData, SparseSpatialSampling
    pts, metric, geometries, kw = case[:4]
    # without the prefetch, the export's kNN runs in the export's own tap
    saved = SparseSpatialSampling.EXPORT_PREFETCH
    SparseSpatialSampling.EXPORT_PREFETCH = not export
    try:
        with chip_smoke.KernelTap() as tap:
            s3 = chip_smoke.run_grid(tmp, name, pts, metric, geometries,
                                     **kw)[0]
    finally:
        SparseSpatialSampling.EXPORT_PREFETCH = saved
    if not export:
        return tap.inputs, None
    snaps = (metric[:, None] * (1 + 0.2 * np.sin(np.arange(10)))[None, :]
             ).astype(np.float32)
    with chip_smoke.KernelTap() as etap:
        ExportData(s3, write_times=[str(i) for i in range(10)],
                   device="cuda").interpolate(pts, snaps[:, None, :])
    return tap.inputs, etap.inputs


def _as_site(held) -> tuple:
    """A ``KernelTap`` record as ``(entry, positional arguments)``."""
    entry, args, kwargs = held
    if entry == DILATED:
        args = args + (kwargs.get("sorted_rows", True),) \
            if len(args) == 5 else args
        return entry, args
    return entry, args + tuple(kwargs.values())


def tapped_sites(tmp: str) -> dict:
    """``{name: (entry, args)}`` of each entry's largest main-path call at
    its sites (each workload's grid under ``chip_smoke.KernelTap``; the
    export of ``grid3d``'s cell centres apart)."""
    from sparsespatialsampling_torch.ops.knn import KNNIndex
    stl = os.path.join(tmp, "sphere.stl")
    chip_smoke.sphere_stl(stl)
    cases = {"grid3d": chip_smoke.grid3d_case(),
             "cylinder3d": chip_smoke.cylinder3d_case(),
             "grid2d_metric": chip_smoke.grid2d_metric_case(),
             "stl3d": chip_smoke.stl3d_case(stl),
             "oat2d": chip_smoke.oat2d_case()}
    sites = {}
    for name, case in cases.items():
        held, exported = _tap(tmp, name, case, export=name == "grid3d")
        if chip_smoke.RING in held:
            sites[f"ring_{name}"] = _as_site(held[chip_smoke.RING])
        if name in ("grid3d", "grid2d_metric", "oat2d"):
            sites[f"dil_{name}"] = _as_site(held["grid_select"])
        if exported is not None:
            sites[f"dil_{name}_export"] = _as_site(exported["grid_select"])
    saved = KNNIndex.DIL_MAX_BYTES
    KNNIndex.DIL_MAX_BYTES = 0
    try:
        held, _ = _tap(tmp, "blk", chip_smoke.compare_case())
    finally:
        KNNIndex.DIL_MAX_BYTES = saved
    sites["blocked_select"] = _as_site(held[chip_smoke.BLOCKED])
    return sites


def seeded_sites() -> dict:
    """The seeded rows of ``grid_select_kernel`` on the ``grid3d`` and
    ``oat2d`` layouts: ring rows in random order (whole, half masked) and
    in the main path's order; epoch rows (sorted) and a shard's unsorted
    rows in random and in the main path's order."""
    from sparsespatialsampling_torch.ops import knn
    xyz, _, bounds = chip_smoke.cylinder_wake_3d()
    index = knn.KNNIndex(xyz, device="cuda")
    g = index._grid
    rng = np.random.default_rng(11)
    ang = rng.uniform(0, 2 * np.pi, 1024)
    rad = rng.uniform(0.05, 0.07, 1024)
    q = index._queries_f32(np.stack([0.2 + rad * np.cos(ang),
                                     0.2 + rad * np.sin(ang),
                                     rng.uniform(0.0, 0.41, 1024)], 1)
                           - index._shift)

    def flat(qs):
        return knn._grid_neighborhood(qs, g["cell_list"].shape[0],
                                      g["origin"], g["inv_h"], g["dims"],
                                      4)[0]

    def dil_flat(grid, qs):
        return knn._grid_query_margin(qs, grid["origin"], grid["inv_h"],
                                      grid["dims"])[0]
    half = torch.from_numpy(rng.uniform(size=1024) < 0.5).cuda()
    lo = np.asarray(bounds[0], np.float64)
    width = float(np.max(np.subtract(bounds[1], bounds[0])))
    mq = chip_smoke.main_order_queries(index, lo, width, (0.2, 0.2),
                                       (0.05, 0.07), (0.0, 0.41), 32,
                                       seed=12)
    slabs = (g["cell_pts"], g["cell_list"])
    sites = {"ring_random": (BLOCKED, (q, *slabs, flat(q), 26)),
             "ring_random_half_masked": (BLOCKED,
                                         (q, *slabs, flat(q), 26, half)),
             "ring_main_order": (BLOCKED, (mq, *slabs, flat(mq), 26))}
    # a shard's rows: each cell's 27 slabs concatenated, unsorted
    nb = knn._grid_neighbor_table(g["dims"], g["cell_list"].shape[0] - 1)
    rows = (g["cell_pts"][nb].reshape(nb.shape[0], -1).contiguous(),
            g["cell_list"][nb].reshape(nb.shape[0], -1).contiguous())
    for n, sorted_rows, layout, tag in (
            (65536, True, (g["dil_pts"], g["dil_cand"]), "dil_epoch"),
            (71040, False, rows, "dil_slack")):
        rq = index._queries_f32(rng.uniform(bounds[0], bounds[1], (n, 3))
                                - index._shift)
        eq = chip_smoke.epoch_order_queries(index, lo, bounds[1], width, 6, n)
        for order, qs in (("random", rq), ("main_order", eq)):
            sites[f"{tag}_{order}"] = (DILATED, (
                qs, *layout, dil_flat(g, qs), 26, sorted_rows))
    del index, g, nb, rows
    xy = chip_smoke.synthetic_oat15()[0]
    index = knn.KNNIndex(xy, device="cuda")
    g = index._grid
    rq = index._queries_f32(rng.uniform([-0.5, -0.5], [1.5, 0.5], (11520, 2))
                            - index._shift)
    eq = chip_smoke.epoch_order_queries(index, [-0.5, -0.5], [1.5, 0.5], 2.0,
                                        7, 11520)
    for order, qs in (("random", rq), ("main_order", eq)):
        sites[f"dil_epoch_2d_{order}"] = (DILATED, (
            qs, g["dil_pts"], g["dil_cand"], dil_flat(g, qs), 8, True))
    return sites


def stats_of(entry: str, args: tuple) -> dict:
    """A site's shape, k, row statistics and bound."""
    if entry == BLOCKED:
        mask = args[5] if len(args) > 5 else None
        a = {"queries": args[0], "k": args[4], "flat": args[3],
             "cell_list": args[2], "mask": mask}
        w = args[3].shape[1] * args[2].shape[1]
        extra = {}
    else:
        mask = None
        a = {"queries": args[0], "k": args[4], "flat": args[3],
             "dil_cand": args[2], "sorted_rows": args[5]}
        w = args[2].shape[1]
        extra = {"sorted_rows": args[5]}
    bound = chip_smoke.grid_bound(entry, a)
    return {"entry": entry, "shape": [int(args[0].shape[0]), int(w)],
            "k": args[4], **extra, **chip_smoke.run_stats(args[3], mask),
            **{key: bound[key] for key in ("bound_ms", "bound_by",
                                           "bound_rows_ms")}}


def plain(entry: str, args: tuple):
    from sparsespatialsampling_torch.ops import grid_select as gs
    return getattr(gs, entry + "_plain")(*args)


def timed(fns: dict, entry: str, args: tuple) -> float:
    return chip_smoke.cuda_ms(
        lambda t: launch(fns, entry, (args[0], t) + args[2:]), args[1])


def all_sites() -> dict:
    with tempfile.TemporaryDirectory(prefix="gs_sites_") as tmp:
        return {**tapped_sites(tmp), **seeded_sites()}


def compare(old_path: str, new_path: str = None) -> None:
    from sparsespatialsampling_torch import _build
    new = Path(new_path) if new_path else _build.SOURCE_DIR / "grid_select.cu"
    kernels = build({"old": Path(old_path).read_text(),
                     "new": new.read_text()})
    chip_smoke.emit({"ptxas": {n: p for n, (_, p) in kernels.items()}})
    for name, (entry, args) in all_sites().items():
        ref = plain(entry, args)
        row = {"site": name, **stats_of(entry, args)}
        for which, (fns, _) in kernels.items():
            got = launch(fns, entry, args)
            torch.cuda.synchronize()
            row[f"{which}_equal_plain"] = all(
                torch.equal(a, b) for a, b in zip(got, ref))
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(timed(kernels[which][0], entry, args))
        row.update(old_ms=times["old"], new_ms=times["new"])
        chip_smoke.emit(row)
        if not (row["old_equal_plain"] and row["new_equal_plain"]):
            raise AssertionError(f"{name}: a build disagrees with the plain "
                                 f"version")


def ablate(src_path: str, only: str = None) -> None:
    text = Path(src_path).read_text()
    wanted = {name: (entry, subs) for name, (entry, subs) in ABLATIONS.items()
              if only is None or entry in (None, only)}
    sources = {}
    for name, (_, subs) in wanted.items():
        if all(text.count(old) == 1 for old, _ in subs):
            cut = text
            for old, new in subs:
                cut = cut.replace(old, new)
            sources[name] = cut
    chip_smoke.emit({"source": src_path, "cuts": sorted(sources),
                     "skipped": sorted(set(wanted) - set(sources))})
    kernels = build(sources)
    chip_smoke.emit({"ptxas": {n: p for n, (_, p) in kernels.items()}})
    for name, (entry, args) in all_sites().items():
        if only is not None and entry != only:
            continue
        row = {"site": name, **stats_of(entry, args)}
        if entry == DILATED or name in BLOCKED_ABLATION_SITES:
            cuts = [n for n in kernels if ABLATIONS[n][0] in (None, entry)]
            times = {n: [] for n in cuts}
            for which in cuts + cuts[::-1]:
                times[which].append(timed(kernels[which][0], entry, args))
            row["ms"] = times
        chip_smoke.emit(row)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("grid_select_compare: CUDA is not available", file=sys.stderr)
        return 2
    entries = {"blocked": BLOCKED, "dilated": DILATED}
    if argv[:1] == ["--ablate"] and len(argv) in (2, 3) and (
            len(argv) == 2 or argv[2] in entries):
        ablate(argv[1], entries.get(argv[2]) if len(argv) == 3 else None)
    elif len(argv) in (1, 2) and not argv[0].startswith("-"):
        compare(*argv)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi_line(), flush=True)
    chip_smoke.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
