"""Times builds of ``grid_select``'s blocked entry on one card, side by side.

    python3 grid_select_compare.py OLD.cu [NEW.cu]  # OLD against NEW (default csrc/grid_select.cu)
    python3 grid_select_compare.py --ablate SRC.cu  # SRC with parts of its blocked path cut

Every source must export the C entry point ``grid_select_blocked_f32`` of
``sparsespatialsampling_torch/csrc/grid_select.cu``.  Each is compiled with
the port's ``nvcc`` flags (``-Xptxas -v`` among them) into the git-ignored
``_build/`` directory (a source may include the headers of ``csrc/``), and
the script prints the registers, spills and shared memory ``ptxas`` gives
each blocked instantiation.

The inputs are the blocked entry's call sites: the largest ring pass of
the ``grid3d``, ``cylinder3d``, ``stl3d`` and ``grid2d_metric`` runs and the
largest radius-1 call of the blocked layout's run (``chip_smoke.KernelTap``
over each workload's grid, without the export), each with its row
statistics (``chip_smoke.run_stats``), and seeded rows of
``chip_smoke.py``'s ``grid_select_kernel`` phase: 1,024 ring rows beside
``grid3d``'s hole in random order, whole and half masked, and 2,304 in the
main path's order.

Without ``--ablate``, both builds are checked against the plain version
(``sq``, ``idx``, ``sel`` bitwise) at every site and timed by
``chip_smoke.cuda_ms`` (CUDA-graph replays over copies of the slabs that do
not fit in L2 together) in the order old, new, new, old.

With ``--ablate``, the source is built as it is and with parts of its
blocked path cut by text substitution (``ABLATIONS``; the cut sources are
written to ``_build/``, never into the package), and each build is timed at
the ring sites in turns; the cut builds compute other numbers and are not
checked.

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

ENTRY = "grid_select_blocked_f32"

# (name, [(text in the source, its replacement), ...]): a cut applies to a
# source that holds each of its texts exactly once, and the others are
# skipped.  The first five cut the first blocked design (8 warps a row,
# slabs in index order): the f64 chain, the queue, the coordinate loads, the
# warps a row; the rest cut the current one: its slab order, its f32
# pre-filter, its rows a block.
_NO_F64 = [(
    "    const double da = (double)__fsub_rn(qv[a], coord<D>(v, t * D + a));\n"
    "    out = __double2float_rn(__dadd_rn(__dmul_rn(da, da), (double)out));",
    "    const float da = __fsub_rn(qv[a], coord<D>(v, t * D + a));\n"
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
ABLATIONS = {
    "whole": [],
    "no_f64": _NO_F64,          # the distance in f32 FMAs: no conversions
    "no_select": _NO_SELECT,    # distances and the threshold vote, no queue
    "load_only": _NO_F64 + _NO_SELECT,
    "compute_only": _NO_LOAD + _NO_SELECT,  # no coordinate loads, no queue
    "wpr4": _WPR4,              # at most 4 warps a row (more rows a card)
    "index_order": [("order_offset(d, r),", "-1,")],
    "no_prefilter": [("return th < 1e38f ?", "return th < -1.0f ?")],
    **{f"chunk{n}": [(_CHUNK, f"  return {n};")] for n in (8, 4, 2, 1)},
}


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
    returns ``{name: (entry function, ptxas of its blocked kernels)}``."""
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
        if setup is not None:  # the redesign's: once, before a launch
            setup.restype = ctypes.c_int
            if setup() != 0:
                raise RuntimeError(f"grid_select_setup failed for {name}")
        fn = getattr(dll, ENTRY)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[name] = (fn, ptxas_blocked(lib.with_suffix(".log").read_text()))
    return built


def ptxas_blocked(log: str) -> dict:
    """Registers, spill bytes and shared memory of each blocked kernel
    instantiation in a ``-Xptxas -v`` log, by ``Q<queue>_D<d>``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"ILi(\d+)ELi(\d+)E", m.group(1))
            name = (f"Q{k.group(1)}_D{k.group(2)}"
                    if k and "locked" in m.group(1) else None)
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


def launch(fn, args: tuple):
    """``(sq, idx, sel)`` of one launch of the entry ``fn`` on the blocked
    entry's arguments ``(queries, cell_pts, cell_list, flat, k[, mask])``,
    as ``grid_select_blocked`` makes it."""
    queries, cell_pts, cell_list, flat, k = args[:5]
    mask = args[5] if len(args) > 5 else None
    (q, d), r, c = queries.shape, flat.shape[1], cell_list.shape[1]
    out = (torch.empty((q, k), dtype=torch.float32, device=queries.device),
           torch.empty((q, k), dtype=torch.int64, device=queries.device),
           torch.empty((q, k), dtype=torch.int32, device=queries.device))
    rc = fn(queries.data_ptr(), cell_pts.data_ptr(), cell_list.data_ptr(),
            flat.data_ptr(), None if mask is None else mask.data_ptr(),
            *(t.data_ptr() for t in out), q, d, r, c, k,
            min(k + 8, r * c), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{ENTRY} failed: CUDA error {rc} at [{q}, "
                           f"{r * c}], k={k}")
    return out


def tapped_sites(tmp: str) -> dict:
    """``{name: args}`` of the blocked entry's largest main-path call at
    each ring site and the blocked layout's site (each workload's grid
    under ``chip_smoke.KernelTap``, without the export)."""
    from sparsespatialsampling_torch.ops.knn import KNNIndex
    xyz, metric, geometries, kw, _ = chip_smoke.grid3d_case()
    cases = {"grid3d": (xyz, metric, geometries, kw),
             "cylinder3d": chip_smoke.cylinder3d_case(),
             "grid2d_metric": chip_smoke.grid2d_metric_case()}
    stl = os.path.join(tmp, "sphere.stl")
    chip_smoke.sphere_stl(stl)
    xyz, metric, geometries, kw, _ = chip_smoke.stl3d_case(stl)
    cases["stl3d"] = (xyz, metric, geometries, kw)
    sites = {}
    for name, (pts, metric, geometries, kw) in cases.items():
        with chip_smoke.KernelTap() as tap:
            chip_smoke.run_grid(tmp, name, pts, metric, geometries, **kw)
        held = tap.inputs.get(chip_smoke.RING)
        if held is not None:
            sites[f"ring_{name}"] = held[1] + tuple(held[2].values())
    saved = KNNIndex.DIL_MAX_BYTES
    KNNIndex.DIL_MAX_BYTES = 0
    try:
        pts, metric, geometries, kw = chip_smoke.compare_case()
        with chip_smoke.KernelTap() as tap:
            chip_smoke.run_grid(tmp, "blk", pts, metric, geometries, **kw)
    finally:
        KNNIndex.DIL_MAX_BYTES = saved
    held = tap.inputs[chip_smoke.BLOCKED]
    sites["blocked_select"] = held[1] + tuple(held[2].values())
    return sites


def seeded_sites() -> dict:
    """The ring rows of ``grid_select_kernel`` on the ``grid3d`` layout:
    random order (whole, half masked) and the main path's order."""
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
    half = torch.from_numpy(rng.uniform(size=1024) < 0.5).cuda()
    mq = chip_smoke.main_order_queries(
        index, np.asarray(bounds[0], np.float64),
        float(np.max(np.subtract(bounds[1], bounds[0]))), (0.2, 0.2),
        (0.05, 0.07), (0.0, 0.41), 32, seed=12)
    slabs = (g["cell_pts"], g["cell_list"])
    return {"ring_random": (q, *slabs, flat(q), 26),
            "ring_random_half_masked": (q, *slabs, flat(q), 26, half),
            "ring_main_order": (mq, *slabs, flat(mq), 26)}


def stats_of(args: tuple) -> dict:
    mask = args[5] if len(args) > 5 else None
    return {"shape": [int(args[0].shape[0]),
                      int(args[3].shape[1] * args[2].shape[1])],
            "k": args[4], **chip_smoke.run_stats(args[3], mask),
            **{key: chip_smoke.grid_bound("grid_select_blocked", {
                "queries": args[0], "k": args[4], "flat": args[3],
                "cell_list": args[2], "mask": mask})[key]
               for key in ("bound_ms", "bound_by", "bound_rows_ms")}}


def timed(fn, args: tuple) -> float:
    return chip_smoke.cuda_ms(lambda t: launch(fn, (args[0], t) + args[2:]),
                              args[1])


def compare(old_path: str, new_path: str = None) -> None:
    from sparsespatialsampling_torch import _build
    from sparsespatialsampling_torch.ops import grid_select as gs
    new = Path(new_path) if new_path else _build.SOURCE_DIR / "grid_select.cu"
    kernels = build({"old": Path(old_path).read_text(),
                     "new": new.read_text()})
    chip_smoke.emit({"ptxas": {n: p for n, (_, p) in kernels.items()}})
    with tempfile.TemporaryDirectory(prefix="gs_compare_") as tmp:
        sites = {**tapped_sites(tmp), **seeded_sites()}
    for name, args in sites.items():
        ref = gs.grid_select_blocked_plain(*args)
        row = {"site": name, **stats_of(args)}
        for which, (fn, _) in kernels.items():
            got = launch(fn, args)
            torch.cuda.synchronize()
            row[f"{which}_equal_plain"] = all(
                torch.equal(a, b) for a, b in zip(got, ref))
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(timed(kernels[which][0], args))
        row.update(old_ms=times["old"], new_ms=times["new"])
        chip_smoke.emit(row)
        if not (row["old_equal_plain"] and row["new_equal_plain"]):
            raise AssertionError(f"{name}: a build disagrees with the plain "
                                 f"version")


def ablate(src_path: str) -> None:
    text = Path(src_path).read_text()
    sources = {}
    for name, subs in ABLATIONS.items():
        if all(text.count(old) == 1 for old, _ in subs):
            cut = text
            for old, new in subs:
                cut = cut.replace(old, new)
            sources[name] = cut
    chip_smoke.emit({"source": src_path, "cuts": sorted(sources),
                     "skipped": sorted(set(ABLATIONS) - set(sources))})
    kernels = build(sources)
    chip_smoke.emit({"ptxas": {n: p for n, (_, p) in kernels.items()}})
    with tempfile.TemporaryDirectory(prefix="gs_ablate_") as tmp:
        sites = {**tapped_sites(tmp), **seeded_sites()}
    for name, args in sites.items():
        row = {"site": name, **stats_of(args)}
        if name in ("ring_grid3d", "ring_stl3d", "ring_random",
                    "ring_random_half_masked", "ring_main_order"):
            order = list(kernels) + list(kernels)[::-1]
            times = {n: [] for n in kernels}
            for which in order:
                times[which].append(timed(kernels[which][0], args))
            row["ms"] = times
        chip_smoke.emit(row)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("grid_select_compare: CUDA is not available", file=sys.stderr)
        return 2
    if len(argv) == 2 and argv[0] == "--ablate":
        ablate(argv[1])
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
