"""Times two builds of the selection kernel on one card, side by side.

    python3 topk_compare.py OLD.cu        # OLD against csrc/topk_smallest.cu

Both sources must export the C entry point ``topk_smallest_f32`` of
``sparsespatialsampling_torch/csrc/topk_smallest.cu``.  Each is compiled
with the port's ``nvcc`` flags into the git-ignored ``_build/`` directory
(a source may include the headers of ``csrc/``, from its own directory or
from there).
At each of the main path's selection shapes that both kernels can take
(``SHAPES``), the script checks both against the plain version and times them
by ``chip_smoke.cuda_ms`` (CUDA-graph replays over copies of the input that
do not fit in L2 together) in the order old, new, new, old.  It prints one
JSON line per shape, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true}`` last; without a card it exits 2.
"""
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke

# the tie-laden shapes of chip_smoke.py's kernel phase (the epoch shape,
# the 2D shape, the full scan's merge width, and the edges k = 1 and
# k = W) and the dilated grid3d rows, as (rows, width, k, seed); the
# kernel before PR 2's streaming redesign takes only the first four
SHAPES = ((36864, 864, 26, 0), (65536, 384, 26, 7), (20480, 576, 8, 1),
          (1024, 1054, 34, 2), (4096, 1054, 1, 3), (2048, 200, 200, 4))


def build(source: Path):
    """The ``topk_smallest_f32`` entry of ``source``, compiled and loaded."""
    from sparsespatialsampling_torch import _build
    headers = sorted(_build.SOURCE_DIR.glob("*.cuh"))
    digest = hashlib.sha1(source.read_bytes() + b"".join(
        h.read_bytes() for h in headers)).hexdigest()[:12]
    lib = _build.BUILD_DIR / f"libtopk_compare_{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.SOURCE_DIR}", "-o", str(lib),
                        str(source)], check=True, capture_output=True,
                       text=True)
    fn = ctypes.CDLL(str(lib)).topk_smallest_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, x: torch.Tensor, k: int):
    q, w = x.shape
    vals = torch.empty((q, k), dtype=torch.float32, device=x.device)
    sel = torch.empty((q, k), dtype=torch.int32, device=x.device)
    rc = fn(x.data_ptr(), vals.data_ptr(), sel.data_ptr(), q, w, k,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {rc} at "
                           f"[{q}, {w}], k={k}")
    return vals, sel


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("topk_compare: CUDA is not available", file=sys.stderr)
        return 2
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    from sparsespatialsampling_torch import _build
    from sparsespatialsampling_torch.ops import topk
    kernels = {"old": build(Path(argv[0])),
               "new": build(_build.SOURCE_DIR / "topk_smallest.cu")}
    for q, w, k, seed in SHAPES:
        x = chip_smoke.tie_laden(q, w, k, seed)
        pvals, psel = topk.topk_smallest_plain(x, k)
        row = {"shape": [q, w], "k": k}
        for name, fn in kernels.items():
            vals, sel = launch(fn, x, k)
            row[f"{name}_equal_plain"] = {"vals": torch.equal(vals, pvals),
                                          "sel": torch.equal(sel, psel)}
        times = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            fn = kernels[name]
            times[name].append(chip_smoke.cuda_ms(
                lambda t, fn=fn: launch(fn, t, k), x))
        row.update(old_ms=times["old"], new_ms=times["new"],
                   bound_ms=chip_smoke.topk_bound(q, w, k)[0])
        chip_smoke.emit(row)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    chip_smoke.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
