"""k smallest values per row with canonical ties: the selection kernel of
the dilated-grid kNN.

Port of the JAX package's Pallas kernel ``ops/pallas_topk.py:topk_smallest``.
On the index-sorted dilated rows, "ties go to the lowest column" IS the
canonical ascending ``(distance², index)`` order every kNN path emits, so
the selection needs no slack and no re-sort.  ``torch.topk`` promises no
tie order on CUDA and is never used for it.

- :func:`topk_smallest` is the wrapper: a CUDA tensor goes to the
  hand-written kernel ``csrc/topk_smallest.cu`` (built at first use by
  ``_build.py``) or the call raises; a CPU tensor goes to the plain
  version.  There is no fallback from one to the other.
- :func:`topk_smallest_plain` is the plain PyTorch version, the same
  iterative min extraction as the Pallas body (``pallas_topk.py:36-45``).
- ``launches`` counts the kernel launches, and nothing else.
"""
import ctypes

import torch

# kernel launches of :func:`topk_smallest` (plain-version calls not counted)
launches = 0

_KERNEL = "topk_smallest"


def topk_smallest_plain(x: torch.Tensor, k: int):
    """``(vals [Q, k] f32, sel [Q, k] int32)``: the k smallest of each row of
    ``x [Q, W]`` in ascending order, ties to the lowest column, values bit
    for bit.  k rounds of: row min, its first column (min over a masked
    iota), overwrite that column with +inf.  A row with fewer than k finite
    entries repeats the lowest column holding +inf (the Pallas kernel's
    caveat, ``pallas_topk.py:67-74``)."""
    q, w = x.shape
    iota = torch.arange(w, device=x.device, dtype=torch.int32).expand(q, w)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    wide = torch.tensor(w, dtype=torch.int32, device=x.device)
    vals = torch.empty((q, k), dtype=x.dtype, device=x.device)
    sel = torch.empty((q, k), dtype=torch.int32, device=x.device)
    for j in range(k):
        m = x.min(dim=1).values
        am = torch.where(x == m[:, None], iota, wide).min(dim=1).values
        vals[:, j] = m
        sel[:, j] = am
        x = torch.where(iota == am[:, None], inf, x)
    return vals, sel


def _launch(x: torch.Tensor, k: int):
    from .. import _build
    lib = _build.load(_KERNEL)
    fn = lib.topk_smallest_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    q, w = x.shape
    vals = torch.empty((q, k), dtype=torch.float32, device=x.device)
    sel = torch.empty((q, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), vals.data_ptr(), sel.data_ptr(), q, w, k,
                stream)
    if rc != 0:
        raise RuntimeError(f"topk_smallest kernel launch failed: CUDA error "
                           f"{rc} at x [{q}, {w}], k={k}")
    return vals, sel


def topk_smallest(x: torch.Tensor, k: int):
    """The k smallest of each row of ``x [Q, W]`` f32, ascending, ties to the
    lowest column: ``(vals [Q, k] f32, sel [Q, k] int32)``.

    A CPU tensor runs :func:`topk_smallest_plain`; a CUDA tensor launches the
    hand-written kernel (rows must hold no NaN — distances never do).  Any
    other device, dtype or layout raises."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"topk_smallest expects a [Q, W] matrix, got "
                         f"shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"topk_smallest expects float32, got {x.dtype}")
    q, w = x.shape
    if k < 1 or w < 1:
        raise ValueError(f"topk_smallest needs k >= 1 and W >= 1 "
                         f"(k={k}, W={w})")
    if x.device.type == "cpu":
        return topk_smallest_plain(x, k)
    if x.device.type != "cuda":
        raise RuntimeError(f"topk_smallest has no kernel for device "
                           f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("topk_smallest expects a contiguous matrix")
    if q >= 2 ** 31:
        raise ValueError(f"topk_smallest: {q} rows exceed the int32 count")
    if q == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=x.device),
                torch.empty((0, k), dtype=torch.int32, device=x.device))
    out = _launch(x, k)
    launches += 1
    return out
