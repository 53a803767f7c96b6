"""k smallest values per row with canonical ties: the selection kernel of
the dilated-grid kNN and of the full scan (per score tile and over the
tiles' merged candidates).

Port of the JAX package's Pallas kernel ``ops/pallas_topk.py:topk_smallest``.
On the index-sorted dilated rows, "ties go to the lowest column" IS the
canonical ascending ``(distance², index)`` order every kNN path emits, so
the selection needs no slack and no re-sort.  ``torch.topk`` promises no
tie order on CUDA and is never used for it.

- :func:`topk_smallest` is the wrapper: a CUDA tensor goes to the
  hand-written kernel ``csrc/topk_smallest.cu`` (built at first use by
  ``_build.py``) or the call raises; a CPU tensor goes to the plain
  version.  There is no fallback from one to the other.
- :func:`topk_smallest_plain` is the plain PyTorch version: one stable
  sort, the first k columns, and the Pallas kernel's caveat applied after.
- ``launches`` counts the kernel launches, and nothing else.

Limits, on every device: ``1 <= k <= min(W, MAX_K)``.  The kernel's warp
queue holds at most ``MAX_K`` keys; ``lax.top_k`` refuses ``k > W`` too.
"""
import ctypes

import torch

# kernel launches of :func:`topk_smallest` (plain-version calls not counted)
launches = 0

_KERNEL = "topk_smallest"
# the kernel's compile-time queue size (``kMaxK`` in csrc/topk_smallest.cu)
MAX_K = 256


def topk_smallest_plain(x: torch.Tensor, k: int):
    """``(vals [Q, k] f32, sel [Q, k] int32)``: the k smallest of each row of
    ``x [Q, W]`` in ascending order, ties to the lowest column, values bit
    for bit, through one stable sort.  The Pallas kernel extracts by
    overwriting each winner with +inf, so once a row's entries below +inf
    run out the whole row is +inf and every further output is column 0:
    every +inf output here takes column 0 too (``pallas_topk.py:67-74``)."""
    vals, order = torch.sort(x, dim=1, stable=True)
    vals = vals[:, :k].contiguous()
    sel = order[:, :k].to(torch.int32)
    sel.masked_fill_(vals == float("inf"), 0)
    return vals, sel


_entry = None


def _kernel_entry():
    """The C entry point of the built kernel, its argument types set."""
    global _entry
    if _entry is None:
        from .. import _build
        fn = _build.load(_KERNEL).topk_smallest_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def _launch(x: torch.Tensor, k: int):
    fn = _kernel_entry()
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
    if not 1 <= k <= w:
        raise ValueError(f"topk_smallest needs 1 <= k <= W (k={k}, W={w})")
    if k > MAX_K:
        raise ValueError(f"topk_smallest takes k <= {MAX_K}, the kernel's "
                         f"queue size (k={k})")
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
