"""The grid kNN's candidate scoring and canonical selection, fused: the
squared distances of each query to the candidates of its grid rows, and
the k nearest in the canonical ascending ``(distance², index)`` order.

Port of what the JAX package compiles into one XLA program on every grid
route: ``_dilated_select`` (``ops/knn.py:593``, both row modes),
``_grid_candidates`` + ``_topk_canonical`` (``_grid_query_kernel``,
``:360``) and the ring's ``do_ring`` (``engine/tree.py:1124-1163``).

- :func:`grid_select_dilated` takes one dilated row a query (``flat [Q]``):
  with ``sorted_rows`` (the single-device layout, rows sorted by
  candidate index) the k smallest by ``(sq, slot)`` are the canonical
  order; without (a shard's unsorted rows) the ``k + 8`` smallest are
  re-sorted by ``(sq, idx)``, as :func:`canonical_topk`.
- :func:`grid_select_blocked` takes the (2r+1)^d blocked slabs of each
  query's neighbourhood (``flat [Q, R]``) and re-sorts the ``k + 8``
  smallest; an optional ``mask [Q]`` leaves rows out, which get the filler
  ``(+inf, 0, 0)`` (read on the device, so a CUDA graph can capture it).

A CUDA tensor goes to the hand-written kernel ``csrc/grid_select.cu``
(built at first use by ``_build.py``) or the call raises; a CPU tensor
goes to the plain version (``*_plain``: the gather, :func:`_sqsum` and the
selection as eager operators).  There is no fallback from one to the
other.  ``launches`` counts the kernel launches, and nothing else.

Limits, on every device: ``1 <= k <= kk <= MAX_K`` with ``kk`` the
selection's width (k sorted, else ``min(k + 8, W)``); the kNN keeps its
unfused chain (``ops/knn.py:_select_sorted``) above that.  ``d`` is 2 or
3; the kernel also wants the dilated width a multiple of 4 and the slab
capacity ``C`` a power of two, which every grid of the port has.
"""
import ctypes

import torch

from . import topk as _topk

# kernel launches of the two entries (plain-version calls not counted)
launches = 0

_KERNEL = "grid_select"
# the widest selection the kernel's warp queue holds (``kMaxK``)
MAX_K = _topk.MAX_K
_INF = float("inf")


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a·b + c`` with one rounding, as a fused multiply-add gives it:
    the product of two f32 values is exact in f64, so only the f64 sum and
    the final f32 cast round (the two roundings disagree with one only when
    the f64 sum lands exactly on an f32 midpoint, about 2^-29 of cases)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _sqsum(delta: torch.Tensor) -> torch.Tensor:
    """``Σ_a delta[..., a]²`` in axis order, each term after the first
    added by a fused multiply-add: ``fma(d2, d2, fma(d1, d1, d0·d0))`` is
    what XLA's CPU backend makes of ``jnp.sum(dd * dd, axis=-1)``, so the
    port's distances equal the JAX package's bit for bit, on every
    device (the kernel rounds the same way)."""
    d0 = delta[..., 0]
    out = d0 * d0
    for a in range(1, delta.shape[-1]):
        out = _fma(delta[..., a], delta[..., a], out)
    return out


def _sort_neighbors(sq: torch.Tensor, idx: torch.Tensor, *payload):
    """Canonical neighbour order: ascending ``(sq, idx)`` lexicographic
    (two stable sorts, minor key first); each ``payload`` tensor of the
    same shape is permuted along."""
    idx_s, o1 = torch.sort(idx, dim=1, stable=True)
    sq_s, o2 = torch.sort(torch.gather(sq, 1, o1), dim=1, stable=True)
    return (sq_s, torch.gather(idx_s, 1, o2)) + tuple(
        torch.gather(torch.gather(p, 1, o1), 1, o2) for p in payload)


def canonical_topk(d2, cand, k: int, select=_topk.topk_smallest_plain):
    """Canonical top-k of unsorted candidate rows: the ``k + 8`` nearest
    slots by ``select`` (lowest slot first at equal distance, as the JAX
    package's stable ``lax.top_k(-d2)``), their candidate ids, the
    ascending ``(sq, idx)`` sort, the first k.  The slack lets a distance
    tie at the k-th place resolve by point index instead of by slot.
    Returns ``(sq [Q, k], idx [Q, k] int64, sel [Q, k] int64)``, ``sel``
    the slot of each (for value gathers)."""
    kk = min(k + 8, d2.shape[1])
    sq, sel = select(d2, kk)
    sel = sel.long()
    idx = torch.gather(cand, 1, sel).long()
    sq, idx, sel = _sort_neighbors(sq, idx, sel)
    return sq[:, :k], idx[:, :k], sel[:, :k]


def fill_unmarked(mask, sq, idx, sel):
    """Rows ``mask`` leaves out as the filler ``(+inf, 0, 0)``."""
    if mask is None:
        return sq, idx, sel
    keep = mask[:, None]
    return (torch.where(keep, sq, _INF), torch.where(keep, idx, 0),
            torch.where(keep, sel, 0))


def grid_select_dilated_plain(queries, dil_pts, dil_cand, flat, k: int,
                              sorted_rows: bool = True):
    """:func:`grid_select_dilated` as eager operators: the ``[Q, W, d]``
    gather, :func:`_sqsum`, then the k smallest (sorted rows) or
    :func:`canonical_topk`, through the selection kernel's plain
    version."""
    q, d = queries.shape
    g3 = dil_pts[flat].reshape(q, -1, d)                  # [Q, W, d]
    sq = _sqsum(queries[:, None, :] - g3)                 # [Q, W]
    if not sorted_rows:
        sq, idx, sel = canonical_topk(sq, dil_cand[flat], k)
        return sq, idx, sel.int()
    sq_k, sel = _topk.topk_smallest_plain(sq, k)
    idx = dil_cand[flat[:, None], sel.long()].long()      # [Q, k] pointwise
    return sq_k, idx, sel


def grid_select_blocked_plain(queries, cell_pts, cell_list, flat, k: int,
                              mask=None):
    """:func:`grid_select_blocked` as eager operators: the ``[Q, R, C, d]``
    gather, :func:`_sqsum`, :func:`canonical_topk`, the filler."""
    q = queries.shape[0]
    d2 = _sqsum(queries[:, None, None, :] - cell_pts[flat]).reshape(q, -1)
    sq, idx, sel = canonical_topk(d2, cell_list[flat].reshape(q, -1), k)
    return fill_unmarked(mask, sq, idx, sel.int())


_entries = {}
# devices on which the library's ``grid_select_setup`` has run
_set_up = set()


def _kernel_entry(name: str, n_pointers: int, n_ints: int):
    """The C entry point ``name`` of the built kernel, its argument types
    set: ``n_pointers`` pointers, ``n_ints`` ints, the stream."""
    fn = _entries.get(name)
    if fn is None:
        from .. import _build
        fn = getattr(_build.load(_KERNEL), name)
        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _setup(device) -> None:
    """``grid_select_setup`` of the library on ``device``, once: the blocked
    kernel's slab scan orders, shared-memory limit and the device's
    multiprocessor count, which its launches there need.  It must not run
    inside a CUDA graph capture, and it never does: a window's graph is
    captured after an eager run of the same body."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index in _set_up:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"grid_select: the kernel is not set up on "
                           f"cuda:{index}; run one call outside a CUDA graph "
                           f"capture first")
    from .. import _build
    fn = _build.load(_KERNEL).grid_select_setup
    fn.argtypes, fn.restype = [], ctypes.c_int
    with torch.cuda.device(index):
        rc = fn()
    if rc != 0:
        raise RuntimeError(f"grid_select_setup failed on cuda:{index}: CUDA "
                           f"error {rc}")
    _set_up.add(index)


def _outputs(q: int, k: int, device):
    return (torch.empty((q, k), dtype=torch.float32, device=device),
            torch.empty((q, k), dtype=torch.int64, device=device),
            torch.empty((q, k), dtype=torch.int32, device=device))


def _launch(name: str, pointers, ints, q: int, k: int, device, what: str,
            setup: bool = False):
    """``(sq, idx, sel)`` of one launch of the entry ``name`` (built first
    if needed, and with ``setup`` the library set up on ``device``, which
    the blocked entry needs) on ``pointers`` and ``ints``; raises if it is
    refused."""
    global launches
    fn = _kernel_entry(name, len(pointers) + 3, len(ints))
    out = _outputs(q, k, device)
    if q == 0:
        return out
    if setup:
        _setup(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*pointers, *(t.data_ptr() for t in out), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"at {what}")
    launches += 1
    return out


def _check(name: str, queries, k: int, kk: int, width: int, tensors: dict):
    """Shared argument checks: ``queries [Q, d]`` f32 with d 2 or 3, the
    dtypes and device of ``tensors`` ({name: (tensor, dtype)}), the
    selection width.  Raises on what neither version takes; returns the
    device type."""
    if queries.dim() != 2 or queries.shape[1] not in (2, 3):
        raise ValueError(f"{name} expects queries [Q, 2 or 3], got shape "
                         f"{tuple(queries.shape)}")
    for what, (t, dtype) in {"queries": (queries, torch.float32),
                             **tensors}.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} expects {what} of {dtype}, got "
                            f"{t.dtype}")
        if t.device != queries.device:
            raise ValueError(f"{name}: {what} on {t.device}, queries on "
                             f"{queries.device}")
    if not 1 <= k <= width:
        raise ValueError(f"{name} needs 1 <= k <= W (k={k}, W={width})")
    if kk > MAX_K:
        raise ValueError(f"{name} selects at most {MAX_K} (the kernel's "
                         f"queue) a row, k={k} needs {kk}")
    device = queries.device.type
    if device not in ("cpu", "cuda"):
        raise RuntimeError(f"{name} has no kernel for device "
                           f"{queries.device}")
    if device == "cuda":
        for what, t in {"queries": queries,
                        **{w: t for w, (t, _) in tensors.items()}}.items():
            if not t.is_contiguous():
                raise ValueError(f"{name} expects a contiguous {what}")
    return device


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def grid_select_dilated(queries, dil_pts, dil_cand, flat, k: int,
                        sorted_rows: bool = True):
    """Distances of ``queries [Q, d]`` f32 to the candidates of their
    dilated rows ``flat [Q]`` int64 (``dil_pts [rows, W·d]`` f32,
    ``dil_cand [rows, W]`` int32) and the canonical k nearest: ``(sq
    [Q, k] f32, idx [Q, k] int64, sel [Q, k] int32)``, ``sel`` the slot.

    ``sorted_rows``: the rows are sorted by candidate index, so the k
    smallest by ``(sq, slot)`` are canonical; otherwise the ``k + 8``
    smallest are re-sorted by ``(sq, idx)`` and ties at equal ``(sq,
    idx)`` keep the lower slot.  A CPU tensor runs
    :func:`grid_select_dilated_plain`; a CUDA tensor launches the kernel."""
    width = dil_cand.shape[1] if dil_cand.dim() == 2 else -1
    if (flat.dim() != 1 or flat.shape[0] != queries.shape[0]
            or dil_cand.dim() != 2 or dil_pts.dim() != 2
            or dil_pts.shape != (dil_cand.shape[0], width * queries.shape[-1])):
        raise ValueError(
            f"grid_select_dilated: flat {tuple(flat.shape)}, dil_pts "
            f"{tuple(dil_pts.shape)}, dil_cand {tuple(dil_cand.shape)} do not "
            f"fit queries {tuple(queries.shape)}")
    kk = k if sorted_rows else min(k + 8, width)
    device = _check("grid_select_dilated", queries, k, kk, width,
                    {"dil_pts": (dil_pts, torch.float32),
                     "dil_cand": (dil_cand, torch.int32),
                     "flat": (flat, torch.int64)})
    if device == "cpu":
        return grid_select_dilated_plain(queries, dil_pts, dil_cand, flat, k,
                                         sorted_rows)
    q, d = queries.shape
    if width % 4 or not _aligned(dil_pts):
        raise ValueError(f"grid_select_dilated: the kernel reads groups of "
                         f"four candidates, 16-byte aligned (W={width})")
    return _launch("grid_select_dilated_f32",
                   [t.data_ptr() for t in (queries, dil_pts, dil_cand, flat)],
                   [q, d, width, k, kk, int(not sorted_rows)], q, k,
                   queries.device, f"queries [{q}, {d}], rows [{dil_cand.shape[0]}, {width}], "
                   f"k={k}, kk={kk}")


def grid_select_blocked(queries, cell_pts, cell_list, flat, k: int,
                        mask=None):
    """Distances of ``queries [Q, d]`` f32 to the members of the R blocked
    slabs ``flat [Q, R]`` int64 (``cell_pts [rows, C, d]`` f32,
    ``cell_list [rows, C]`` int32) and the canonical k nearest of the
    ``k + 8`` smallest by ``(sq, slot)``: ``(sq [Q, k] f32, idx [Q, k]
    int64, sel [Q, k] int32)``, slot ``s·C + m`` for member m of slab s.
    Rows ``mask [Q]`` (bool, optional) leaves out get ``(+inf, 0, 0)``.  A
    CPU tensor runs :func:`grid_select_blocked_plain`; a CUDA tensor
    launches the kernel."""
    if (flat.dim() != 2 or flat.shape[0] != queries.shape[0]
            or cell_list.dim() != 2 or cell_pts.dim() != 3
            or cell_pts.shape[:2] != cell_list.shape
            or cell_pts.shape[2] != queries.shape[-1]
            or (mask is not None and mask.shape != (queries.shape[0],))):
        raise ValueError(
            f"grid_select_blocked: flat {tuple(flat.shape)}, cell_pts "
            f"{tuple(cell_pts.shape)}, cell_list {tuple(cell_list.shape)}"
            f"{'' if mask is None else ', mask ' + str(tuple(mask.shape))} "
            f"do not fit queries {tuple(queries.shape)}")
    r, c = flat.shape[1], cell_list.shape[1]
    kk = min(k + 8, r * c)
    tensors = {"cell_pts": (cell_pts, torch.float32),
               "cell_list": (cell_list, torch.int32),
               "flat": (flat, torch.int64)}
    if mask is not None:
        tensors["mask"] = (mask, torch.bool)
    device = _check("grid_select_blocked", queries, k, kk, r * c, tensors)
    if device == "cpu":
        return grid_select_blocked_plain(queries, cell_pts, cell_list, flat,
                                         k, mask)
    q, d = queries.shape
    if c < 4 or c & (c - 1) or not _aligned(cell_pts):
        raise ValueError(f"grid_select_blocked: the kernel reads slabs of a "
                         f"power-of-two capacity C >= 4, 16-byte aligned "
                         f"(C={c})")
    return _launch("grid_select_blocked_f32",
                   [t.data_ptr() for t in (queries, cell_pts, cell_list,
                                           flat)]
                   + [None if mask is None else mask.data_ptr()],
                   [q, d, r, c, k, kk], q, k, queries.device,
                   f"queries [{q}, {d}], {r} slabs of {c}, k={k}, kk={kk}",
                   setup=True)
