"""The least work of one ``grid_select`` launch, from its arguments.

A frozen copy of ``chip_smoke.py``'s ``grid_bound`` (the bound of the port's
kernel table): the bytes the call must move against its operations.
Bytes: the live rows' queries, row ids and (blocked) mask, the candidates'
coordinates counted once for each distinct row or slab the live rows
read, the selected ids, the outputs.  Operations: per candidate d
subtractions, a product and a compare in float32, d - 1 products and sums
in float64.  Only live rows count: a blocked row the mask leaves out
costs its filler's write alone.

:func:`bound_terms` enqueues the counts on the device without reading
them back (so it may run between two launches of a timed run);
:func:`bound_seconds` turns them into seconds once they are on the host.
"""
import torch

# the module whose entries launch the kernel, the entries, and the
# substring of the kernel's name in a device trace
MODULE = "sparsespatialsampling_torch.ops.grid_select"
ENTRIES = ("grid_select_dilated", "grid_select_blocked")
KERNEL = "grid_select"


def _distinct(ids: torch.Tensor, live: torch.Tensor = None) -> torch.Tensor:
    """Distinct values of ``ids`` (of the rows ``live`` keeps), as a
    device scalar: a sort and a count of steps, no read back."""
    if live is not None:
        ids = torch.where(live.reshape(live.shape + (1,) * (ids.dim() - 1)),
                          ids, -1)
    s = torch.sort(ids.reshape(-1)).values
    if s.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=ids.device)
    steps = ((s[1:] != s[:-1]) & (s[1:] >= 0)).sum()
    return steps + (s[0] >= 0).long()


def bound_terms(entry: str, a: dict) -> tuple:
    """``(shape facts, device counts)`` of one launch of ``entry`` with the
    arguments ``a`` (by name).  The facts are host ints; the counts a
    device tensor ``[live rows, distinct rows or slabs]``."""
    queries, k, flat = a["queries"], a["k"], a["flat"]
    q, d = queries.shape
    if entry == "grid_select_dilated":
        w = a["dil_cand"].shape[1]
        facts = {"entry": entry, "q": q, "d": d, "k": k, "w": w, "r": 1,
                 "kk": k if a.get("sorted_rows", True) else min(k + 8, w),
                 "row_width": w, "masked": False}
        live = torch.full((), q, dtype=torch.int64, device=flat.device)
        return facts, torch.stack([live, _distinct(flat)])
    c = a["cell_list"].shape[1]
    r = flat.shape[1]
    mask = a.get("mask")
    facts = {"entry": entry, "q": q, "d": d, "k": k, "w": r * c, "r": r,
             "kk": min(k + 8, r * c), "row_width": c,
             "masked": mask is not None}
    live = (torch.full((), q, dtype=torch.int64, device=flat.device)
            if mask is None else mask.sum())
    return facts, torch.stack([live, _distinct(flat, mask)])


def bound_seconds(facts: dict, counts, peaks: dict) -> float:
    """The least time of the launch: bytes over the memory rate against
    operations over their rates, whichever is longer."""
    live, distinct = int(counts[0]), int(counts[1])
    q, d, k, w, r, kk = (facts[x] for x in ("q", "d", "k", "w", "r", "kk"))
    coords = distinct * facts["row_width"] * d * 4
    if facts["entry"] == "grid_select_dilated":
        ids = live * (8 + kk * 4)
    else:
        ids = live * (r * 8 + kk * 4) + (q if facts["masked"] else 0)
    fixed = live * d * 4 + ids + q * k * 16
    n = live * w
    t_ops = (n * (d + 2) / peaks["f32_ops_per_s"]
             + n * 2 * (d - 1) / peaks["f64_ops_per_s"])
    return max((coords + fixed) / peaks["hbm_bytes_per_s"], t_ops)
