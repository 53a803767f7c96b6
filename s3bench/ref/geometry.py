"""Inside tests of the benchmark's geometry specs, in plain PyTorch.

A spec is a dict: ``{"type": "cube", "name", "keep_inside", "lower",
"upper"}`` (inclusive bounds) or ``{"type": "polygon", "name",
"keep_inside", "coordinates"}`` (the even-odd rule: a point is inside when
a ray towards +x crosses the closed boundary an odd number of times; a
horizontal edge is crossed by no ray), each with optional ``refine`` and
``min_refinement_level``.  A cell test follows the published S³ rule on the
cell's corner nodes: removal (an obstacle whose every node is inside, a
domain with no node inside) and, in the geometry phase, surface proximity
(an obstacle with a node inside, a domain with a node outside).
"""
import numpy as np
import torch


def width_and_center(spec: dict):
    """Edge and centre of the root cell a domain spec gives: the largest
    extent of its box, centred on the box."""
    if spec["type"] == "cube":
        lo, hi = np.asarray(spec["lower"], float), np.asarray(spec["upper"],
                                                              float)
    else:
        pts = np.asarray(spec["coordinates"], float)
        lo, hi = pts.min(0), pts.max(0)
    return float(np.max(hi - lo)), (lo + hi) / 2.0


def inside(spec: dict, p: torch.Tensor) -> torch.Tensor:
    """``[M]`` bool: which of the points ``p [M, d]`` lie inside."""
    if spec["type"] == "cube":
        lo = torch.as_tensor(spec["lower"], dtype=p.dtype, device=p.device)
        hi = torch.as_tensor(spec["upper"], dtype=p.dtype, device=p.device)
        return ((p >= lo) & (p <= hi)).all(-1)
    if spec["type"] == "polygon":
        b = np.asarray(spec["coordinates"], dtype=np.float64)
        if not np.allclose(b[0], b[-1]):
            b = np.concatenate([b, b[:1]])
        e = torch.as_tensor(b, dtype=p.dtype, device=p.device)
        x1, y1, x2, y2 = e[:-1, 0], e[:-1, 1], e[1:, 0], e[1:, 1]
        rise = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
        out = []
        for lo in range(0, p.shape[0], 1 << 16):
            x, y = p[lo:lo + (1 << 16), 0:1], p[lo:lo + (1 << 16), 1:2]
            straddle = (y1 > y) != (y2 > y)
            x_cross = (x2 - x1) * (y - y1) / rise + x1
            out.append((straddle & (x < x_cross)).sum(1) % 2 == 1)
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                      device=p.device)
    raise ValueError(f"unknown geometry type {spec['type']!r}")


def cell_flags(spec: dict, nodes: torch.Tensor,
               surface: bool = False) -> torch.Tensor:
    """``[M]`` bool of cells given by their corner ``nodes [M, n, d]``:
    removal (``surface`` False) or surface proximity (True)."""
    m, n, d = nodes.shape
    mask = inside(spec, nodes.reshape(-1, d)).reshape(m, n)
    keep = spec["keep_inside"]
    if not surface:
        return ~mask.any(1) if keep else mask.all(1)
    return ~mask.all(1) if keep else mask.any(1)
