"""Inside tests of the benchmark's geometry specs, in plain PyTorch.

A spec is a dict ``{"type", "name", "keep_inside", ...}`` with optional
``refine`` and ``min_refinement_level``; the rest is the kind's own.  Each
kind is a file ``<SHAPES>/<type>.py`` that exposes ``inside(spec, p) ->
[M] bool`` (points on the boundary are inside unless the kind says
otherwise) and ``bounds(spec) -> (lo, hi)``, the corners of a box holding
the shape, in plain PyTorch and numpy.  A cell test follows the published
S³ rule on the cell's corner nodes: removal (an obstacle whose every node is
inside, a domain with no node inside) and, in the geometry phase, surface
proximity (an obstacle with a node inside, a domain with a node outside).
"""
from pathlib import Path

import numpy as np
import torch

# where the kinds are found; a test may point it at a directory of its own
SHAPES = Path(__file__).resolve().parent / "shapes"
_loaded = {}


def kind(spec: dict):
    """The module of ``spec``'s kind, loaded once."""
    path = SHAPES / f"{spec['type']}.py"
    if path not in _loaded:
        from harness import load_file
        _loaded[path] = load_file(path, "shape")
    return _loaded[path]


def width_and_center(spec: dict):
    """Edge and centre of the root cell a domain spec gives: the largest
    extent of its kind's bounds, centred on them."""
    lo, hi = kind(spec).bounds(spec)
    return float(np.max(hi - lo)), (lo + hi) / 2.0


def inside(spec: dict, p: torch.Tensor) -> torch.Tensor:
    """``[M]`` bool: which of the points ``p [M, d]`` lie inside."""
    return kind(spec).inside(spec, p)


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
