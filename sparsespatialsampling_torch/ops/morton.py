"""Morton (Z-order) codes and lattice arithmetic.

The engine replaces the reference's pointer-based octree — ``Cell``
objects with 8/26 neighbor references wired by ~280 lines of hard-coded
relation tables (``sparseSpatialSampling/s_cube.py:904-1186``) and ~350 lines
of per-child node-dedup case analysis (``s_cube.py:1188-1537``) — with flat
arrays keyed by *(level, integer lattice coordinates)*.  On this implicit
lattice, parent/child/neighbor relations and topological node identity are
pure integer arithmetic:

- child coords   = ``2 * coords + offset``, ``offset ∈ {0, 1}^d``
- corner nodes   = ``(coords + offset) << (D - level)`` on the depth-D lattice
- neighbor cell  = ``coords + dir``, ``dir ∈ {-1, 0, 1}^d``

The lattice helpers are vectorized numpy (they run once per refinement
epoch on index-sized arrays); :func:`encode_tensor` gives the kNN index's
Morton order on its device.  Copy of the part of
the JAX package's ``ops/morton.py`` that the port uses (it may not import
that module).
"""
import numpy as np
import torch

# maximum lattice depth per dimensionality such that node keys fit in int64
MAX_DEPTH = {2: 30, 3: 20}


# the bit-spreading steps of :func:`encode`: the input mask, then each
# ``x = (x | x << shift) & mask``; one table for numpy's uint64 and
# torch's int64 codes (every mask is below 2^63)
_SPREAD = {
    2: (0xFFFFFFFF, ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                     (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                     (1, 0x5555555555555555))),
    3: (0x1FFFFF, ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                   (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                   (2, 0x1249249249249249))),
}


def _spread(x, d: int):
    """Spread the bits of ``x`` so ``d - 1`` zero bits lie between each (a
    uint64 array or an int64 tensor)."""
    if d not in _SPREAD:
        raise ValueError(f"Unsupported dimensionality {d}.")
    first, steps = _SPREAD[d]
    if isinstance(x, torch.Tensor):
        x = x & first
        for shift, mask in steps:
            x = (x | (x << shift)) & mask
        return x
    x = x.astype(np.uint64) & np.uint64(first)
    for shift, mask in steps:
        x = (x | (x << np.uint64(shift))) & np.uint64(mask)
    return x


def encode(coords: np.ndarray) -> np.ndarray:
    """Interleave integer coordinates ``[N, d]`` into Morton codes ``[N]`` (uint64)."""
    d = coords.shape[-1]
    code = _spread(coords[..., 0], d)
    for ax in range(1, d):
        code = code | (_spread(coords[..., ax], d) << np.uint64(ax))
    return code


def encode_tensor(coords: torch.Tensor) -> torch.Tensor:
    """:func:`encode` of int64 coordinates ``[N, d]`` on their device, as
    int64 codes: at the lattice depths of :data:`MAX_DEPTH` a code is below
    2^60, so the signed codes order as the uint64 ones do."""
    d = coords.shape[-1]
    code = _spread(coords[..., 0], d)
    for ax in range(1, d):
        code = code | (_spread(coords[..., ax], d) << ax)
    return code


def anchor(coords: np.ndarray, level: np.ndarray, depth: int) -> np.ndarray:
    """Morton code of a cell's first descendant on the depth-``depth``
    lattice (uint64): the start of the range of codes the cell owns."""
    d = coords.shape[-1]
    shift = np.uint64(d) * (np.uint64(depth) - level.astype(np.uint64))
    return encode(coords) << shift


def range_size(level: np.ndarray, d: int, depth: int) -> np.ndarray:
    """Number of depth-``depth`` Morton codes a cell at ``level`` owns
    (uint64)."""
    return np.uint64(1) << (np.uint64(d)
                            * (np.uint64(depth) - level.astype(np.uint64)))


def node_keys(coords: np.ndarray, level: np.ndarray, corner_offsets: np.ndarray,
              depth: int) -> np.ndarray:
    """Unique integer keys of the corner nodes of each cell.

    Topological node identity without any floating-point comparison (the same
    guarantee the reference engineers via its case analysis,
    ``s_cube.py:1193-1196``): corners are points of the ``(2^D + 1)^d`` node
    lattice at depth ``D = depth``; the key is the raveled multi-index.

    :param coords: ``[N, d]`` cell lattice coords (at each cell's own level)
    :param level: ``[N]`` cell levels
    :param corner_offsets: ``[2^d, d]`` corner offsets in {0, 1}
    :param depth: lattice depth D (>= max level)
    :return: ``[N, 2^d]`` int64 node keys
    """
    d = coords.shape[-1]
    shift = (depth - level.astype(np.int64))[:, None, None]  # [N, 1, 1]
    corner = (coords[:, None, :] + corner_offsets[None, :, :]) << shift  # [N, 2^d, d]
    base = np.int64((1 << depth) + 1)
    key = corner[..., 0]
    for axis in range(1, d):
        key = key * base + corner[..., axis]
    return key


def decode_node_keys(keys: np.ndarray, d: int, depth: int) -> np.ndarray:
    """Inverse of the raveling in :func:`node_keys`: keys ``[M]`` → lattice
    coords ``[M, d]`` on the node lattice."""
    base = np.int64((1 << depth) + 1)
    out = np.empty((keys.shape[0], d), dtype=np.int64)
    k = keys.astype(np.int64)
    for axis in range(d - 1, -1, -1):
        out[:, axis] = k % base
        k = k // base
    return out
