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

All helpers are vectorized numpy (they run once per refinement epoch on
index-sized arrays); heavy numerics run on the device.  Copy of the part of
the JAX package's ``ops/morton.py`` that the port uses (it may not import
that module).
"""
import numpy as np

# maximum lattice depth per dimensionality such that node keys fit in int64
MAX_DEPTH = {2: 30, 3: 20}


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the lower 32 bits of x so there is a zero bit between each."""
    x = x.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the lower 21 bits of x so there are two zero bits between each."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def encode(coords: np.ndarray) -> np.ndarray:
    """Interleave integer coordinates ``[N, d]`` into Morton codes ``[N]`` (uint64)."""
    d = coords.shape[-1]
    if d == 2:
        return _part1by1(coords[..., 0]) | (_part1by1(coords[..., 1]) << np.uint64(1))
    if d == 3:
        return (_part1by2(coords[..., 0])
                | (_part1by2(coords[..., 1]) << np.uint64(1))
                | (_part1by2(coords[..., 2]) << np.uint64(2)))
    raise ValueError(f"Unsupported dimensionality {d}.")


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
