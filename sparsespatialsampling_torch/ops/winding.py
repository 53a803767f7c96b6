"""Generalized winding number of a triangle mesh: the exact inside test of
an STL geometry.

Counterpart of the JAX package's ``geometry/stl.py:_omega`` and
``_winding_number`` (an XLA program there, not a Pallas kernel):
``w(p) = Σ_t 2·atan2(det_t, denom_t) / 4π`` with the van Oosterom–Strackee
solid angle of each triangle seen from ``p``.  A closed mesh gives about 1
inside and about 0 outside; a point is inside when ``w > 0.5``.

- :func:`winding_number` is the wrapper: a CUDA tensor goes to the
  hand-written kernel ``csrc/winding_number.cu`` (built at first use by
  ``_build.py``) or the call raises; a CPU tensor goes to the plain
  version.  There is no fallback from one to the other.
- :func:`winding_number_plain` is the plain PyTorch version, chunked over
  (point, triangle) pairs to bound memory.
- ``launches`` counts the kernel launches, and nothing else.

Both take an optional ``count``, a one-element int32 tensor on the points'
device: only the first ``count`` rows of ``points`` are evaluated, and the
rows from ``count`` on get ``w = 0``.  The STL near band is compacted to
the front of a fixed-size batch and its size stays on the device, so the
kernel reads it there (nothing waits for the device); its grid is sized by
the batch, and the blocks past the count do nothing.

Every product, sum and difference of ``det`` and ``denom`` rounds alone,
in a fixed order, and the norms are correctly rounded square roots, so the
kernel, the plain version on the card and the plain version on the CPU
compute the same ``det`` and ``denom`` bit for bit.  ``atan2`` takes them
in f64 and the angles are summed in f64, so ``w`` agrees to an f32 ulp
between them even where ``atan2`` is ill-conditioned (points on an edge).
The JAX package rounds otherwise (f32 ``atan2``, fused multiply-adds):
``w`` agrees with it to about 1e-6 away from the surface.
"""
import ctypes
import math

import torch

from .knn import _sqrt

# kernel launches of :func:`winding_number` (plain-version calls not counted)
launches = 0

_KERNEL = "winding_number"
# (point, triangle) pairs the plain version evaluates at once: bounds each
# of its [rows, triangles] f32 temporaries to 8 MB
_PAIRS_PER_CHUNK = 1 << 21
# bytes of the kernel's f64 partial sums a launch may use: 16,611 points
# at 258,480 triangles, 83,055 at 51,552
_PART_BYTES = 1 << 27


def half_angles(p, w0, w1, w2) -> torch.Tensor:
    """``atan2(det, denom)`` in f64 of every triangle ``(w0, w1, w2)`` seen
    from its point: ``p [q, 1, 3]`` f32, triangle vertices broadcasting to
    ``[q, n, 3]`` f32; returns ``[q, n]`` f64 (half of each solid angle)."""
    ax, ay, az = (w0 - p).unbind(-1)
    bx, by, bz = (w1 - p).unbind(-1)
    cx, cy, cz = (w2 - p).unbind(-1)
    la = _sqrt(ax * ax + ay * ay + az * az)
    lb = _sqrt(bx * bx + by * by + bz * bz)
    lc = _sqrt(cx * cx + cy * cy + cz * cz)
    kx = by * cz - bz * cy
    ky = bz * cx - bx * cz
    kz = bx * cy - by * cx
    det = ax * kx + ay * ky + az * kz
    denom = (la * lb * lc + (ax * bx + ay * by + az * bz) * lc
             + (bx * cx + by * cy + bz * cz) * la
             + (cx * ax + cy * ay + cz * az) * lb)
    return torch.atan2(det.double(), denom.double())


def winding_number_plain(points: torch.Tensor, v0: torch.Tensor,
                         v1: torch.Tensor, v2: torch.Tensor,
                         count: torch.Tensor = None) -> torch.Tensor:
    """``w [M]`` f32 of ``points [M, 3]`` against the triangles ``v0, v1,
    v2 [T, 3]`` (f32), the angles summed in f64: the kernel's function,
    evaluated in chunks of at most ``_PAIRS_PER_CHUNK`` pairs.  With
    ``count`` (read back here) only the first ``count`` rows, the rest
    0."""
    if count is not None:
        n = min(max(int(count.reshape(-1)[0]), 0), points.shape[0])
        w = torch.zeros(points.shape[0], dtype=torch.float32,
                        device=points.device)
        w[:n] = winding_number_plain(points[:n], v0, v1, v2)
        return w
    m, t = points.shape[0], v0.shape[0]
    acc = torch.zeros(m, dtype=torch.float64, device=points.device)
    rows = max(1, min(m, _PAIRS_PER_CHUNK // max(t, 1)))
    cols = max(1, _PAIRS_PER_CHUNK // rows)
    for lo in range(0, m, rows):
        p = points[lo:lo + rows, None, :]
        for t0 in range(0, t, cols):
            acc[lo:lo + rows] += half_angles(
                p, v0[None, t0:t0 + cols], v1[None, t0:t0 + cols],
                v2[None, t0:t0 + cols]).sum(dim=1)
    return (acc / (2.0 * math.pi)).to(torch.float32)


_entry = None


def _kernel_entry():
    """The C entry points of the built kernel, their argument types set."""
    global _entry
    if _entry is None:
        from .. import _build
        lib = _build.load(_KERNEL)
        splits = lib.winding_number_splits
        splits.argtypes = [ctypes.c_int]
        splits.restype = ctypes.c_int
        fn = lib.winding_number_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _entry = (fn, splits)
    return _entry


def _launch(points, v0, v1, v2, count) -> torch.Tensor:
    """The kernel over ``points`` in slices whose f64 partial sums (one per
    256 triangles and point) fit in ``_PART_BYTES``; a point's ``w`` does
    not depend on its slice.  The slices follow the batch's size, never
    ``count``: each launch evaluates its rows below ``count`` (all of them
    without one).  Counts each launch."""
    global launches
    fn, splits = _kernel_entry()
    m, t = points.shape[0], v0.shape[0]
    dev = points.device
    spans = splits(t)
    step = max(1, min(m, _PART_BYTES // (8 * spans)))
    part = torch.empty(spans * step, dtype=torch.float64, device=dev)
    w = torch.empty(m, dtype=torch.float32, device=dev)
    count_ptr = None if count is None else count.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, m, step):
            n = min(step, m - lo)
            rc = fn(points[lo:].data_ptr(), v0.data_ptr(), v1.data_ptr(),
                    v2.data_ptr(), count_ptr, lo, n, t, part.data_ptr(),
                    w[lo:].data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(
                    f"winding_number kernel launch failed: CUDA error {rc} "
                    f"at points [{n}, 3], triangles [{t}, 3]")
            launches += 1
    return w


def winding_number(points: torch.Tensor, v0: torch.Tensor, v1: torch.Tensor,
                   v2: torch.Tensor, count: torch.Tensor = None
                   ) -> torch.Tensor:
    """Winding number ``w [M]`` f32 of the mesh of triangles ``(v0, v1, v2)``
    (each ``[T, 3]`` f32) at ``points [M, 3]`` f32; with ``count`` (a
    one-element int32 tensor on the points' device) at the first ``count``
    points only, ``w = 0`` at the rest.

    A CPU tensor runs :func:`winding_number_plain`; a CUDA tensor launches
    the hand-written kernel.  Any other device, dtype or layout raises."""
    tensors = (points, v0, v1, v2)
    if any(x.dim() != 2 or x.shape[1] != 3 for x in tensors):
        raise ValueError(f"winding_number expects [M, 3] points and [T, 3] "
                         f"vertex arrays, got shapes "
                         f"{[tuple(x.shape) for x in tensors]}")
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"winding_number expects float32, got "
                        f"{[x.dtype for x in tensors]}")
    t = v0.shape[0]
    if v1.shape[0] != t or v2.shape[0] != t or t == 0:
        raise ValueError(f"winding_number needs three equal, non-empty vertex "
                         f"arrays, got {[x.shape[0] for x in tensors[1:]]}")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("winding_number: points and triangles lie on "
                         "different devices")
    if count is not None and (count.dtype != torch.int32
                              or count.numel() != 1
                              or count.device != points.device):
        raise ValueError(f"winding_number: count must be one int32 on the "
                         f"points' device, got {count.dtype} "
                         f"{tuple(count.shape)} on {count.device}")
    if points.device.type == "cpu":
        return winding_number_plain(points, v0, v1, v2, count)
    if points.device.type != "cuda":
        raise RuntimeError(f"winding_number has no kernel for device "
                           f"{points.device}")
    if not all(x.is_contiguous() for x in tensors) or (
            count is not None and not count.is_contiguous()):
        raise ValueError("winding_number expects contiguous tensors")
    m = points.shape[0]
    if m >= 2 ** 31 or t >= 2 ** 31:
        raise ValueError(f"winding_number: {m} points or {t} triangles "
                         f"exceed the int32 count")
    if m == 0:
        return torch.empty(0, dtype=torch.float32, device=points.device)
    return _launch(points, v0, v1, v2, count)
