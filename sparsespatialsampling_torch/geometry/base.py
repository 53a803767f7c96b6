"""Base class for geometry objects.

Port of the JAX package's ``geometry/base.py``: every geometry exposes a
vectorised inside-test

    ``mask_points(points [M, d]) -> bool [M]``    (True = inside)

that takes a torch tensor on any device, or a numpy array.  On a tensor the
geometry's constants are cast to the tensor's dtype first, so the engine's
f32 corner nodes are tested in f32 exactly as the JAX package tests them;
a numpy array is tested as a CPU tensor of its own precision (f32 stays
f32, anything else is f64) and answered as a numpy array.

The f32 arithmetic of each predicate is the one XLA's CPU backend compiles
the JAX package's expression to, so the port's flags equal the JAX
package's bit for bit on the same f32 points, and the card gives the CPU's
flags: a product followed by an add or a subtract is one fused
multiply-add (:func:`fma`, emulated through f64), a division by a
constant is a multiplication by the constant's f32 reciprocal
(:func:`reciprocal`), and sums over the coordinate axis run in axis order.
Square roots are correctly rounded (:func:`sqrt`).
"""
import hashlib
import logging
from abc import ABC, abstractmethod
from functools import lru_cache

import numpy as np
import torch

from ..ops.knn import _fma as fma
from ..ops.knn import _sqrt as sqrt

logger = logging.getLogger(__name__)


def _host_constant(arr: np.ndarray, dtype: torch.dtype,
                   recip: bool) -> torch.Tensor:
    t = torch.as_tensor(arr, dtype=dtype)
    return torch.ones((), dtype=dtype) / t if recip else t


@lru_cache(maxsize=4096)
def _card_constant(data: bytes, shape: tuple, src: str, dtype: torch.dtype,
                   device: torch.device, recip: bool) -> torch.Tensor:
    """A geometry constant on the card, made once: a copy from host memory
    waits for the device, and the device-resident adaptive loop tests
    geometries without waiting.  Callers never write to the tensor."""
    arr = np.frombuffer(data, dtype=src).reshape(shape).copy()
    return _host_constant(arr, dtype, recip).to(device)


def _constant(points: torch.Tensor, value, recip: bool) -> torch.Tensor:
    arr = np.asarray(value)
    if points.device.type == "cpu":
        return _host_constant(arr, points.dtype, recip)
    return _card_constant(arr.tobytes(), arr.shape, arr.dtype.str,
                          points.dtype, points.device, recip)


def as_like(points: torch.Tensor, value) -> torch.Tensor:
    """``value`` as a tensor of ``points``' dtype on its device."""
    return _constant(points, value, False)


def reciprocal(points: torch.Tensor, value) -> torch.Tensor:
    """``1 / value`` rounded once in ``points``' dtype, on its device: what
    XLA folds a division by the constant ``value`` into."""
    return _constant(points, value, True)


def dot(u, v) -> torch.Tensor:
    """``Σ_a u[a]·v[a]`` over coordinate components given as sequences,
    the first product rounded alone and each later one added by a fused
    multiply-add: XLA's CPU reduction of ``(u * v).sum(-1)``."""
    out = u[0] * v[0]
    for a in range(1, len(u)):
        out = fma(u[a], v[a], out)
    return out


class GeometryObject(ABC):
    def __init__(self, name: str, keep_inside: bool, refine: bool = False,
                 min_refinement_level: int = None):
        """
        :param name: name of the geometry object
        :param keep_inside: if True, points inside the object are kept
            (the object represents the numerical domain); if False they are
            masked out (the object is an obstacle)
        :param refine: if True, the grid around the geometry surface is
            refined after the metric-based refinement
        :param min_refinement_level: target level for the geometry
            refinement; if None and ``refine=True`` the max level present at
            the surface is used
        """
        self._name = name
        self._keep_inside = keep_inside
        self._refine = refine
        self._min_refinement_level = min_refinement_level
        self._check_common_arguments()

    def mask_points(self, points):
        """Vectorised inside-test: ``points [M, d]`` (tensor or numpy) →
        bool ``[M]``, True for points inside (or on the surface of) the
        geometry; a tensor for a tensor, a numpy array otherwise."""
        if isinstance(points, torch.Tensor):
            return self._inside(points)
        arr = np.asarray(points)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float64)
        return self._inside(torch.from_numpy(arr)).numpy()

    @abstractmethod
    def _inside(self, points: torch.Tensor) -> torch.Tensor:
        """:meth:`mask_points` on a float tensor ``[M, d]``."""

    def check_cells(self, cell_nodes, refine_geometry: bool = False):
        """Vectorised cell test on ``cell_nodes [M, n_nodes, d]``.  With
        ``refine_geometry=False`` it decides *removal* (obstacle: all nodes
        inside; domain: no node inside); with True it decides *surface
        proximity* (obstacle: any node inside; domain: any node outside) —
        reference semantics ``geometry_base.py:40-76``."""
        m, n, d = cell_nodes.shape
        mask = self.mask_points(cell_nodes.reshape(m * n, d)).reshape(m, n)
        return apply_mask(mask, self._keep_inside, refine_geometry)

    def check_cell(self, cell_nodes, refine_geometry: bool = False) -> bool:
        """:meth:`check_cells` of one cell's nodes ``[n_nodes, d]``, tested
        in f64 (the JAX package's single-cell API)."""
        nodes = np.asarray(cell_nodes, dtype=np.float64)[None]
        return bool(self.check_cells(nodes, refine_geometry)[0])

    def pre_check_cell(self, cell_nodes,
                       refine_geometry: bool = False) -> bool:
        """:meth:`check_cell` against the bounding box instead of the
        geometry itself, where there is one: the cheap test that settles
        cells the box already decides."""
        bounds = self.bounding_box()
        if bounds is None:
            return self.check_cell(cell_nodes, refine_geometry)
        lower, upper = bounds
        nodes = np.asarray(cell_nodes, dtype=np.float64)
        in_box = ((nodes >= lower) & (nodes <= upper)).all(-1)
        return bool(apply_mask(in_box[None], self._keep_inside,
                               refine_geometry)[0])

    def bounding_box(self):
        """``(lower, upper)`` f64 corners of an axis-aligned box holding
        the geometry, or None where the geometry offers none."""
        return None

    @property
    def cache_key(self):
        """A stable digest of what decides the geometry's flags: its
        class, polarity and defining constants (:meth:`_trace_constants`),
        the JAX package's digest of the same values; ``None`` where a
        subclass declares no constants."""
        if getattr(self, "_cache_key_val", None) is None:
            parts = self._trace_constants()
            if parts is None:
                return None
            h = hashlib.blake2b(digest_size=16)
            h.update(type(self).__name__.encode())
            h.update(b"1" if self._keep_inside else b"0")
            for p in parts:
                a = np.asarray(p)
                h.update(f"|{a.dtype}|{a.shape}|".encode())
                h.update(np.ascontiguousarray(a).tobytes())
            self._cache_key_val = h.hexdigest()
        return self._cache_key_val

    def _trace_constants(self):
        """The arrays and scalars that decide :meth:`mask_points` (the JAX
        package's own list for each class); ``None``: no digest."""
        return None

    @property
    def device_table_bytes(self) -> int:
        """Bytes of the lookup tables a query reads: none for a closed-form
        geometry.  The engine routes a geometry above its budget as the
        JAX package does (``engine/tree._FUSED_GEO_BYTES``)."""
        return 0

    def _check_common_arguments(self) -> None:
        if self._name == "":
            raise ValueError("Every geometry object needs a non-empty name.")
        if not isinstance(self._keep_inside, bool):
            raise TypeError(f"keep_inside must be a bool (True = domain, "
                            f"False = obstacle); got "
                            f"{type(self._keep_inside)}.")
        # a provided min_refinement_level implies refine=True
        if not self._refine and self._min_refinement_level is not None:
            logger.warning(
                f"Geometry {self._name} sets min_refinement_level="
                f"{self._min_refinement_level} but refine={self._refine}; a "
                f"target level only makes sense with surface refinement, so "
                f"refine is being switched on.")
            self._refine = True
        if (self._refine and self._min_refinement_level is not None
                and self._min_refinement_level <= 0):
            raise ValueError(f"min_refinement_level must be a positive level "
                             f"count; got {self._min_refinement_level}.")

    @property
    def keep_inside(self):
        return self._keep_inside

    @property
    def name(self):
        return self._name

    @property
    def refine(self):
        return self._refine

    @property
    def min_refinement_level(self):
        return self._min_refinement_level

    @property
    @abstractmethod
    def type(self) -> str:
        """Short type tag (``cube``, ``sphere``)."""

    @property
    @abstractmethod
    def main_width(self) -> float:
        """Width of the dominant dimension (sizes the root cell)."""

    @property
    @abstractmethod
    def center(self):
        """Geometric centre (positions the root cell)."""


def apply_mask(mask, keep_inside: bool, refine_geometry: bool):
    """Reduce a per-node inside-mask ``[M, n_nodes]`` to per-cell flags
    (reference truth table ``geometry_base.py:40-76``):

    - removal: an obstacle invalidates a cell only if *all* nodes are
      inside; a domain invalidates a cell if *no* node is inside;
    - refine-geometry: an obstacle flags a cell if *any* node is inside; a
      domain flags a cell if *any* node is outside."""
    if not refine_geometry:
        if not keep_inside:
            return mask.all(-1)
        return ~mask.any(-1)
    if not keep_inside:
        return mask.any(-1)
    return ~mask.all(-1)
