"""Base class for geometry objects.

Port of the JAX package's ``geometry/base.py``: every geometry exposes a
vectorised inside-test

    ``mask_points(points [M, d]) -> bool [M]``    (True = inside)

that takes a torch tensor on any device, or a numpy array.  On a tensor the
geometry's constants are cast to the tensor's dtype first, so the engine's
f32 corner nodes are tested in f32 exactly as the JAX package tests them;
on a numpy array the test runs in the array's own precision.
"""
import logging
from abc import ABC, abstractmethod

import numpy as np
import torch

logger = logging.getLogger(__name__)


def as_like(points, value):
    """``value`` as an array of ``points``' kind: a tensor of its dtype on
    its device, or a float64 numpy array."""
    if isinstance(points, torch.Tensor):
        return torch.as_tensor(np.asarray(value), dtype=points.dtype,
                               device=points.device)
    return np.asarray(value, dtype=np.float64)


def squared_norm(delta):
    """``Σ_a delta[..., a]²``: explicit adds in axis order for a tensor (the
    order XLA reduces three terms in), numpy's own sum for an array."""
    if isinstance(delta, torch.Tensor):
        dd = delta * delta
        out = dd[..., 0]
        for a in range(1, dd.shape[-1]):
            out = out + dd[..., a]
        return out
    return (delta * delta).sum(axis=-1)


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

    @abstractmethod
    def mask_points(self, points):
        """Vectorised inside-test: ``points [M, d]`` (tensor or numpy) →
        bool ``[M]``, True for points inside (or on the surface of) the
        geometry."""

    def check_cells(self, cell_nodes, refine_geometry: bool = False):
        """Vectorised cell test on ``cell_nodes [M, n_nodes, d]``.  With
        ``refine_geometry=False`` it decides *removal* (obstacle: all nodes
        inside; domain: no node inside); with True it decides *surface
        proximity* (obstacle: any node inside; domain: any node outside) —
        reference semantics ``geometry_base.py:40-76``."""
        m, n, d = cell_nodes.shape
        mask = self.mask_points(cell_nodes.reshape(m * n, d)).reshape(m, n)
        return apply_mask(mask, self._keep_inside, refine_geometry)

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
