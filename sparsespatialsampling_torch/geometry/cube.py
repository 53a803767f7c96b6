"""Axis-aligned rectangles (2D) / boxes (3D) as geometry objects.

Port of the JAX package's ``geometry/cube.py`` (reference
``sparseSpatialSampling/geometry/cube_geometry.py``).
"""
import numpy as np

from .base import GeometryObject, as_like


class CubeGeometry(GeometryObject):
    __short_description__ = "rectangles (2D) or cubes (3D)"

    def __init__(self, name: str, keep_inside: bool, lower_bound: list,
                 upper_bound: list, refine: bool = False,
                 min_refinement_level: int = None):
        super().__init__(name, keep_inside, refine, min_refinement_level)
        self._lower_bound = list(lower_bound)
        self._upper_bound = list(upper_bound)
        self._type = "cube"
        self._check_geometry()
        self._lower = np.asarray(self._lower_bound, dtype=np.float64)
        self._upper = np.asarray(self._upper_bound, dtype=np.float64)
        self._main_width = float(np.max(np.abs(self._upper - self._lower)))
        self._center = (self._lower + self._upper) / 2.0

    def _trace_constants(self):
        return [self._lower, self._upper]

    def _inside(self, points):
        if points.shape[-1] != len(self._lower_bound):
            raise ValueError(
                f"Dimension mismatch for geometry {self.name}: the queried "
                f"points are {points.shape[-1]}-D but the box bounds have "
                f"{len(self._lower_bound)} components.")
        inside = ((points >= as_like(points, self._lower))
                  & (points <= as_like(points, self._upper)))
        return inside.all(-1)

    def bounding_box(self):
        return self._lower, self._upper

    def _check_geometry(self) -> None:
        if not self._lower_bound or not self._upper_bound:
            raise ValueError("The box needs a lower and an upper corner.")
        if len(self._lower_bound) != len(self._upper_bound):
            raise ValueError(
                f"Lower and upper corner of geometry {self.name} must have "
                f"the same number of components; got "
                f"{len(self._lower_bound)} vs {len(self._upper_bound)}.")
        for i, (lo, up) in enumerate(zip(self._lower_bound,
                                         self._upper_bound)):
            if not lo < up:
                raise ValueError(
                    f"Degenerate box for geometry {self.name}: along axis "
                    f"{i} the lower bound {lo} is not strictly below the "
                    f"upper bound {up}.")

    @property
    def type(self) -> str:
        return self._type

    @property
    def main_width(self) -> float:
        return self._main_width

    @property
    def center(self):
        return self._center
