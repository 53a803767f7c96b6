"""Circles (2D) / spheres (3D) as geometry objects.

Port of the JAX package's ``geometry/sphere.py`` (reference
``sparseSpatialSampling/geometry/sphere_geometry.py``).
"""
import numpy as np

from .base import GeometryObject, as_like, dot


class SphereGeometry(GeometryObject):
    __short_description__ = "circles (2D) or spheres (3D)"

    def __init__(self, name: str, keep_inside: bool, position: list, radius,
                 refine: bool = False, min_refinement_level: int = None):
        super().__init__(name, keep_inside, refine, min_refinement_level)
        self._position = list(position)
        self._radius = radius
        self._type = "sphere"
        self._check_geometry()
        self._main_width = float(self._radius)
        self._center = np.asarray(self._position, dtype=np.float64)

    def _trace_constants(self):
        return [self._center, float(self._radius)]

    def _inside(self, points):
        if points.shape[-1] != len(self._position):
            raise ValueError(
                f"Dimension mismatch for geometry {self.name}: the queried "
                f"points are {points.shape[-1]}-D but the sphere center has "
                f"{len(self._position)} components.")
        delta = points - as_like(points, self._center)
        rel = [delta[:, a] for a in range(delta.shape[1])]
        return dot(rel, rel) <= self._radius ** 2

    def bounding_box(self):
        return self._center - self._radius, self._center + self._radius

    def _check_geometry(self) -> None:
        if not self._position:
            raise ValueError("The sphere needs its center coordinates — the "
                             "position list is empty.")
        if not isinstance(self._radius, (int, float)):
            raise TypeError(f"radius of geometry {self.name} must be a plain "
                            f"number; got {type(self._radius)}.")
        if self._radius <= 0:
            raise ValueError(f"radius must be positive; got {self._radius}.")

    @property
    def type(self) -> str:
        return self._type

    @property
    def main_width(self) -> float:
        return self._main_width

    @property
    def center(self):
        return self._center
