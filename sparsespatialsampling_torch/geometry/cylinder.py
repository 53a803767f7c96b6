"""Cylinders, cones and conical frusta (3D).

Port of the JAX package's ``geometry/cylinder.py``.  The solid runs along
the segment from ``start`` to ``end``.  A point is inside when its
projection onto the axis lies in ``[0, |end − start|]`` and its distance
from the axis line, ``|axis × (p − start)| / |axis|``, is at most the
radius, which a frustum interpolates linearly from the start radius to the
end radius.
"""
import numpy as np

from .base import GeometryObject, as_like, dot, fma, reciprocal, sqrt


class CylinderGeometry3D(GeometryObject):
    __short_description__ = "cylinders, conical objects and cones (3D)"

    def __init__(self, name: str, keep_inside: bool, position, radius,
                 refine: bool = False, min_refinement_level: int = None):
        """
        :param position: ``[start, end]``, the centres of the two end discs
        :param radius: one radius (a cylinder), or the radii at ``start``
            and ``end`` (a frustum; a cone where one of them is 0)
        """
        super().__init__(name, keep_inside, refine, min_refinement_level)
        self._position = position
        self._radius = radius
        self._type = "cylinder"
        self._check_geometry()
        ends = np.asarray(position, dtype=np.float64)
        self._start = ends[0]
        self._end = ends[1]
        self._axis = ends[1] - ends[0]
        self._length = float(np.linalg.norm(self._axis))
        r_max = (radius if isinstance(radius, (int, float))
                 else max(radius))
        self._r_max = float(r_max)
        self._main_width = float(max(r_max, self._length))
        self._center = ends.mean(axis=0)

    def _trace_constants(self):
        return [np.asarray(self._position, dtype=np.float64),
                np.asarray(self._radius, dtype=np.float64)]

    def _inside(self, points):
        rel = [points[:, a] - as_like(points, self._start[a])
               for a in range(3)]
        ax = [as_like(points, self._axis[a]) for a in range(3)]
        inv_len = reciprocal(points, self._length)
        # axial coordinate (before the division by |axis|)
        along = dot(rel, ax)
        projection = along * inv_len
        within = (projection >= 0) & (projection <= as_like(points,
                                                            self._length))
        # axis × rel, each component's first product fused into the add
        cross = [fma(ax[1], rel[2], -(ax[2] * rel[1])),
                 fma(ax[2], rel[0], -(ax[0] * rel[2])),
                 fma(ax[0], rel[1], -(ax[1] * rel[0]))]
        distance = sqrt(dot(cross, cross)) * inv_len
        if isinstance(self._radius, (int, float)):
            return within & (distance <= as_like(points, self._radius))
        r0, r1 = self._radius
        # r0 + projection / |axis| · (r1 − r0), whose constants XLA folds
        # into one slope applied to the axial coordinate
        slope = inv_len * (inv_len * as_like(points, r1 - r0))
        local = fma(along, slope, as_like(points, r0))
        return within & (distance <= local)

    def bounding_box(self):
        lower = np.minimum(self._start, self._end) - self._r_max
        upper = np.maximum(self._start, self._end) + self._r_max
        return lower, upper

    def _check_geometry(self) -> None:
        if len(self._position) != 2:
            raise ValueError(
                f"Cylinder {self.name} takes its axis as exactly two end "
                f"points; got {len(self._position)}.")
        if list(self._position[0]) == list(self._position[1]):
            raise ValueError(
                f"The two axis end points of cylinder {self.name} coincide; "
                f"the axis needs a nonzero length.")
        r = self._radius
        if not isinstance(r, (int, float, list, tuple)):
            raise TypeError(
                f"radius of cylinder {self.name} must be a number or a pair "
                f"of numbers; got {type(r)}.")
        if isinstance(r, (int, float)):
            if r <= 0:
                raise ValueError(f"radius must be positive; got {r}.")
            return
        if len(r) != 2:
            raise ValueError(
                f"A frustum takes one radius per end point, two in all; "
                f"got {len(r)}.")
        if r[0] < 0 or r[1] < 0:
            raise ValueError(f"Radii cannot be negative; got {r}.")
        if r[0] == 0 and r[1] == 0:
            raise ValueError(
                f"At least one of the two radii must be positive; got {r}.")

    @property
    def type(self) -> str:
        return self._type

    @property
    def main_width(self) -> float:
        return self._main_width

    @property
    def center(self):
        return self._center
