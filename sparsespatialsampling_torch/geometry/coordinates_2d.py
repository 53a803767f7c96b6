"""Closed 2D polygons given by their boundary coordinates.

Port of the JAX package's ``geometry/coordinates_2d.py``.  A point is inside
when a ray from it towards +x crosses the boundary an odd number of times
(the even-odd rule), tested over every (point, edge) pair.  The crossing
abscissa of an edge is ``(x2 − x1)·(y − y1) / (y2 − y1) + x1``; a
horizontal edge is straddled by no ray, so its divisor is set to 1 only to
keep the division finite.  XLA compiles the JAX package's expression into a
multiplication by each edge's f32 reciprocal and one fused multiply-add,
and so does this port.
"""
import numpy as np
import torch

from .base import GeometryObject, as_like, fma, reciprocal

# (point, edge) pairs tested at once: bounds the [rows, E] temporaries
# (the f64 multiply-add among them) to a few tens of MB
_PAIRS_PER_CHUNK = 1 << 22


class GeometryCoordinates2D(GeometryObject):
    __short_description__ = "2D coordinates for geometries"

    def __init__(self, name: str, keep_inside: bool, coordinates,
                 refine: bool = False, min_refinement_level: int = None):
        """
        :param coordinates: boundary points ``[E, 2]`` in order; the polygon
            is closed automatically when the last point is not the first
        """
        super().__init__(name, keep_inside, refine, min_refinement_level)
        boundary = np.asarray(coordinates, dtype=np.float64)
        if boundary.ndim != 2 or boundary.shape[1] != 2:
            raise ValueError(
                f"The boundary of polygon {name} must be an [E, 2] array of "
                f"2D points; got shape {boundary.shape}.")
        if not np.allclose(boundary[0], boundary[-1]):
            boundary = np.concatenate([boundary, boundary[:1]])
        self._coordinates = boundary
        self._type = "coord_2D"
        self._lower_bound = boundary.min(axis=0)
        self._upper_bound = boundary.max(axis=0)
        self._main_width = float(np.max(self._upper_bound
                                        - self._lower_bound))
        self._center = (self._lower_bound + self._upper_bound) / 2.0
        # per-edge constants, differences taken in f64 (as the JAX package
        # takes them on numpy arrays before they reach the device)
        start, end = boundary[:-1], boundary[1:]
        self._x_start, self._y_start = start[:, 0], start[:, 1]
        self._y_end = end[:, 1]
        self._run = end[:, 0] - start[:, 0]
        rise = end[:, 1] - start[:, 1]
        self._rise = np.where(rise == 0.0, 1.0, rise)

    def _trace_constants(self):
        return [self._coordinates]

    def _inside(self, points):
        x_start = as_like(points, self._x_start)
        y_start = as_like(points, self._y_start)
        y_end = as_like(points, self._y_end)
        run = as_like(points, self._run)
        inv_rise = reciprocal(points, self._rise)
        rows = max(1, _PAIRS_PER_CHUNK // self._run.size)
        out = []
        for lo in range(0, points.shape[0], rows):
            x = points[lo:lo + rows, 0:1]
            y = points[lo:lo + rows, 1:2]
            straddles = (y_start > y) != (y_end > y)
            x_cross = fma(run * (y - y_start), inv_rise, x_start)
            crossings = (straddles & (x < x_cross)).sum(dim=1)
            out.append(crossings % 2 == 1)
        if not out:
            return torch.zeros(0, dtype=torch.bool, device=points.device)
        return torch.cat(out)

    def bounding_box(self):
        return self._lower_bound, self._upper_bound

    @property
    def type(self) -> str:
        return self._type

    @property
    def main_width(self) -> float:
        return self._main_width

    @property
    def center(self):
        return self._center
