"""Triangles (2D).

Port of the JAX package's ``geometry/triangle.py``.  Walking the boundary
p0 → p1 → p2 → p0, a point is inside, or on an edge, when the 2D cross
products of each edge with the point's offset from that edge's reference
corner do not take both signs.  The edges are measured from p0, p1 and p0
in turn, as the JAX package measures them, so the products round alike.
"""
import numpy as np

from .base import GeometryObject, as_like, fma


def _cross(edge, rel_x, rel_y):
    """``edge × rel = edge_x·rel_y − edge_y·rel_x`` with the first product
    fused into the subtraction, as XLA compiles it."""
    return fma(rel_y, edge[0], -(rel_x * edge[1]))


class TriangleGeometry(GeometryObject):
    __short_description__ = "triangles (2D)"

    def __init__(self, name: str, keep_inside: bool, points,
                 refine: bool = False, min_refinement_level: int = None):
        """
        :param points: the three corners ``[[x, y], [x, y], [x, y]]``
        """
        super().__init__(name, keep_inside, refine, min_refinement_level)
        self._points = points
        self._type = "triangle"
        self._check_geometry()
        corners = np.asarray(points, dtype=np.float64)
        self._corners = corners
        # (edge vector, reference corner) of p0→p1, p1→p2 and p2→p0
        self._edges = [(corners[1] - corners[0], corners[0]),
                       (corners[2] - corners[1], corners[1]),
                       (corners[0] - corners[2], corners[0])]
        lower, upper = self.bounding_box()
        self._main_width = float(np.max(upper - lower))
        self._center = corners.mean(axis=0)

    def _trace_constants(self):
        return list(self._corners)

    def _inside(self, points):
        sides = [_cross(as_like(points, edge),
                        points[:, 0] - as_like(points, ref[0]),
                        points[:, 1] - as_like(points, ref[1]))
                 for edge, ref in self._edges]
        neg = (sides[0] < 0) | (sides[1] < 0) | (sides[2] < 0)
        pos = (sides[0] > 0) | (sides[1] > 0) | (sides[2] > 0)
        return ~(neg & pos)

    def check_triangle(self, vertices):
        """:meth:`mask_points` of ``vertices``, under the JAX package's name
        for the inside test that its prism geometry reuses."""
        return self.mask_points(vertices)

    def bounding_box(self):
        return self._corners.min(axis=0), self._corners.max(axis=0)

    def _check_geometry(self) -> None:
        if not isinstance(self._points, (list, tuple, np.ndarray)):
            raise TypeError(
                f"The corners of triangle {self.name} must be a list, tuple "
                f"or array; got {type(self._points)}.")
        if len(self._points) != 3:
            raise ValueError(f"A triangle has three corners; got "
                             f"{len(self._points)}.")
        if any(len(p) != 2 for p in self._points):
            raise ValueError(f"Each corner of triangle {self.name} needs "
                             f"two components, x and y.")
        c = np.asarray(self._points, dtype=np.float64)
        u, v = c[1] - c[0], c[2] - c[0]
        area = 0.5 * abs(u[0] * v[1] - u[1] * v[0])
        if not area > 0:
            raise ValueError(f"Triangle {self.name} has zero area; its "
                             f"corners are collinear.")

    @property
    def type(self) -> str:
        return self._type

    @property
    def main_width(self) -> float:
        return self._main_width

    @property
    def center(self):
        return self._center
