"""Pyramids on a quadrilateral base (3D).

Port of the JAX package's ``geometry/pyramid.py``.  The five vertices may
come in any order.  The base is the plane through the most vertices, the
apex the vertex farthest from it, and the base's main diagonal the longest
distance between two base vertices.  Splitting the base along that
diagonal cuts the pyramid into two tetrahedra, built with their corners in
the JAX package's order; a point is inside when it is inside either, so a
point on the shared face is inside.
"""
from itertools import combinations

import numpy as np

from .base import GeometryObject
from .tetrahedron import TetrahedronGeometry3D

# a vertex closer than this to a plane lies in it
_PLANE_TOL = 1e-6


def _apex_index(vertices: np.ndarray) -> int:
    """The vertex farthest from the plane, through three of the vertices,
    that holds the most vertices (the first such plane in index order)."""
    best, plane = 0, None
    for i, j, k in combinations(range(len(vertices)), 3):
        normal = np.cross(vertices[j] - vertices[i], vertices[k] - vertices[i])
        length = np.linalg.norm(normal)
        if length < 1e-12:
            continue
        normal = normal / length
        held = int((np.abs((vertices - vertices[i]) @ normal)
                    < _PLANE_TOL).sum())
        if held > best:
            best, plane = held, (vertices[i], normal)
    if plane is None:
        raise ValueError("The pyramid's vertices are collinear: they span "
                         "no base plane.")
    origin, normal = plane
    return int(np.argmax(np.abs((vertices - origin) @ normal)))


class PyramidGeometry3D(GeometryObject):
    __short_description__ = "pyramids with quadrilateral base (3D)"

    def __init__(self, name: str, keep_inside: bool, nodes,
                 refine: bool = False, min_refinement_level: int = None):
        """
        :param nodes: the five vertices, four of the base and the apex, in
            any order
        """
        super().__init__(name, keep_inside, refine, min_refinement_level)
        self._nodes = nodes
        self._type = "pyramid"
        self._check_geometry()
        vertices = np.asarray(nodes, dtype=np.float64)
        self._vertices = vertices
        apex = _apex_index(vertices)
        base = [i for i in range(5) if i != apex]
        # the first longest pair in index order is the main diagonal
        pairs = list(combinations(base, 2))
        lengths = [np.sum((vertices[a] - vertices[b]) ** 2) for a, b in pairs]
        d0, d1 = pairs[int(np.argmax(lengths))]
        o0, o1 = [i for i in base if i not in (d0, d1)]
        self._halves = [
            TetrahedronGeometry3D(f"{name}_half0", keep_inside,
                                  vertices[[d0, o0, d1, apex]]),
            TetrahedronGeometry3D(f"{name}_half1", keep_inside,
                                  vertices[[d1, o1, d0, apex]])]
        self._main_width = float(max(t.main_width for t in self._halves))
        self._center = np.mean([t.center for t in self._halves], axis=0)

    def _trace_constants(self):
        return [self._vertices]

    def _inside(self, points):
        return self._halves[0]._inside(points) | self._halves[1]._inside(
            points)

    def bounding_box(self):
        return self._vertices.min(axis=0), self._vertices.max(axis=0)

    def _check_geometry(self) -> None:
        if len(self._nodes) != 5:
            raise ValueError(f"A pyramid has five vertices; got "
                             f"{len(self._nodes)}.")
        for i, v in enumerate(self._nodes):
            if not isinstance(v, (list, tuple, np.ndarray)):
                raise TypeError(f"Vertex {i} of pyramid {self.name} must be "
                                f"a list, tuple or array; got {type(v)}.")
            if len(v) != 3:
                raise ValueError(f"Vertex {i} of pyramid {self.name} needs "
                                 f"three components; got {len(v)}.")

    @property
    def type(self) -> str:
        return self._type

    @property
    def main_width(self) -> float:
        return self._main_width

    @property
    def center(self):
        return self._center
