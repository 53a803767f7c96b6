"""Tetrahedra (3D).

Port of the JAX package's ``geometry/tetrahedron.py``.  A point is inside
when it lies in each of the four half-spaces bounded by the faces: for each
face, the offset of the point from one corner of that face has no positive
component along the face's outward normal.  Faces and their reference
corners are paired as in the JAX package — (0, 1, 2) with corner 0,
(0, 1, 3) with 1, (0, 2, 3) with 2 and (1, 2, 3) with 3 — and the normals
are the same f64 cross products, so the offsets and dot products round
alike.
"""
import numpy as np

from .base import GeometryObject, as_like, dot


def _outward_normals(corners: np.ndarray) -> np.ndarray:
    """``[4, 3]`` f64 normals of the faces (0,1,2), (0,1,3), (0,2,3) and
    (1,2,3), each turned away from the opposite corner."""
    p = corners
    normals = np.stack([np.cross(p[1] - p[0], p[2] - p[0]),
                        np.cross(p[1] - p[0], p[3] - p[0]),
                        np.cross(p[2] - p[0], p[3] - p[0]),
                        np.cross(p[2] - p[1], p[3] - p[2])])
    centroid = p.mean(axis=0)
    towards_centroid = np.array([np.dot(centroid - p[i], normals[i])
                                 for i in range(4)])
    normals[towards_centroid > 0] *= -1
    return normals


class TetrahedronGeometry3D(GeometryObject):
    __short_description__ = "tetrahedra (3D)"

    def __init__(self, name: str, keep_inside: bool, positions,
                 refine: bool = False, min_refinement_level: int = None):
        """
        :param positions: the four corners ``[4, 3]``, in any order
        """
        super().__init__(name, keep_inside, refine, min_refinement_level)
        self._corners = np.asarray(positions, dtype=np.float64)
        self._type = "tetrahedron"
        self._check_geometry()
        self._normals = _outward_normals(self._corners)
        self._main_width = float((self._corners.max(axis=0)
                                  - self._corners.min(axis=0)).max())
        self._center = self._corners.mean(axis=0)

    def _trace_constants(self):
        return [self._corners]

    def _inside(self, points):
        outside = None
        for face in range(4):
            rel = [points[:, a] - as_like(points, self._corners[face, a])
                   for a in range(3)]
            normal = [as_like(points, v) for v in self._normals[face]]
            beyond = dot(rel, normal) > 0
            outside = beyond if outside is None else outside | beyond
        return ~outside

    def check_tetrahedron(self, vertices):
        """:meth:`mask_points` of ``vertices``, under the JAX package's name
        for the inside test that its pyramid geometry reuses."""
        return self.mask_points(vertices)

    def bounding_box(self):
        return self._corners.min(axis=0), self._corners.max(axis=0)

    def _check_geometry(self) -> None:
        if self._corners.shape != (4, 3):
            raise ValueError(
                f"A tetrahedron takes four corners of three components, "
                f"shape (4, 3); got {self._corners.shape}.")
        mat = np.concatenate([self._corners, np.ones((4, 1))], axis=1)
        if not abs(np.linalg.det(mat) / 6.0) > 0:
            raise ValueError(f"Tetrahedron {self.name} has zero volume; its "
                             f"four corners are coplanar.")

    @property
    def type(self) -> str:
        return self._type

    @property
    def main_width(self) -> float:
        return self._main_width

    @property
    def center(self):
        return self._center
