"""Triangular prisms extruded along a coordinate axis (3D).

Port of the JAX package's ``geometry/prism.py``.  The prism is given by its
two end faces ``[[p1, p2, p3], [q1, q2, q3]]``, where each ``q`` is its
``p`` moved along one coordinate axis.  A point is inside when its
projection onto ``q1 − p1`` lies in ``[0, |q1 − p1|]`` and its two in-plane
coordinates lie inside the end triangle, edges included.
"""
import numpy as np

from .base import GeometryObject, as_like, dot, reciprocal
from .triangle import TriangleGeometry


class PrismGeometry3D(GeometryObject):
    __short_description__ = "triangular prisms, axis-aligned (3D)"

    def __init__(self, name: str, keep_inside: bool, positions,
                 refine: bool = False, min_refinement_level: int = None):
        """
        :param positions: the start and the end face, three corners each
        """
        super().__init__(name, keep_inside, refine, min_refinement_level)
        self._positions = positions
        self._type = "prism"
        self._check_geometry()
        faces = [np.asarray(f, dtype=np.float64) for f in positions]
        self._faces = faces
        self._origin = faces[0][0]
        self._axis = faces[1][0] - faces[0][0]
        self._length = float(np.linalg.norm(self._axis))
        # the two coordinates spanning the faces' plane
        self._plane = np.nonzero(self._axis == 0)[0]
        if (len(self._plane) != 2
                or not np.allclose(faces[0][:, self._plane],
                                   faces[1][:, self._plane])):
            raise ValueError(
                f"The faces of prism {name} are not aligned along a "
                f"coordinate axis: the end face must be the start face "
                f"moved along x, y or z.")
        self._section = TriangleGeometry(f"{name}_section", True,
                                         faces[0][:, self._plane])
        self._main_width = float(max(self._length,
                                     self._section.main_width))
        self._center = np.concatenate(faces).mean(axis=0)

    def _trace_constants(self):
        return list(self._faces)

    def _inside(self, points):
        rel = [points[:, a] - as_like(points, self._origin[a])
               for a in range(3)]
        ax = [as_like(points, v) for v in self._axis]
        projection = dot(rel, ax) * reciprocal(points, self._length)
        within = (projection >= 0) & (projection <= as_like(points,
                                                            self._length))
        plane = points[:, self._plane.tolist()]
        return within & self._section._inside(plane)

    def bounding_box(self):
        corners = np.concatenate(self._faces)
        return corners.min(axis=0), corners.max(axis=0)

    def _check_geometry(self) -> None:
        if len(self._positions) != 2:
            raise ValueError(
                f"Prism {self.name} takes two faces, start and end; got "
                f"{len(self._positions)}.")
        if any(len(face) != 3 for face in self._positions):
            raise ValueError(f"Each face of prism {self.name} needs three "
                             f"corners.")

    @property
    def type(self) -> str:
        return self._type

    @property
    def main_width(self) -> float:
        return self._main_width

    @property
    def center(self):
        return self._center
