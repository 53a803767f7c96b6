from .base import GeometryObject, apply_mask
from .coordinates_2d import GeometryCoordinates2D
from .cube import CubeGeometry
from .cylinder import CylinderGeometry3D
from .prism import PrismGeometry3D
from .pyramid import PyramidGeometry3D
from .sphere import SphereGeometry
from .stl import GeometrySTL3D
from .tetrahedron import TetrahedronGeometry3D
from .triangle import TriangleGeometry

__all__ = ["GeometryObject", "apply_mask", "CubeGeometry", "SphereGeometry",
           "CylinderGeometry3D", "GeometryCoordinates2D", "TriangleGeometry",
           "TetrahedronGeometry3D", "PrismGeometry3D", "PyramidGeometry3D",
           "GeometrySTL3D"]
