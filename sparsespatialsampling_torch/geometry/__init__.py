from .base import GeometryObject, apply_mask
from .cube import CubeGeometry
from .sphere import SphereGeometry

__all__ = ["GeometryObject", "apply_mask", "CubeGeometry", "SphereGeometry"]
