from .knn import KNNIndex, index_from_reference
from .interpolate import interpolate_data
from .topk import topk_smallest
from . import morton

__all__ = ["KNNIndex", "index_from_reference", "interpolate_data",
           "topk_smallest", "morton"]
