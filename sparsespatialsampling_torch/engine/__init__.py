from .tree import SamplingTree

__all__ = ["SamplingTree"]
