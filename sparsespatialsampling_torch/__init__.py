"""sparsespatialsampling_torch — the PyTorch/CUDA port of S³ (sparse spatial
sampling) for NVIDIA Hopper.

Metric-driven adaptive quadtree/octree grid generation for CFD data
reduction, snapshot interpolation and HDF5/XDMF export, with the public API
and file schema of the JAX package it is ported from (the reference,
kept beside it in the repository): every closed-form geometry, STL
surfaces (``GeometrySTL3D``), the bbox pre-select route and the 2:1 balance
(``max_delta_level``), and the analysis layer: the weighted SVD of the
exported snapshots (``compute_svd``, ``write_svd_s_cube_to_file``), exact
DMD (``compute_dmd``) and the flowtorch-gated OpenFOAM loaders.  The
numerics run on a torch device (``device=None`` means the card); the grid
kNN scores and selects its candidates in a hand-written CUDA kernel
(``csrc/grid_select.cu``), the full scan selects through another
(``csrc/topk_smallest.cu``), and the STL inside test sums its near-band
winding numbers through a third (``csrc/winding_number.cu``).  This package imports no JAX.
"""
from .version import __version__
from .sparse_spatial_sampling import (SparseSpatialSampling, list_geometries,
                                      load_s_cube)
from .export import ExportData, Fields
from .io import Dataloader, Datawriter, XDMFWriter
from .utils import (compute_svd, compute_dmd, write_svd_s_cube_to_file,
                    load_foam_data, load_original_Foam_fields,
                    export_openfoam_fields)
from .geometry import (GeometryObject, CubeGeometry, SphereGeometry,
                       CylinderGeometry3D, GeometryCoordinates2D,
                       TriangleGeometry, TetrahedronGeometry3D,
                       PrismGeometry3D, PyramidGeometry3D, GeometrySTL3D)

__all__ = [
    "__version__",
    "SparseSpatialSampling", "list_geometries", "load_s_cube",
    "ExportData", "Fields",
    "Dataloader", "Datawriter", "XDMFWriter",
    "compute_svd", "compute_dmd", "write_svd_s_cube_to_file", "load_foam_data",
    "load_original_Foam_fields", "export_openfoam_fields",
    "GeometryObject", "CubeGeometry", "SphereGeometry",
    "CylinderGeometry3D", "GeometryCoordinates2D", "TriangleGeometry",
    "TetrahedronGeometry3D", "PrismGeometry3D", "PyramidGeometry3D",
    "GeometrySTL3D",
]
