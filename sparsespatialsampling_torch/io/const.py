"""Shared constants defining the on-disk HDF5 schema.

The schema is bit-compatible with the reference implementation
(``sparseSpatialSampling/const.py:5-17``) so that files written
by this framework can be read by the reference's post-processing scripts and by
ParaView via the generated XDMF files, and vice versa.
"""

# group holding constant (time-independent) attributes
CONST = "constant"

# group holding the grid (faces / centers / vertices)
GRID = "grid"

# group holding the temporal data, one sub-group per write time
DATA = "data"

# dataset names inside the grid group
FACES = "faces"
CENTERS = "centers"
VERTICES = "vertices"
