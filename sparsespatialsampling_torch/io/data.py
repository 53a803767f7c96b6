"""Host-side storage layer: HDF5 I/O and XDMF generation.

Public classes mirror the reference API surface (``Dataloader``, ``Datawriter``,
``XDMFWriter`` — reference: ``sparseSpatialSampling/data.py:22``, ``:303``,
``:504``) and write the identical HDF5 schema (groups ``constant`` / ``grid`` /
``data``; grid keys ``faces`` / ``centers`` / ``vertices``; temporal layout
``data/<time>/<field>_{center|vertices}``) so ParaView and the reference's
post-processing work unchanged.

Arrays are returned as numpy ndarrays, the same host format the JAX package
returns (``torch.from_numpy`` wraps them without a copy).  This module is a
copy of the JAX package's ``io/data.py``: it depends only on h5py +
numpy, so the port carries its own copy instead of importing the JAX
package.
"""
import logging
from os.path import join, isfile
from typing import Union, List

import numpy as np

from .const import DATA, GRID, CONST, CENTERS, VERTICES, FACES

logger = logging.getLogger(__name__)


def File(*args, **kwargs):
    """``h5py.File``, imported at first use: the package imports (and the
    grid generation runs) where h5py is not installed; only reading or
    writing HDF5 needs it."""
    from h5py import File as _File
    return _File(*args, **kwargs)


class Dataloader:
    """Load data from an :math:`S^3` HDF5 output file and assemble data matrices.

    Mirrors reference ``Dataloader`` (``data.py:22-300``): lazy cached
    properties over one HDF5 file.
    """

    def __init__(self, load_path: str, file_name: str, dtype=np.float32):
        self._load_path = load_path
        self._file_name = file_name
        self._dtype = np.dtype(dtype)

        self._load_header()

        # lazily loaded properties
        self._write_times = None
        self._weights = None  # cell areas (2D) / volumes (3D)
        self._levels = None
        self._metric = None
        self._field_names = None
        self._vertices = None
        self._faces = None
        self._nodes = None

    # -- lazy properties ---------------------------------------------------
    @property
    def write_times(self) -> List[str]:
        """All time-step keys present in the ``data`` group."""
        if self._write_times is None:
            with File(join(self._load_path, self._file_name), "r") as f:
                if DATA in f.keys():
                    self._write_times = list(f.get(f"{DATA}").keys())
        return self._write_times

    @property
    def weights(self) -> np.ndarray:
        """Cell areas (2D) or volumes (3D): ``(size_initial_cell / 2^level)^d``."""
        if self._weights is None:
            self._weights = np.squeeze(
                (self._size_initial_cell / np.power(2.0, self.levels.astype(np.float64)))
                ** self._n_dimensions
            )
        return self._weights

    @property
    def vertices(self) -> np.ndarray:
        """Cell *centers* of the grid (reference naming quirk kept: ``data.py:92-103``)."""
        if self._vertices is None:
            with File(join(self._load_path, self._file_name), "r") as f:
                self._vertices = np.asarray(f.get(f"{GRID}/{CENTERS}")[()])
        return self._vertices

    @property
    def nodes(self) -> np.ndarray:
        """Node (vertex) coordinates of the grid."""
        if self._nodes is None:
            with File(join(self._load_path, self._file_name), "r") as f:
                self._nodes = np.asarray(f.get(f"{GRID}/{VERTICES}")[()])
        return self._nodes

    @property
    def faces(self) -> np.ndarray:
        """Cell→node connectivity ``[N_cells, 2^d]``."""
        if self._faces is None:
            with File(join(self._load_path, self._file_name), "r") as f:
                self._faces = np.asarray(f.get(f"{GRID}/{FACES}")[()])
        return self._faces

    @property
    def field_names(self) -> dict:
        """Dict mapping each time step to the list of fields stored at cell centers."""
        if self._field_names is None:
            # strip the trailing "_center" suffix only (the reference's
            # ``split("_")[0]`` truncates field names containing underscores,
            # ``data.py:148``; this keeps such names intact)
            with File(join(self._load_path, self._file_name), "r") as f:
                self._field_names = {
                    k: [name[:-len("_center")] for name in f[f"{DATA}/{k}"].keys()
                        if name.endswith("_center")]
                    for k in f[DATA].keys()
                }
        return self._field_names

    @property
    def levels(self) -> np.ndarray:
        if self._levels is None:
            with File(join(self._load_path, self._file_name), "r") as f:
                self._levels = np.squeeze(np.asarray(f.get(f"{CONST}/levels")[()]))
        return self._levels

    @property
    def metric(self) -> np.ndarray:
        if self._metric is None:
            with File(join(self._load_path, self._file_name), "r") as f:
                self._metric = np.squeeze(np.asarray(f.get(f"{CONST}/metric")[()]))
        return self._metric

    @property
    def n_cells(self) -> int:
        return self._n_cells

    @property
    def n_dimensions(self) -> int:
        return self._n_dimensions

    @property
    def size_initial_cell(self):
        return self._size_initial_cell

    # -- path handling -----------------------------------------------------
    @property
    def load_path(self) -> str:
        return self._load_path

    @load_path.setter
    def load_path(self, value: str) -> None:
        self._load_path = value
        self._reset()

    @property
    def file_name(self) -> str:
        return self._file_name

    @file_name.setter
    def file_name(self, value: str) -> None:
        self._file_name = value
        self._reset()

    def _load_header(self) -> None:
        with File(join(self._load_path, self._file_name), "r") as f:
            centers = f.get(f"{GRID}/{CENTERS}")
            self._n_cells = centers.shape[0]
            self._n_dimensions = centers.shape[1]
            try:
                self._size_initial_cell = f.get(f"{CONST}/size_initial_cell")[()]
            except TypeError:
                self._size_initial_cell = None
                logger.warning("Could not load initial cell size.")

    def _reset(self) -> None:
        self._load_header()
        self._write_times = None
        self._weights = None
        self._levels = None
        self._field_names = None
        self._vertices = None
        self._faces = None
        self._nodes = None
        self._metric = None

    # -- snapshot assembly ---------------------------------------------------
    def load_snapshot(self, field_name: Union[List[str], str],
                      write_times: Union[str, List[str]] = None):
        """Assemble the data matrix for one or more fields.

        Returns ``[N_cells, N_snapshots]`` for scalar fields and
        ``[N_cells, N_comp, N_snapshots]`` for vector fields (a list of matrices
        if multiple fields are requested) — reference ``data.py:249-300``.
        """
        if write_times is None:
            write_times = self.write_times
        if isinstance(write_times, str):
            write_times = [write_times]
        if isinstance(field_name, str):
            field_name = [field_name]

        out = []
        with File(join(self._load_path, self._file_name), "r") as f:
            for name in field_name:
                shape = f.get(f"{DATA}/{write_times[0]}/{name}_center").shape
                if len(shape) == 1:
                    dm = np.zeros((self._n_cells, len(write_times)), dtype=self._dtype)
                    for i, t in enumerate(write_times):
                        dm[:, i] = f.get(f"{DATA}/{t}/{name}_center")[()]
                else:
                    dm = np.zeros((shape[0], shape[1], len(write_times)), dtype=self._dtype)
                    for i, t in enumerate(write_times):
                        dm[:, :, i] = f.get(f"{DATA}/{t}/{name}_center")[()]
                out.append(dm)

        return out[0] if len(out) == 1 else out


class Datawriter:
    """Thin h5py wrapper writing the reference schema (``data.py:303-449``)."""

    def __init__(self, file_path: str, file_name: str, mode: str = "w", mixed: bool = False):
        self._file_name = file_name
        self._mode = mode
        self._mixed = mixed
        self._file_path = file_path
        self._file = File(join(self._file_path, self._file_name), self._mode)

        self._data = None if DATA not in self._file.keys() else self._file[DATA]
        self._const = None if CONST not in self._file.keys() else self._file[CONST]
        self._grid = None if GRID not in self._file.keys() else self._file[GRID]
        self._n_cells = None

    def close(self) -> None:
        self._file.close()

    def write_grid(self, loader: Dataloader) -> None:
        """Copy a grid from another file via its ``Dataloader``."""
        self._n_cells = loader.vertices.shape[0]
        self.write_data(CENTERS, group=GRID, data=loader.vertices)
        self.write_data(VERTICES, group=GRID, data=loader.nodes)
        self.write_data(FACES, group=GRID, data=loader.faces)

    def write_data(self, name: str, data, group: str = CONST,
                   time_step: Union[int, float, str] = None) -> None:
        """Write one dataset into the ``constant`` / ``grid`` / ``data`` group.

        Temporal datasets are auto-suffixed ``_center`` / ``_vertices`` by
        matching the leading dimension against ``n_cells`` when the grid is
        known (reference ``data.py:386-391``).
        """
        data = np.asarray(data)

        if group == DATA and time_step is None:
            logger.warning(f"No time step for group 'data' provided. Writing data to '{DATA}/0'.")
            time_step = "0"

        if time_step is not None or group == DATA:
            if self._n_cells is not None and not (name.endswith("center") or name.endswith("vertices")):
                name = f"{name}_center" if data.shape[0] == self._n_cells else f"{name}_vertices"

            if self._data is None or str(time_step) not in self._file[DATA].keys():
                self._data = self._file.create_group(f"{DATA}/{time_step}")
            else:
                self._data = self._file[f"{DATA}/{time_step}"]

            try:
                self._data.create_dataset(name, data=data)
            except ValueError:
                logger.warning(f"Dataset {name} is already present in this time step "
                               f"of the HDF5 file — leaving it untouched.")

        elif group == CONST:
            if self._const is None:
                self._const = self._file.create_group(CONST)
            else:
                self._const = self._file[CONST]
            try:
                self._const.create_dataset(name, data=data)
            except ValueError:
                logger.warning(f"Constant dataset {name} is already present in the "
                               f"HDF5 file — leaving it untouched.")

        elif group == GRID:
            if self._grid is None:
                self._grid = self._file.create_group(GRID)
            else:
                self._grid = self._file[GRID]
            self._grid.create_dataset(name, data=data)

        else:
            raise ValueError(f"Unknown group '{group}', available groups are "
                             f"'{DATA}', '{CONST}' and '{GRID}'.")

    def write_xdmf_file(self) -> None:
        """Generate the companion XDMF file for the written HDF5 file."""
        if not isfile(join(self._file_path, self._file_name)):
            raise FileNotFoundError(
                f"Could not find {join(self._file_path, self._file_name)}.")

        logger.info(f"Writing XDMF file for file {self._file_name}")
        xdmf_writer = XDMFWriter(self._file_path, self._file_name, mixed=self._mixed)
        xdmf_writer.write_xdmf()
        self.close()

    @property
    def mode(self) -> str:
        return self._mode

    @mode.setter
    def mode(self, value) -> None:
        self._mode = value
        self._file = File(join(self._file_path, self._file_name), self._mode)

    @property
    def file_name(self) -> str:
        return self._file_name

    @property
    def n_cells(self) -> Union[int, None]:
        return self._n_cells

    @n_cells.setter
    def n_cells(self, value: int) -> None:
        self._n_cells = value


class XDMFWriter:
    """Generate an XDMF 2.0 file referencing the HDF5 datasets.

    Structure matches the reference writer (``data.py:504-777``): a temporal
    ``Collection`` grid when a ``data`` group exists, otherwise a constant
    grid; constant fields whose length matches N_cells / N_vertices are emitted
    as attributes (of the first time step in the temporal case).
    """

    def __init__(self, file_path: str, file_name: str, grid_name: str = "grid_s_cube",
                 mixed: bool = False):
        self._file_path = file_path
        self._grid_name = grid_name
        self._mixed = mixed
        self._hdf_file_name = file_name
        self._file = File(join(self._file_path, self._hdf_file_name), "r")
        self._header = '<?xml version="1.0"?>\n<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>\n<Xdmf Version="2.0">\n'
        self._temporal_grid = False
        self._const_attributes = False
        self._keys_const_attributes = []

        self._xdmf_file_name = f"{self._hdf_file_name.split('.h5')[0]}.xdmf"

        self._check_grid()

        self._n_dimensions = self._file.get(f"{GRID}/{CENTERS}").shape[-1]
        self._n_cells = self._file.get(f"{GRID}/{CENTERS}").shape[0]
        self._n_faces = self._file.get(f"{GRID}/{FACES}").shape[0]
        self._n_vertices = self._file.get(f"{GRID}/{VERTICES}").shape[0]

        if self._mixed:
            self._grid_type = "Mixed"
        else:
            self._grid_type = "Quadrilateral" if self._n_dimensions == 2 else "Hexahedron"
        self._dims = "XY" if self._n_dimensions == 2 else "XYZ"

    def write_xdmf(self) -> None:
        self._temporal_grid = bool(self._check_data())
        self._keys_const_attributes = self._get_const_keys()
        self._const_attributes = bool(self._keys_const_attributes)
        self._write_temporal_grid() if self._temporal_grid else self._write_const_grid()

    def _topology_and_geometry(self) -> str:
        tmp = (f'<Topology TopologyType="{self._grid_type}" NumberOfElements="{self._n_faces}">\n'
               f'<DataItem Format="HDF" DataType="Int" Dimensions="{self._n_faces}')
        tmp += '">\n' if self._mixed else f' {pow(2, self._n_dimensions)}">\n'
        tmp += f"{self._hdf_file_name}:/{GRID}/{FACES}\n"
        tmp += (f'</DataItem>\n</Topology>\n<Geometry GeometryType="{self._dims}">\n'
                f'<DataItem Rank="2" Dimensions="{self._n_vertices} {self._n_dimensions}" '
                f'NumberType="Float" Precision="8" Format="HDF">\n')
        tmp += f"{self._hdf_file_name}:/{GRID}/{VERTICES}\n</DataItem>\n</Geometry>\n"
        return tmp

    def _write_temporal_grid(self) -> None:
        _domain_header = (f'<Domain>\n<Grid Name="{self._grid_name}" GridType="Collection" '
                          f'CollectionType="temporal">\n')

        with open(join(self._file_path, self._xdmf_file_name), "w") as f_out:
            f_out.write(self._header)
            f_out.write(_domain_header)

            for i, t in enumerate(sorted(self._file.get(DATA).keys(), key=lambda x: float(x))):
                f_out.write(f'<Grid Name="{self._grid_name} {t}" GridType="Uniform">\n'
                            f'<Time Value="{t}"/>\n')
                f_out.write(self._topology_and_geometry())

                # constant fields go into the first time step
                if i == 0:
                    f_out.write(self._write_attributes())

                for k in self._file[f"{DATA}/{t}"].keys():
                    # datasets are written as <field_name>_<position>
                    _name = "_".join(k.split("_")[:-1]) if len(k.split("_")) > 1 else k
                    _shape = self._file.get(f"{DATA}/{t}/{k}").shape
                    _second_dim = 1 if len(_shape) == 1 else _shape[1]

                    if _shape[0] == self._n_cells:
                        center = "Cell"
                        n_rows = self._n_cells
                    elif _shape[0] == self._n_vertices:
                        center = "Node"
                        n_rows = self._n_vertices
                    else:
                        logger.warning(
                            f"Field in '{DATA}/{t}/{k}' with a size of {_shape} doesn't match "
                            f"N_cells = {self._n_cells} or N_vertices = {self._n_vertices}. "
                            f"Skipping this field.")
                        continue

                    f_out.write(f'<Attribute Name="{_name}" AttributeType="Vector" Center="{center}">\n'
                                f'<DataItem NumberType="Float" Precision="8" Format="HDF" '
                                f'Dimensions="{n_rows} {_second_dim}">\n')
                    f_out.write(f"{self._hdf_file_name}:/{DATA}/{t}/{k}\n</DataItem>\n</Attribute>\n")

                f_out.write('</Grid>\n')

            f_out.write('</Grid>\n</Domain>\n</Xdmf>')

    def _write_const_grid(self) -> None:
        with open(join(self._file_path, self._xdmf_file_name), "w") as f_out:
            f_out.write(self._header)
            f_out.write(f'<Domain>\n<Grid Name="{self._grid_name}" GridType="Uniform">\n')
            f_out.write(self._topology_and_geometry())
            f_out.write(self._write_attributes())
            f_out.write("</Grid>\n</Domain>\n</Xdmf>")

    def _write_attributes(self) -> str:
        str_to_write = []
        for k in self._keys_const_attributes:
            _shape = self._file.get(f"{CONST}/{k}").shape
            _second_dim = 1 if len(_shape) == 1 else _shape[1]

            if _shape[0] == self._n_cells:
                center, n_rows = "Cell", self._n_cells
            elif _shape[0] == self._n_vertices:
                center, n_rows = "Node", self._n_vertices
            else:
                logger.warning(
                    f"Field in '{CONST}/{k}' with a size of {_shape} doesn't match N_cells "
                    f"= {self._n_cells} or N_vertices = {self._n_vertices}. Skipping this field.")
                continue

            str_to_write.append(
                f'<Attribute Name="{k}" AttributeType="Vector" Center="{center}">\n<DataItem '
                f'NumberType="Float" Precision="8" Format="HDF" '
                f'Dimensions="{n_rows} {_second_dim}">\n'
                f'{self._hdf_file_name}:/{CONST}/{k}\n</DataItem>\n</Attribute>\n')

        return "".join(str_to_write)

    def _get_const_keys(self) -> list:
        keys = []
        if CONST in self._file.keys():
            for k in self._file[CONST].keys():
                shape = self._file.get(f"{CONST}/{k}").shape
                if not shape:
                    continue
                if self._n_cells == shape[0] or self._n_vertices == shape[0]:
                    keys.append(k)
        else:
            logger.info("Couldn't find any constant fields to write.")
        return keys

    def _check_data(self) -> bool:
        return DATA in self._file.keys()

    def _check_grid(self) -> None:
        if GRID not in self._file.keys():
            raise ValueError("Found no grid in the provided HDF5 file. "
                             "Unable to create XDMF file without a grid.")
        for key in (FACES, CENTERS, VERTICES):
            if key not in self._file[GRID].keys():
                raise ValueError(f"Unable to find '{key}' in group '{GRID}' of the HDF5 file.")
