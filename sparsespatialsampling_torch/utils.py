"""Workflow helpers: weighted SVD and DMD of S³ results, and OpenFOAM
ingestion.

Port of the JAX package's ``utils.py`` (the reference's ``utils`` module,
``sparseSpatialSampling/utils.py:23-413``).  The SVD and DMD run on a
torch device (``ops/svd.py``, ``ops/dmd.py``; ``device=None`` means the
card) and return numpy arrays.  The OpenFOAM loaders depend on
``flowtorch`` and are gated — they raise a clear ImportError when flowtorch
is unavailable instead of breaking the package import.

Above the randomized-SVD threshold, ``compute_svd`` shards the rows over
the mesh (``parallel.distributed_rsvd``) where sharding is enabled, as the
JAX package does.
"""
import logging
from typing import Tuple, Union

import numpy as np
import torch

from . import trace
from ._device import resolve_device
from .io.data import Dataloader, Datawriter
from .io.const import CONST
from .ops.svd import (economy_svd_device, randomized_svd_device,
                      optimal_rank, optimal_rank_sketched, frobenius_sq)
from .ops.dmd import exact_dmd
from .parallel import distributed_rsvd_device, make_mesh, sharding_enabled

logger = logging.getLogger(__name__)

# randomized SVD kicks in above this many matrix rows: beyond reference-tutorial
# scale, the exact SVD's cost grows as O(m n^2) while the rSVD sketch stays
# a few matmuls + an [l, n] SVD
_RSVD_ROW_THRESHOLD = 500_000


def _require_flowtorch():
    try:
        from flowtorch.data import FOAMDataloader, mask_box
        return FOAMDataloader, mask_box
    except ImportError as e:
        raise ImportError(
            "OpenFOAM ingestion requires the optional dependency 'flowtorch' "
            "(https://github.com/FlowModelingControl/flowtorch). Install it or load your "
            "CFD data with any other tool and pass (coordinates, data) arrays directly to "
            "SparseSpatialSampling / ExportData.export().") from e


def _device_copy(a, device) -> torch.Tensor:
    """An f32 copy of ``a`` on ``device`` that may be written in place."""
    return torch.as_tensor(a, dtype=torch.float32).to(device, copy=True)


def _sqrt_area(cell_area) -> np.ndarray:
    """``sqrt(cell_area)`` in host f32, rounded as the JAX package's numpy
    ``sqrt`` rounds it."""
    return np.sqrt(torch.as_tensor(cell_area, dtype=torch.float32)
                   .cpu().numpy())


def compute_svd(data_matrix, cell_area, rank: int = None,
                device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weighted SVD of a snapshot matrix: rows are weighted by
    ``sqrt(cell_area)`` before the decomposition and the returned modes are
    un-weighted (reference ``compute_svd``, ``utils.py:302-346``).

    :param data_matrix: ``[N_cells, N_snapshots]`` (scalar) or
        ``[N_cells, N_comp, N_snapshots]`` (vector) snapshot matrix; the last
        axis is time (numpy array or tensor)
    :param cell_area: ``[N_cells]`` cell areas (2D) / volumes (3D)
    :param rank: number of modes; if None the Gavish-Donoho optimal rank is used
    :param device: torch device of the decomposition; None means ``cuda``
    :return: ``(s, U, V)`` numpy — singular values, spatial modes, temporal
        coefficients (``V[:, i]`` is the i-th mode's time series)
    """
    dev = resolve_device(device)
    data = _device_copy(data_matrix, dev)
    field_shape = data.shape

    # subtract the temporal mean
    data -= data.mean(dim=-1, keepdim=True)

    sqrt_area = torch.from_numpy(_sqrt_area(cell_area)).to(dev)
    if data.ndim == 2:
        data *= sqrt_area[:, None]
        stacked = data
    else:
        data *= sqrt_area[:, None, None]
        # stack components row-wise for one joint decomposition
        stacked = data.reshape(field_shape[0] * field_shape[1], field_shape[-1])

    if stacked.shape[0] > _RSVD_ROW_THRESHOLD:
        # beyond reference-tutorial scale the exact SVD's O(m n²) cost
        # dominates; sketch generously when no rank was requested and
        # truncate by the optimal-rank criterion afterwards
        sketch = rank if rank is not None else min(stacked.shape[1], 256)
        if sharding_enabled(dev):
            # rows sharded over the mesh, the Gram sums on its root
            u, s, v = distributed_rsvd_device(stacked, sketch,
                                              make_mesh(device=dev))
            u = u.to(dev)
        else:
            u, s, v = randomized_svd_device(stacked, sketch)
        s, v = s.cpu().numpy(), v.cpu().numpy()
        if rank is None:
            # Gavish-Donoho needs the FULL spectrum's median; the sketch only
            # carries the top values, so the unseen tail's noise floor is
            # reconstructed from the Frobenius-energy balance (exact Σs² is
            # known from the data matrix itself)
            logger.info(
                f"Automatic rank selection on the randomized-SVD path (> "
                f"{_RSVD_ROW_THRESHOLD} rows) uses a Frobenius-tail estimate "
                f"of the unseen spectrum; pass an explicit 'rank' for exact "
                f"control.")
            fro_sq = frobenius_sq(stacked)
            rank = optimal_rank_sketched(s, stacked.shape, fro_sq)
            u, s, v = u[:, :rank], s[:rank], v[:, :rank]
    else:
        # an explicit rank bounds the materialized mode/V columns up front
        # (s still carries the full spectrum for the auto-rank criterion)
        u, s, v = economy_svd_device(stacked, max_rank=rank)
        if rank is None:
            rank = optimal_rank(s, stacked.shape)
        rank = min(rank, u.shape[1])
        u, s, v = u[:, :rank], s[:rank], v[:, :rank]

    if data.ndim == 2:
        return s, (u / sqrt_area[:, None]).cpu().numpy(), v
    u = u.reshape(field_shape[0], field_shape[1], -1)
    return s, (u / sqrt_area[:, None, None]).cpu().numpy(), v


# sub-phase wall times of the LAST write_svd_s_cube_to_file call (summed
# over its fields), each its spans': t_load = HDF5 snapshot/weights reads
# (``svd.load``), t_compute = compute_svd (``svd.compute``), t_write =
# mode/grid/XDMF writes (``svd.write``).  Observability only — a slow SVD
# phase is attributable to disk vs math.
last_svd_timings = {}


def write_svd_s_cube_to_file(field_names: Union[list, str], load_dir: str, file_name: str,
                             new_file: bool, n_modes: int = None, rank=None,
                             t_start: Union[int, float] = 0,
                             device=None) -> None:
    """Compute a weighted SVD per field from an S³ HDF5 file and export the
    modes/spectrum to ``{file_name}_{field}_svd.h5`` + XDMF
    (reference ``write_svd_s_cube_to_file``, ``utils.py:349-413``); the SVD
    runs on ``device`` (None means ``cuda``)."""
    if isinstance(field_names, str):
        field_names = [field_names]

    last_svd_timings.clear()
    last_svd_timings.update({"t_load": 0.0, "t_compute": 0.0, "t_write": 0.0})
    for f in field_names:
        logger.info(f"Performing SVD for field {f}.")

        _name = f"{file_name}_{f}" if new_file else file_name
        dataloader = Dataloader(load_dir, f"{_name}.h5")
        _write_times = sorted([t for t in dataloader.write_times if float(t) >= t_start],
                              key=lambda x: float(x))

        with trace.span("svd.load") as sp:
            snapshots = dataloader.load_snapshot(f, _write_times)
            weights = dataloader.weights
        last_svd_timings["t_load"] += sp.seconds
        with trace.span("svd.compute") as sp:
            s, u, v = compute_svd(snapshots, weights, rank, device=device)
        last_svd_timings["t_compute"] += sp.seconds
        with trace.span("svd.write") as sp:
            datawriter = Datawriter(load_dir, file_name + f"_{f}_svd.h5")
            datawriter.write_grid(dataloader)

            n_available = u.shape[-1]
            n_modes = n_available if n_modes is None else n_modes
            if n_modes > n_available:
                logger.warning(f"Number of modes to write is set to {n_modes}, but found only "
                               f"{n_available} modes to write.")
                n_modes = n_available

            for i in range(n_modes):
                if u.ndim == 2:
                    datawriter.write_data(f"mode_{i + 1}", group=CONST, data=u[:, i].squeeze())
                else:
                    datawriter.write_data(f"mode_{i + 1}", group=CONST, data=u[:, :, i].squeeze())

            datawriter.write_data("V", group=CONST, data=v)
            datawriter.write_data("s", group=CONST, data=s)
            datawriter.write_data("cell_area", group=CONST, data=dataloader.weights)
            datawriter.write_xdmf_file()
        last_svd_timings["t_write"] += sp.seconds


def compute_dmd(data_matrix, cell_area=None, rank: int = None, dt: float = 1.0,
                device=None):
    """Exact DMD of an S³ snapshot matrix, optionally √area-weighted like
    :func:`compute_svd` (the weighting makes mode energies area-consistent on
    the adaptive grid; the returned modes are un-weighted).

    :param data_matrix: ``[N_cells, N_snap]`` or ``[N_cells, N_comp, N_snap]``
    :param cell_area: optional ``[N_cells]`` areas/volumes for weighting
    :param rank: truncation rank (None → optimal)
    :param dt: snapshot time-step size
    :param device: torch device of the SVD and projections; None means
        ``cuda``
    :return: dict with eigenvalues, modes, frequencies, growth_rates,
        amplitudes, rank (see :func:`ops.dmd.exact_dmd`)
    """
    dev = resolve_device(device)
    data = _device_copy(data_matrix, dev)
    shape = data.shape
    stacked = data.reshape(shape[0] * shape[1], shape[-1]) if data.ndim == 3 else data

    if cell_area is not None:
        sqrt_area = _sqrt_area(cell_area)
        # the C-order reshape above puts cell n's components at rows
        # n*C .. n*C+C-1, so per-row weights repeat each cell's weight C times
        rows = np.repeat(sqrt_area, shape[1]) if data.ndim == 3 else sqrt_area
        stacked = stacked * torch.from_numpy(rows).to(dev)[:, None]

    result = exact_dmd(stacked, dt=dt, rank=rank, device=dev)

    if cell_area is not None:
        result["modes"] = result["modes"] / rows[:, None]
    if data.ndim == 3:
        result["modes"] = result["modes"].reshape(shape[0], shape[1], -1)
    return result


# --------------------------------------------------------------------------- #
# OpenFOAM ingestion (optional flowtorch dependency)                          #
# --------------------------------------------------------------------------- #
def load_foam_data(load_dir: str, boundaries: list, field_name="p", n_dims: int = 2,
                   t_start: Union[int, float] = 0.4, scalar: bool = True):
    """Load a single OpenFOAM field for all write times >= ``t_start``
    restricted to a box-shaped domain (reference ``load_foam_data``,
    ``utils.py:228-299``).

    :return: ``(data, xyz, weights, write_times)`` numpy arrays + list[str]
    """
    FOAMDataloader, mask_box = _require_flowtorch()
    loader = FOAMDataloader(load_dir)

    vertices = np.asarray(loader.vertices)[:, :n_dims]
    mask = np.asarray(mask_box(loader.vertices[:, :n_dims],
                               lower=boundaries[0], upper=boundaries[1]))

    write_time = sorted([t for t in loader.write_times[1:] if float(t) >= t_start],
                        key=lambda x: float(x))
    xyz = vertices[mask]

    n_masked = int(mask.sum())
    if scalar:
        data = np.zeros((n_masked, len(write_time)), dtype=np.float32)
        for i, t in enumerate(write_time):
            data[:, i] = np.asarray(loader.load_snapshot(field_name, t))[mask]
    else:
        data = np.zeros((n_masked, n_dims, len(write_time)), dtype=np.float32)
        for i, t in enumerate(write_time):
            snap = np.asarray(loader.load_snapshot(field_name, t))
            data[:, :, i] = snap[mask][:, :n_dims]

    return data, xyz, np.asarray(loader.weights), write_time


def load_original_Foam_fields(load_dir: str, n_dimensions: int, boundaries: list,
                              field_names: Union[list, str] = None,
                              write_times: Union[list, str] = None,
                              get_field_names_and_times: bool = False):
    """Load one or multiple OpenFOAM fields for arbitrary write times, or
    query the available field names / times (reference
    ``load_original_Foam_fields``, ``utils.py:23-152``).

    :return: ``(write_times, field_names)`` if
        ``get_field_names_and_times=True``; else ``(coord, data)`` for a
        single field, a list of such tuples for multiple fields, or
        ``(None, None)`` when nothing matched
    """
    FOAMDataloader, mask_box = _require_flowtorch()
    loader = FOAMDataloader(load_dir)

    if get_field_names_and_times:
        write_times = [t for t in loader.write_times[1:]]
        return write_times, loader.field_names[write_times[0]]

    vertices = np.asarray(loader.vertices)[:, :n_dimensions]
    mask = np.asarray(mask_box(loader.vertices[:, :n_dimensions],
                               lower=boundaries[0], upper=boundaries[1]))
    coord = vertices[mask]

    if write_times is None:
        write_times = [t for t in loader.write_times[1:]]
    elif isinstance(write_times, str):
        write_times = [write_times]
    write_times = list(map(str, write_times))

    if field_names is None:
        field_names = loader.field_names[write_times[0]]
    elif isinstance(field_names, str):
        field_names = [field_names]

    fields_out = []
    for field in field_names:
        try:
            first = np.asarray(loader.load_snapshot(field, write_times[0]))
        except ValueError:
            logger.warning(f"No data found for field '{field}' — it will not be "
                           f"exported.")
            continue

        try:
            if first.ndim == 1:
                data = np.zeros((coord.shape[0], 1, len(write_times)), dtype=np.float32)
                for i, t in enumerate(write_times):
                    data[:, 0, i] = np.asarray(loader.load_snapshot(field, t))[mask]
            else:
                n_comp = first.shape[1]
                data = np.zeros((coord.shape[0], n_comp, len(write_times)), dtype=np.float32)
                for i, t in enumerate(write_times):
                    data[:, :, i] = np.asarray(loader.load_snapshot(field, t))[mask]
        except (RuntimeError, IndexError):
            logger.warning(f"Field '{field}' has a different size than the masked "
                           f"domain — it will not be exported.")
            continue

        fields_out.append([coord, data])

    if len(fields_out) > 1:
        return fields_out
    if not fields_out:
        return None, None
    return fields_out[0]


def export_openfoam_fields(datawriter, load_path: str, boundaries: list,
                           batch_size: int = None, fields: Union[list, str] = None) -> None:
    """Batch-wise interpolation + export of OpenFOAM fields onto the S³ grid
    (reference ``export_openfoam_fields``, ``utils.py:155-226``): loads
    ``batch_size`` snapshots at a time to bound host memory, then streams
    them through :meth:`ExportData.export` (on the ``ExportData``'s own
    device)."""
    if fields is None:
        _, fields = load_original_Foam_fields(load_path, datawriter.n_dimensions,
                                              boundaries, get_field_names_and_times=True)

    if datawriter.write_times is None:
        times, _ = load_original_Foam_fields(load_path, datawriter.n_dimensions,
                                             boundaries, get_field_names_and_times=True)
        datawriter.write_times = times

    batch_size = batch_size if batch_size is not None else len(datawriter.write_times)
    if isinstance(fields, str):
        fields = [fields]

    n_times = len(datawriter.write_times)
    n_batches = -(-n_times // batch_size)

    for f in fields:
        for counter, t in enumerate(range(0, n_times, batch_size), start=1):
            logger.info(f"Exporting batch {counter} / {n_batches}")
            coordinates, data = load_original_Foam_fields(
                load_path, datawriter.n_dimensions, boundaries, field_names=f,
                write_times=datawriter.write_times[t:t + batch_size])
            if data is not None:
                datawriter.export(coordinates, data, f, n_snapshots_total=n_times)
