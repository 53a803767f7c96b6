"""Public façade of the PyTorch port of S³.

Mirror of the JAX package's ``sparse_spatial_sampling.py`` (reference
``sparseSpatialSampling/sparse_spatial_sampling.py:20-212``): same
constructor (plus ``device``), same validation, same artifacts — the
``mesh_info_{name}.pt`` dict and a reloadable ``s_cube_{name}.pt`` object
checkpoint, both written with ``torch.save``.  Input and result arrays are
numpy on the host; the engine runs its numerics on ``device`` (the card
unless the caller asks for the CPU).
"""
import itertools
import logging
import threading
from contextlib import nullcontext
from os import makedirs, path
from os.path import join
from typing import Union

import numpy as np
import torch

from . import trace
from ._device import resolve_device
from .engine.graphs import register_worker
from .engine.tree import SamplingTree

logger = logging.getLogger(__name__)

# the run ids of the objects' spans (``trace``): one an object, shared by
# its ExportData and its prefetch thread
_runs = itertools.count(1)


def _save_object(obj, file_path: str) -> None:
    # pickle protocol 4: faster and smaller for numpy payloads, still a
    # regular torch zip archive
    torch.save(obj, file_path, pickle_protocol=4)


def load_s_cube(file_path: str):
    """Reload a :class:`SparseSpatialSampling` checkpoint written by
    :meth:`SparseSpatialSampling.execute_grid_generation` (it unpickles:
    load only files this program wrote)."""
    return torch.load(file_path, weights_only=False)


class SparseSpatialSampling:
    """Execute the S³ algorithm: metric-driven adaptive quadtree/octree grid
    generation for CFD data reduction."""

    # build the export's default weight cache in a worker thread while the
    # checkpoint is written (the JAX package's S3_TPU_EXPORT_PREFETCH);
    # a pipeline that never exports may turn it off
    EXPORT_PREFETCH = True

    def __init__(self, coordinates, metric, geometry_objects: list,
                 save_path: str, save_name: str,
                 grid_name: str = "grid_s_cube", uniform_levels: int = 5,
                 n_cells_max: Union[int, float] = None,
                 min_metric: float = 0.75, max_delta_level: bool = False,
                 n_cells_iter_start: int = None, n_cells_iter_end: int = None,
                 n_jobs: int = 1, relTol: Union[int, float] = 1e-3,
                 reach_at_least: float = 0.75,
                 pre_select_cells: bool = False, device=None):
        """
        :param coordinates: coordinates of the original grid ``[N, d]``
        :param metric: refinement-indicator field ``[N]``
        :param geometry_objects: geometry objects; one must have
            ``keep_inside=True`` (the numerical domain)
        :param save_path: directory for the generated grid and data
        :param save_name: base name of the output files
        :param grid_name: grid name used in the XDMF file
        :param uniform_levels: number of uniform refinement cycles
        :param n_cells_max: max number of cells (overrides ``min_metric``)
        :param min_metric: target captured-metric fraction
        :param max_delta_level: keep neighbouring leaves (across faces,
            edges and corners) within one level of each other
        :param n_cells_iter_start: cells refined per iteration at the start
        :param n_cells_iter_end: cells refined per iteration at the end
        :param n_jobs: accepted for reference drop-in use; ignored
        :param relTol: min improvement between consecutive iterations
        :param reach_at_least: fraction of the target to reach before the
            relTol stopping criterion arms
        :param pre_select_cells: test STL and polygon (``coord_2D``)
            geometries outside the refinement epochs on host-built f64
            corner nodes, settling the cells their bounding box decides
            first, as the JAX package does
        :param device: torch device of the numerics; None means ``cuda``
            (raises when there is no card)
        """
        self._trace_run = next(_runs)
        with trace.span("s3.init", run=self._trace_run) as sp:
            self.device = resolve_device(device)
            self.n_jobs = n_jobs
            self.coordinates = np.asarray(coordinates)
            self.metric = np.asarray(metric)
            self.save_path = save_path
            self.save_name = save_name
            self.grid_name = grid_name

            # results copied off the SamplingTree after execution
            self.centers = None
            self.vertices = None
            self.faces = None
            self.n_dimensions = int(np.squeeze(self.coordinates).shape[-1])
            self.size_initial_cell = None
            self.levels = None
            self.data_final_mesh = None

            self._geometries = geometry_objects
            self._level_bounds = int(uniform_levels)
            self._n_cells_max = (n_cells_max if n_cells_max is None
                                 else int(n_cells_max))
            self._min_metric = min_metric
            self._max_delta_level = max_delta_level
            self._n_cells_iter_start = (n_cells_iter_start
                                        if n_cells_iter_start is None
                                        else int(n_cells_iter_start))
            self._n_cells_iter_end = (n_cells_iter_end
                                      if n_cells_iter_end is None
                                      else int(n_cells_iter_end))
            self._relTol = relTol
            self._reach_at_least = reach_at_least
            self._pre_select_cells = pre_select_cells

            self._check_input()
            sp.count(points=int(self.coordinates.shape[0]))

            self._sampling = SamplingTree(
                self.coordinates, self.metric, self._geometries,
                n_cells=self._n_cells_max, uniform_level=self._level_bounds,
                min_metric=self._min_metric,
                max_delta_level=self._max_delta_level,
                n_cells_iter_end=self._n_cells_iter_end,
                n_cells_iter_start=self._n_cells_iter_start,
                relTol=self._relTol, reach_at_least=self._reach_at_least,
                pre_select=self._pre_select_cells, device=self.device)

    def execute_grid_generation(self) -> None:
        """Run the refinement and persist the results (reference
        ``execute_grid_generation``, ``sparse_spatial_sampling.py:116-146``).
        The engine's kNN index stays on the object (not in the checkpoint)
        for :class:`ExportData` to reuse."""
        with trace.span("s3.generation", run=self._trace_run) as gen:
            if not path.exists(self.save_path):
                makedirs(self.save_path)
            self._sampling.refine()
            with trace.span("s3.finalize") as sp:
                self.data_final_mesh = self._sampling.data_final_mesh
                self.levels = self._sampling.all_levels
                self.centers = self._sampling.all_centers
                self.vertices = self._sampling.all_nodes
                self.faces = self._sampling.face_ids
                self.size_initial_cell = self.data_final_mesh[
                    "size_initial_cell"]
            self.data_final_mesh["t_finalize"] = sp.seconds
            self._checkpoint(self.data_final_mesh, "mesh_info")

            knn_index = self._sampling._knn
            self._sampling = None   # the checkpoint only needs the final grid
            prefetch = self._start_prefetch(knn_index, gen.id)
            self.data_final_mesh["t_checkpoint"] = self._checkpoint(
                self, "s_cube")
            self._knn_index = knn_index
            self._knn_prefetch = prefetch

    def _checkpoint(self, obj, prefix: str) -> float:
        """Write ``obj`` to ``{prefix}_{save_name}.pt``; returns the
        write's seconds (the span ``s3.checkpoint``)."""
        file_path = join(self.save_path, f"{prefix}_{self.save_name}.pt")
        with trace.span("s3.checkpoint") as sp:
            _save_object(obj, file_path)
            sp.count(bytes=path.getsize(file_path))
        return sp.seconds

    def _start_prefetch(self, knn_index, parent=None) -> dict:
        """Start building the export's default weight cache of the cell
        centres in a worker thread, overlapping the checkpoint write (the
        JAX package's ``execute_grid_generation``, its
        ``sparse_spatial_sampling.py:158-198``).  Only with one device,
        the engine's :class:`KNNIndex` and the host route; k is
        ``ExportData``'s default.  Returns ``{"thread", "k", "data",
        "t_build"}``: ``ExportData`` joins the thread and takes
        ``data["centers"]``, the tuple of
        ``ops/interpolate.build_host_weight_cache``; ``t_build`` is the
        thread's seconds (the span ``s3.prefetch``, under the span
        ``parent`` of the run).  A failure is logged, and ``ExportData``
        then builds the cache itself."""
        from .export import ExportData
        from .ops.interpolate import build_host_weight_cache
        from .ops.knn import KNNIndex
        from .parallel import sharding_enabled
        prefetch = {"thread": None, "k": None, "data": {}, "t_build": None}
        if not (self.EXPORT_PREFETCH and isinstance(knn_index, KNNIndex)
                and not sharding_enabled(knn_index.device)
                and ExportData.INTERP != "device"):
            return prefetch
        k = 8 if self.n_dimensions == 2 else 26
        centers, device = self.centers, knn_index.device
        run = self._trace_run

        def build():
            with trace.span("s3.prefetch", run=run, parent=parent,
                            cells=int(centers.shape[0])) as sp:
                try:
                    # the CUDA work of this thread goes to the index's card
                    with (torch.cuda.device(device) if device.type == "cuda"
                          else nullcontext()):
                        prefetch["data"]["centers"] = \
                            build_host_weight_cache(knn_index, centers, k)
                except Exception as exc:
                    logger.warning(f"the export's weight-cache prefetch "
                                   f"failed; ExportData builds the cache: "
                                   f"{exc!r}")
            prefetch["t_build"] = sp.seconds

        prefetch["k"] = k
        prefetch["thread"] = threading.Thread(target=build, daemon=True)
        # a later run's CUDA graph capture waits for it, and so does a
        # later run or export that takes the same index
        register_worker(prefetch["thread"], holds=knn_index)
        prefetch["thread"].start()
        return prefetch

    def __getstate__(self):
        """Checkpoints never carry the runtime kNN index (device tensors)
        nor the prefetch (a thread and its cache); :class:`ExportData`
        rebuilds them on reload; nor the run id of its spans, which is
        the process's own."""
        state = self.__dict__.copy()
        state.pop("_knn_index", None)
        state.pop("_knn_prefetch", None)
        state.pop("_trace_run", None)
        return state

    def __setstate__(self, state):
        """A reloaded object's spans take a new run id of this process."""
        self.__dict__.update(state)
        self._trace_run = next(_runs)

    def _check_input(self) -> None:
        """Validate and auto-correct user settings (reference
        ``_check_input``, ``sparse_spatial_sampling.py:148-186``)."""
        if np.squeeze(self.metric).ndim != 1:
            raise ValueError(
                f"'metric' must be a flat per-point array (one value for "
                f"each of the {self.coordinates.shape[0]} grid points); got "
                f"shape {self.metric.shape} instead.")
        if self._n_cells_max is None and self._min_metric > 1:
            logger.warning("'min_metric' is a captured-metric fraction and "
                           "cannot exceed 1 — clamping it to 1.")
            self._min_metric = 1
        if not self._geometries:
            raise ValueError("'geometry_objects' is empty — pass at least the "
                             "domain geometry (keep_inside=True).")
        if not any(g.keep_inside for g in self._geometries):
            raise ValueError("None of the geometry objects has "
                             "keep_inside=True; exactly that object defines "
                             "the numerical domain S³ refines within.")
        if self._level_bounds <= 0:
            logger.warning(f"'uniform_levels' must be at least 1 (got "
                           f"{self._level_bounds}) — raising it to 1.")
            self._level_bounds = 1
        if self._n_cells_max is not None:
            logger.warning(
                "'n_cells_max' takes precedence as the stopping criterion: "
                "the run stops at the cell budget and 'min_metric' is "
                "ignored. Leave 'n_cells_max' unset (None) to stop on the "
                "captured-metric target instead.")


def list_geometries() -> None:
    """Log every geometry class of the port with a one-line summary
    (behavioral mirror of the reference ``list_geometries``,
    ``sparse_spatial_sampling.py:190-212``)."""
    from . import geometry
    from .geometry.base import GeometryObject

    entries = {}
    for attr in dir(geometry):
        cls = getattr(geometry, attr)
        if (isinstance(cls, type) and issubclass(cls, GeometryObject)
                and cls is not GeometryObject):
            doc = getattr(cls, "__short_description__", None) or (cls.__doc__ or "")
            summary = " ".join(doc.split())
            if len(summary) > 96:
                summary = summary[:96].rsplit(" ", 1)[0] + " ..."
            entries[cls.__name__] = summary

    pad = max(map(len, entries), default=0)
    lines = ["", "\tGeometry classes shipped with this package:"]
    lines += [f"\t  {name:<{pad}}  {desc}"
              for name, desc in sorted(entries.items())]
    lines.append("\tSee the package docs for each class's constructor details.")
    logger.info("\n".join(lines))
