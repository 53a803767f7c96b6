"""Interpolate CFD fields onto the S³ grid and export them to HDF5/XDMF.

Port of the JAX package's ``export.py`` (reference ``ExportData``,
``sparseSpatialSampling/export.py:40-319``).  The kNN of the cell centres
runs on the device (:class:`~.ops.knn.KNNIndex`; the grid path scores and
selects in the ``grid_select`` kernel), and :attr:`ExportData.INTERP`
chooses what follows, as the JAX package's ``S3_TPU_INTERP`` does:

- ``"host"`` (the default): only the ``[Q, k]`` indices come back, the
  weights are computed in numpy (``KNNIndex.weights``), the metric is
  interpolated in float64 on the host, and the snapshots are contracted by
  one scipy CSR product (``ops/interpolate.interpolate_host``).  Every
  HDF5 dataset is then the JAX package's bytes, on every device.  The
  cache may come from the prefetch thread of
  ``SparseSpatialSampling.execute_grid_generation``.
- ``"device"``: the weights stay on the device (``weights_device``), and
  the metric and the snapshots are contracted there in float32
  (``ops/interpolate.interpolate_data``).

Where sharding is enabled (``parallel/mesh.sharding_enabled``) the CFD
cloud is indexed over the mesh (``parallel.ShardedKNNIndex``, the JAX
package's sharded weights), the metric is interpolated in float64 on the
host and the snapshots with the cells sharded
(``parallel.sharded_interpolate``, each row summed as the single device
sums it), on either route.  The HDF5/XDMF files have the JAX package's
(and the reference's) schema.
"""
import logging
from os import path
from typing import Union

import numpy as np
import torch

from . import trace
from ._device import resolve_device
from .engine.graphs import join_workers
from .io.const import GRID, CONST, FACES, CENTERS, VERTICES, DATA
from .io.data import Datawriter
from .ops.interpolate import (CHUNK_SIZE, add_interp_counts,
                              build_host_weight_cache, interpolate_data,
                              interpolate_host)
from .ops.knn import KNNIndex
from .parallel import (ShardedKNNIndex, default_mesh, sharded_interpolate,
                       sharding_enabled)

logger = logging.getLogger(__name__)


class Fields:
    """Interpolated field values at cell centres and vertices (reference
    ``Fields``, ``export.py:26-37``)."""

    def __init__(self, centers=None, vertices=None):
        self.centers = centers
        self.vertices = vertices


class ExportData:
    """Interpolate original snapshots onto the S³ grid and write HDF5/XDMF."""

    # the interpolation route, read when an instance is made (the JAX
    # package's S3_TPU_INTERP): "host" or "device" (see the module's
    # docstring)
    INTERP = "host"

    def __init__(self, s_cube, write_new_file_for_each_field: bool = False,
                 n_jobs: int = None, n_neighbors: int = None,
                 interpolate_at_vertices: bool = False,
                 write_times: Union[list, str] = None,
                 append_existing: bool = False, device=None):
        """
        :param s_cube: executed :class:`SparseSpatialSampling` object
        :param write_new_file_for_each_field: one HDF5 file per field
            (disabled when ``append_existing=True``)
        :param n_jobs: accepted for reference drop-in use; ignored
        :param n_neighbors: k of the interpolation kNN (default 8 in 2D,
            26 in 3D — reference ``export.py:117-118``)
        :param interpolate_at_vertices: also interpolate at cell vertices
        :param write_times: time-step labels of the snapshots to export
        :param append_existing: append fields to an existing HDF5 file (the
            grids must be identical; consistency is not checked)
        :param device: torch device of the kNN and the contraction; None
            means ``cuda`` (raises when there is no card)
        """
        self.device = resolve_device(device)
        self._interpolate_at_vertices = interpolate_at_vertices
        self._new_file = write_new_file_for_each_field
        self.n_dimensions = s_cube.n_dimensions
        self._face_id = np.asarray(s_cube.faces)
        self._centers = np.asarray(s_cube.centers)
        self._vertices = np.asarray(s_cube.vertices)
        self._levels = np.asarray(s_cube.levels)
        self._metric = np.asarray(s_cube.metric)
        self._size_initial_cell = s_cube.size_initial_cell
        self._save_dir = s_cube.save_path
        self._save_name = s_cube.save_name
        self._grid_name = s_cube.grid_name

        if write_times is not None:
            self._write_times = (write_times if isinstance(write_times, list)
                                 else [write_times])
        else:
            self._write_times = None
            logger.warning("No 'write_times' given yet — assign the "
                           "'write_times' property before the first "
                           "export() call.")

        self._interpolated_fields = Fields()
        self._field_name = None
        self._datawriter = None
        self._snapshot_counter = 0
        self._initialized_hdf5 = append_existing
        self._interpolated_metric = append_existing
        self._initialized_weights = False
        self._n_snapshots_total = None
        # the spans' run: that of the grid's object
        self._trace_run = getattr(s_cube, "_trace_run", None)
        # seconds of the current field's export spans, for the log
        self._field_s = 0.0

        if append_existing:
            logger.info(f"Opening existing file "
                        f"{path.join(self._save_dir, self._save_name)}.h5 "
                        f"to append additional fields.")
            if self._new_file:
                logger.warning("'append_existing=True' targets one shared "
                               "file, so 'write_new_file_for_each_field' is "
                               "being turned off.")
                self._new_file = False

        self._n_neighbors = (n_neighbors if n_neighbors is not None
                             else (8 if self.n_dimensions == 2 else 26))
        self._interp_path = self.INTERP
        # the engine's index over the same cloud, if the caller kept it
        self._engine_knn = getattr(s_cube, "_knn_index", None)
        # the host weight cache of the cell centres that
        # execute_grid_generation builds in a worker thread, if any
        self._prefetch = getattr(s_cube, "_knn_prefetch", None)
        self._knn = None
        # the mesh of the sharded route (None: one device)
        self._mesh = None
        self._coord_shape = None
        # True: the weights are device tensors (the device route); False:
        # numpy arrays with their CSR operators (the host route)
        self._cache_device = False
        self._w_centers = self._idx_centers = self._op_centers = None
        self._w_vertices = self._idx_vertices = self._op_vertices = None
        # cumulative seconds across export() calls, each its spans' (of
        # ``interpolate``: ``export.weights``, ``export.upload``,
        # ``export.metric``, ``export.product`` less its
        # ``export.readback``; ``export.write``): t_weights (the weight
        # cache), t_upload (snapshots to the device), t_metric, t_kernel
        # (the contractions), t_readback (results to the host), t_h5;
        # interp_bytes and interp_outputs count the contractions' traffic
        # and values, n_fallback the exact-fallback rows of the weight
        # queries, and prefetch says where the centres' host cache came
        # from: "consumed" (the prefetch thread), "built" (here) or "off"
        # (no host cache)
        self.timings = {"t_weights": 0.0, "t_upload": 0.0, "t_metric": 0.0,
                        "t_kernel": 0.0, "t_readback": 0.0, "t_h5": 0.0,
                        "interp_bytes": 0.0, "interp_outputs": 0,
                        "n_fallback": 0, "prefetch": "off"}

    def export(self, coordinates, data, field_name: str,
               n_snapshots_total: int = None, chunk_size: int = None) -> None:
        """Interpolate CFD data onto the S³ grid (:meth:`interpolate`) and
        write it to HDF5 (and XDMF once all snapshots of the field are
        written).

        :param coordinates: coordinates of the original CFD grid ``[N, d]``
        :param data: field data ``[N, C, S]`` (scalar fields: C = 1); ``S``
            may be all snapshots, a batch, or a single snapshot
        :param field_name: name of the exported field (e.g. ``'p'``)
        :param n_snapshots_total: total number of snapshots to export across
            all batches; if None, ``data`` is assumed complete
        :param chunk_size: cells interpolated per device call; None keeps
            the default of :func:`~.ops.interpolate.interpolate_data`.  The
            result does not depend on it.
        """
        if self._write_times is None:
            raise ValueError(
                "No write times are set for this export: supply them via the "
                "'write_times' constructor argument or assign the "
                "'write_times' property before exporting fields.")
        self._field_name = field_name
        if self._snapshot_counter == 0:
            logger.info(f"Interpolating field {field_name} onto the S3 grid.")
        n_batch = self.interpolate(coordinates, data,
                                   chunk_size=chunk_size).shape[-1]
        if self._snapshot_counter == 0:
            self._n_snapshots_total = (n_snapshots_total
                                       if n_snapshots_total is not None
                                       else n_batch)
        self._snapshot_counter += n_batch
        with trace.span("export.write", run=self._trace_run) as sp:
            self._write_data_to_hdf5()
        self.timings["t_h5"] += sp.seconds
        self._field_s += sp.seconds

    @property
    def write_times(self) -> list:
        return self._write_times

    @write_times.setter
    def write_times(self, value: Union[list, str]) -> None:
        self._write_times = value if isinstance(value, list) else [value]

    # ------------------------------------------------------------------ #
    # interpolation                                                      #
    # ------------------------------------------------------------------ #
    def _build_knn_cache(self, coordinates) -> None:
        """kNN inverse-distance weights of the cell centres (and optionally
        vertices) in the original grid (reference ``_build_knn_cache``,
        ``export.py:403-444``); rebuilt only when the CFD grid changes
        shape.  Under sharding the cloud is indexed over the mesh, as the
        JAX package does (its ``export.py:193-216``)."""
        coordinates = np.asarray(coordinates)
        if (self._coord_shape is not None
                and coordinates.shape != self._coord_shape):
            self._knn = None
        self._coord_shape = coordinates.shape
        if self._knn is None:
            pts = coordinates.reshape(-1, self.n_dimensions)
            reuse = self._engine_knn
            probe = [0, pts.shape[0] // 2, -1]
            self._mesh = (default_mesh(self.device)
                          if sharding_enabled(self.device) else None)
            if self._mesh is not None:
                self._knn = ShardedKNNIndex(pts, self._mesh)
            elif (isinstance(reuse, KNNIndex) and reuse.device == self.device
                    and reuse.n_points == pts.shape[0]
                    and reuse.n_dim == pts.shape[1]
                    and np.allclose(pts[probe] - reuse._shift,
                                    reuse._points_host[probe], atol=1e-6)):
                self._knn = reuse   # the engine indexed the same cloud
                # no query of a worker thread (a prefetch, this run's or an
                # earlier one's on a cached index) runs beside this one's
                join_workers(self._knn)
            else:
                self._knn = KNNIndex(pts, device=self.device)

        k = self._n_neighbors
        self._cache_device = (isinstance(self._knn, KNNIndex)
                              and self._interp_path == "device")
        if self._cache_device:
            self._w_centers, self._idx_centers = self._knn.weights_device(
                self._centers, k)
            self.timings["n_fallback"] += self._knn.last_fallback
        else:
            # the prefetch thread built this very cache when the engine's
            # index is in use with the k it assumed (the JAX package's
            # conditions); it is joined before the cache is read, and
            # consumed once
            got = None
            pf = self._prefetch
            if (pf is not None and pf["thread"] is not None
                    and self._knn is self._engine_knn and pf["k"] == k):
                with trace.span("workers.join"):
                    pf["thread"].join()
                got = pf["data"].pop("centers", None)
                pf["thread"] = None
            if got is not None and got[0].shape == (self._centers.shape[0],
                                                    k):
                self.timings["prefetch"] = "consumed"
            else:
                got = build_host_weight_cache(self._knn, self._centers, k)
                self.timings["prefetch"] = "built"
            (self._w_centers, self._idx_centers, self._op_centers,
             n_fallback) = got
            self.timings["n_fallback"] += n_fallback

        if self._interpolate_at_vertices:
            if self._cache_device:
                self._w_vertices, self._idx_vertices = \
                    self._knn.weights_device(self._vertices, k)
                self.timings["n_fallback"] += self._knn.last_fallback
            else:
                (self._w_vertices, self._idx_vertices, self._op_vertices,
                 n_fallback) = build_host_weight_cache(self._knn,
                                                       self._vertices, k)
                self.timings["n_fallback"] += n_fallback
        self._initialized_weights = True

    def interpolate(self, coordinates, data,
                    chunk_size: int = None) -> np.ndarray:
        """Interpolate CFD data onto the cell centres (and vertices, if
        asked for) without writing anything: the first half of
        :meth:`export`.  Builds the weight cache on the first call and
        interpolates the refinement metric once (reference ``_fit_data``,
        ``export.py:169-231``).

        :param coordinates: coordinates of the original CFD grid ``[N, d]``
        :param data: field data ``[N, C, S]`` (or ``[N, S]`` for a scalar)
        :param chunk_size: cells contracted per device call (as in
            :meth:`export`; the host route makes one call)
        :return: the field at the cell centres, ``[M, C, S]`` float32
        """
        with trace.span("export.interpolate", run=self._trace_run) as total:
            chunk_size = CHUNK_SIZE if chunk_size is None else int(chunk_size)
            if chunk_size < 1:
                raise ValueError(f"chunk_size must be at least 1, got "
                                 f"{chunk_size}")
            data = np.asarray(data)
            if data.ndim < 2:
                raise ValueError(
                    f"'data' is {data.ndim}-dimensional but must be 3-D: "
                    "[N_cells, N_components, N_snapshots] (use N_components=1 "
                    "for scalar fields).")
            if data.ndim == 2:
                logger.warning("2-D 'data' given — treating it as a scalar "
                               "field and inserting a component axis: "
                               "[N_cells, N_snapshots] -> "
                               "[N_cells, 1, N_snapshots].")
                data = data[:, None, :]

            # the device route ships the snapshots before the weight build, as
            # the JAX package does
            if self._interp_path == "device" and not sharding_enabled(
                    self.device):
                with trace.span("export.upload", self.device) as sp:
                    host = np.ascontiguousarray(data, dtype=np.float32)
                    data = torch.from_numpy(host).to(self.device)
                    sp.count(bytes=host.nbytes)
                self.timings["t_upload"] += sp.seconds

            if not self._initialized_weights:
                with trace.span("export.weights", self.device) as sp:
                    self._build_knn_cache(coordinates)
                    if self.timings["prefetch"] != "off":
                        sp.count(**{self.timings["prefetch"]: 1})
                self.timings["t_weights"] += sp.seconds

            if not self._interpolated_metric:
                with trace.span("export.metric", self.device) as sp:
                    if self._cache_device:
                        # float32 on the device, as the JAX package's device
                        # route
                        metric = torch.as_tensor(self._metric[:, None, None],
                                                 dtype=torch.float32,
                                                 device=self.device)
                        self._metric = interpolate_data(
                            self._w_centers, self._idx_centers, metric,
                            chunk_size)[:, 0, 0].cpu().numpy()
                    else:
                        # float64 on the host, as the JAX package's host route
                        self._metric = (self._w_centers * self._metric[
                            self._idx_centers]).sum(axis=1)
                self._interpolated_metric = True
                self.timings["t_metric"] += sp.seconds

            self._interpolated_fields.centers = self._interpolate(
                self._w_centers, self._idx_centers, self._op_centers, data,
                chunk_size)
            if self._interpolate_at_vertices:
                self._interpolated_fields.vertices = self._interpolate(
                    self._w_vertices, self._idx_vertices, self._op_vertices,
                    data, chunk_size)
            total.count(snapshots=int(data.shape[-1]),
                        bytes=4 * int(np.prod(data.shape)))
        self._field_s += total.seconds
        return self._interpolated_fields.centers

    def _interpolate(self, w, idx, op, data, chunk_size: int) -> np.ndarray:
        """One interpolation, the span ``export.product``: on a mesh with
        the cells sharded, on the device (the device route, whose read
        back is the child span ``export.readback``), or as one CSR product
        on the host (the JAX package's ``_interpolate``)."""
        readback = None
        with trace.span("export.product", self.device, cells=w.shape[0],
                        snapshots=data.shape[-1]) as sp:
            if self._mesh is not None:
                out = sharded_interpolate(w, idx, data, self._mesh,
                                          chunk_size)
            elif self._cache_device:
                out = interpolate_data(w, idx, data, chunk_size)
                if out.is_cuda:
                    torch.cuda.synchronize(out.device)
                with trace.span("export.readback") as readback:
                    out = out.cpu().numpy()
                add_interp_counts(self.timings, w.shape[0], w.shape[1],
                                  data.shape[1] * data.shape[2])
            else:
                out = interpolate_host(w, idx, data, timings=self.timings,
                                       op=op)
        t_readback = 0.0 if readback is None else readback.seconds
        self.timings["t_kernel"] += sp.seconds - t_readback
        self.timings["t_readback"] += t_readback
        return out

    # ------------------------------------------------------------------ #
    # HDF5 output                                                        #
    # ------------------------------------------------------------------ #
    def _write_data_to_hdf5(self) -> None:
        """Write the grid (first call) and the interpolated snapshots; write
        the XDMF file once all snapshots of the field are in (reference
        ``_write_data_to_hdf5``, ``export.py:233-319``)."""
        if not self._initialized_hdf5:
            logger.info(f"Flushing field {self._field_name} to HDF5.")
            file_name = (f"{self._save_name}_{self._field_name}.h5"
                         if self._new_file else f"{self._save_name}.h5")
            self._datawriter = Datawriter(self._save_dir, file_name)
            self._datawriter.write_data(FACES, group=GRID, data=self._face_id)
            self._datawriter.write_data(VERTICES, group=GRID,
                                        data=self._vertices)
            self._datawriter.write_data(CENTERS, group=GRID,
                                        data=self._centers)
            self._datawriter.write_data("levels", group=CONST,
                                        data=self._levels)
            self._datawriter.write_data("metric", group=CONST,
                                        data=self._metric)
            self._datawriter.write_data("size_initial_cell", group=CONST,
                                        data=self._size_initial_cell)
            self._initialized_hdf5 = True
            self._levels = None
            self._metric = None
            self._size_initial_cell = None
        elif not self._new_file and self._datawriter is None:
            logger.info(f"Flushing field {self._field_name} to HDF5.")
            self._datawriter = Datawriter(self._save_dir,
                                          f"{self._save_name}.h5", mode="a")
        else:
            self._datawriter.mode = "a"

        centers = self._interpolated_fields.centers
        t_start = self._snapshot_counter - centers.shape[-1]
        t_end = self._snapshot_counter
        for i, t in enumerate(self._write_times[t_start:t_end]):
            sel = (slice(None), 0, i) if centers.shape[1] == 1 else (
                slice(None), slice(None), i)
            self._datawriter.write_data(f"{self._field_name}_center",
                                        group=DATA, time_step=str(t),
                                        data=centers[sel])
            if self._interpolate_at_vertices:
                self._datawriter.write_data(
                    f"{self._field_name}_vertices", group=DATA,
                    time_step=str(t),
                    data=self._interpolated_fields.vertices[sel])

        if self._snapshot_counter == self._n_snapshots_total:
            self._datawriter.close()
            self._datawriter.write_xdmf_file()
            self._interpolated_fields = Fields()
            self._snapshot_counter = 0
            if self._new_file:
                self._initialized_hdf5 = False
            logger.info(f"Field {self._field_name} exported after "
                        f"{round(self._field_s, 3)}s.")
            self._field_s = 0.0
