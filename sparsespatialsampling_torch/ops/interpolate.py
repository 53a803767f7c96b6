"""Inverse-distance interpolation of snapshot data onto the S³ grid.

Port of the JAX package's ``ops/interpolate.py``.  Two contractions of
``out[m, c, s] = Σ_k w[m, k] · data[idx[m, k], c, s]``:

- the host route (the export's default): the ``[Q, k]`` weight cache is
  packed once into a scipy CSR matrix (:func:`build_host_operator`) and
  every snapshot batch is one sparse product (:func:`interpolate_host`),
  the JAX package's ``build_host_operator``/``interpolate_host``, bit for
  bit;
- the device route: :func:`interpolate_data`, plain torch on the device,
  summed left to right over k — the order of the CSR product's row sum.
  One gather of ``[M, C, S]`` per neighbour keeps the temporary at the
  size of the output.
"""
import numpy as np
import torch

# output rows a contraction call computes at a time by default
CHUNK_SIZE = 65536


def interpolate_data(weights: torch.Tensor, idx: torch.Tensor,
                     data: torch.Tensor, chunk_size: int = CHUNK_SIZE):
    """``weights [M, k]`` f32 and ``idx [M, k]`` (rows of ``data``) on the
    device, ``data [N, C, S]`` f32 on the same device → ``[M, C, S]`` f32
    tensor, ``chunk_size`` output rows at a time."""
    m, k = weights.shape
    out = torch.empty((m,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    for lo in range(0, m, chunk_size):
        w = weights[lo:lo + chunk_size]
        i = idx[lo:lo + chunk_size]
        acc = w[:, 0, None, None] * data[i[:, 0]]
        for j in range(1, k):
            acc = acc + w[:, j, None, None] * data[i[:, j]]
        out[lo:lo + chunk_size] = acc
    return out


def build_host_operator(w, idx, n_src: int):
    """The ``[Q, k]`` weight cache as a scipy CSR matrix ``(Q, n_src)``:
    every host interpolation is then one sparse product.  Each row keeps
    the neighbours' ascending-distance order, so the f32 row sums run left
    to right over k, as :func:`interpolate_data` sums."""
    import scipy.sparse as sp   # deferred: only the host route needs it
    w = np.asarray(w, dtype=np.float32)
    idx = np.asarray(idx, dtype=np.int64)
    q, k = w.shape
    indptr = np.arange(q + 1, dtype=np.int64) * k
    return sp.csr_matrix((w.ravel(), idx.ravel(), indptr), shape=(q, n_src))


def build_host_weight_cache(knn_index, points, k: int):
    """The host route's weight cache of one point set: ``(w [Q, k], idx
    [Q, k], csr_op, n_fallback)`` from ``knn_index.weights``.  Both
    ``ExportData`` and the prefetch thread of
    ``SparseSpatialSampling.execute_grid_generation`` make their caches
    here, so the two are the same bytes.  The fallback count is returned rather than read off
    the index later, since a worker thread may build the cache."""
    w, idx = knn_index.weights(points, k)
    w = np.asarray(w)
    idx = np.asarray(idx)
    op = build_host_operator(w, idx, knn_index.n_points)
    return w, idx, op, int(getattr(knn_index, "last_fallback", 0))


def interpolate_host(w, idx, data, chunk_size: int = 16384,
                     timings: dict = None, op=None) -> np.ndarray:
    """The host contraction of ``data [N, C, S]`` (cast to f32) with a
    numpy weight cache, as one CSR product → ``[M, C, S]`` f32.

    :param chunk_size: accepted for the JAX package's signature; unused
    :param timings: accumulates ``interp_bytes`` (the ``[M, k, C, S]``
        gather plus the ``[M, C, S]`` result, f32) and ``interp_outputs``
        (``M·C·S``); ``ExportData`` times the call (``t_kernel``)
    :param op: a prebuilt :func:`build_host_operator` matrix (built from
        ``w`` and ``idx`` when None)
    """
    data = np.asarray(data, dtype=np.float32)
    if op is None:
        op = build_host_operator(w, idx, data.shape[0])
    m, k = op.shape[0], np.asarray(w).shape[1]
    n = data.shape[0]
    out = (op @ data.reshape(n, -1)).reshape((m,) + data.shape[1:])
    if timings is not None:
        add_interp_counts(timings, m, k, data.shape[1] * data.shape[2])
    return out


def add_interp_counts(timings: dict, m: int, k: int, c_s: int) -> None:
    """Add one contraction of ``m`` rows, ``k`` neighbours and ``c_s``
    values a row to ``timings``' ``interp_bytes`` and ``interp_outputs``
    (the JAX package's accounting)."""
    timings["interp_bytes"] = (timings.get("interp_bytes", 0.0)
                               + m * (k + 1) * c_s * 4.0)
    timings["interp_outputs"] = timings.get("interp_outputs", 0) + m * c_s
