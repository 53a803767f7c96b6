"""Snapshot interpolation with the query cells sharded over a mesh.

Port of the JAX package's ``parallel/interpolate.py``: each shard
contracts its block of the S³ cells with the snapshot matrix (copied once
to each device of the mesh) through ``ops/interpolate.interpolate_data``,
with no collective until the blocks are gathered on the root.  Each row
is computed as the single-device interpolation computes it, so the result
is bitwise the same.
"""
import numpy as np
import torch

from ..ops.interpolate import CHUNK_SIZE, interpolate_data
from .mesh import Mesh, all_gather, pad_to_multiple, shard_rows


def sharded_interpolate(weights, idx, data, mesh: Mesh,
                        chunk_size: int = CHUNK_SIZE) -> np.ndarray:
    """Inverse-distance interpolation with the cell axis sharded.

    :param weights: ``[M, k]`` per-row normalised weights (tensor or array)
    :param idx: ``[M, k]`` neighbour indices into ``data``
    :param data: ``[N, C, S]`` snapshot matrix (host array, replicated)
    :param mesh: the 1-D mesh the rows are split over
    :param chunk_size: output rows a contraction call computes at a time
    :return: ``[M, C, S]`` f32 numpy array
    """
    w = torch.as_tensor(weights, dtype=torch.float32)
    ix = torch.as_tensor(idx).long()
    m = w.shape[0]
    data_t = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    copies = {dev: data_t.to(dev) for dev in set(mesh.devices)}
    parts = [interpolate_data(w_s, ix_s, copies[w_s.device], chunk_size)
             for w_s, ix_s in zip(
                 shard_rows(pad_to_multiple(w, mesh.size), mesh),
                 shard_rows(pad_to_multiple(ix, mesh.size), mesh))]
    return all_gather(parts, mesh)[:m].cpu().numpy()
