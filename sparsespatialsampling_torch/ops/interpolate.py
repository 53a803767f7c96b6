"""Inverse-distance interpolation of snapshot data onto the S³ grid.

Port of the JAX package's ``ops/interpolate.py`` (``_interp_chunk``): the
contraction ``out[m, c, s] = Σ_k w[m, k] · data[idx[m, k], c, s]`` as plain
torch on the device, summed left to right over k — the order of the JAX
package's CSR host contraction (``build_host_operator``).  One gather of
``[M, C, S]`` per neighbour keeps the temporary at the size of the output.
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


def interpolate_numpy(weights, idx, data, device,
                      chunk_size: int = CHUNK_SIZE) -> np.ndarray:
    """:func:`interpolate_data` on host arrays: uploads ``data`` as f32 to
    ``device`` and returns the result as numpy."""
    data_t = torch.from_numpy(np.ascontiguousarray(
        data, dtype=np.float32)).to(device)
    return interpolate_data(weights, idx, data_t, chunk_size).cpu().numpy()
