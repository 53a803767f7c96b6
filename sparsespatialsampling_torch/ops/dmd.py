"""Exact Dynamic Mode Decomposition on a torch device.

Port of the JAX package's ``ops/dmd.py`` (exact DMD, Tu et al. 2014; the
reference needs flowtorch for it, ``post_processing/compare_dmd_OAT.py:17``):

    X ≈ U Σ V*        (thin SVD of the first n-1 snapshots)
    Ã = U* X' V Σ⁻¹   (reduced linear operator, [r, r])
    Ã W = W Λ         (host eigendecomposition — r is small)
    Φ = X' V Σ⁻¹ W    (exact DMD modes)

The SVD and the two tall projections run on the device; the ``[r, r]``
complex eigenproblem and the amplitude fit run in host numpy.
"""
import numpy as np
import torch

from .._device import resolve_device
from .svd import as_matrix, economy_svd_device, optimal_rank


def exact_dmd(data, dt: float = 1.0, rank: int = None, device=None):
    """Exact DMD of a snapshot matrix ``[n_points, n_snapshots]``.

    :param data: snapshot matrix; columns are consecutive time steps
    :param dt: time-step size between snapshots (for frequencies/growth rates)
    :param rank: truncation rank; None → Gavish-Donoho optimal rank
    :param device: torch device of the SVD and projections; None means
        ``cuda``
    :return: dict with ``eigenvalues`` (discrete, complex), ``modes``
        ``[n_points, r]`` (complex), ``frequencies`` [Hz], ``growth_rates``,
        ``amplitudes`` (complex, least-squares fit to the first snapshot)
    """
    data = as_matrix(data, resolve_device(device))
    x, x_prime = data[:, :-1], data[:, 1:]

    u, s, v = economy_svd_device(x)
    if rank is None:
        rank = optimal_rank(s, x.shape)
    # clamp to the numerical rank: Σ⁻¹ on near-zero singular values would
    # blow up the reduced operator
    num_rank = int((s > max(s[0], 1e-30) * 1e-6).sum())
    rank = int(min(rank, s.shape[0], max(num_rank, 1)))
    u, s, v = u[:, :rank], s[:rank], v[:, :rank]

    # V Σ⁻¹ [m, r], f32 as in the JAX package
    v_inv = torch.from_numpy(v * (1.0 / s)).to(data.device)
    # reduced operator, contracted in the cheap order: Uᵀ X' is [r, m]
    a_tilde = ((u.T @ x_prime) @ v_inv).cpu().numpy()

    eigvals, w = np.linalg.eig(a_tilde)

    # exact modes: Φ = X' V Σ⁻¹ W
    modes = (x_prime @ v_inv).cpu().numpy() @ w

    # continuous-time quantities; eig returns a real array when every
    # eigenvalue is real — cast so log(negative) lands on the complex branch
    # instead of NaN
    log_ev = np.log(np.where(eigvals == 0, 1e-30, eigvals).astype(np.complex128))
    frequencies = log_ev.imag / (2 * np.pi * dt)
    growth_rates = log_ev.real / dt

    # amplitudes: least-squares fit of the modes to the first snapshot
    first = data[:, 0].cpu().numpy().astype(np.complex128)
    amplitudes, *_ = np.linalg.lstsq(modes, first, rcond=None)

    return {"eigenvalues": eigvals, "modes": modes, "frequencies": frequencies,
            "growth_rates": growth_rates, "amplitudes": amplitudes,
            "rank": rank}
