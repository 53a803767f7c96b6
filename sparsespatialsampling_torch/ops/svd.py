"""Thin SVD primitives of the analysis layer, on a torch device.

Port of the JAX package's ``ops/svd.py``; both replace the flowtorch
``SVD`` of the reference (``sparseSpatialSampling/utils.py:302-346``):

- :func:`economy_svd` — exact thin SVD.  Tall-skinny matrices (the S³
  snapshot shape: many cells, few snapshots) take the float64 snapshot
  method, the Gram matrix accumulated on the device and its ``n×n``
  eigendecomposition on the host; squarish ones ``torch.linalg.svd``.
- :func:`randomized_svd` — the Halko-Martinsson-Tropp range finder: a
  Gaussian sketch, QR power iterations and a small SVD, all on the device.

Rank selection without an explicit ``rank`` follows the Gavish-Donoho
optimal hard threshold (:func:`optimal_rank`), host numpy as in the JAX
package, so both give the same rank for the same spectrum.

Matrices may be numpy arrays or tensors; the work runs on ``device``
(``None`` means the card).  The matmuls here run in f32 or f64, never in
TF32: they rely on PyTorch's default ``allow_tf32 = False``.
"""
import numpy as np
import torch

from .._device import resolve_device

# rows of the f32 matrix cast to f64 at a time by the Gram accumulation and
# by frobenius_sq (bounds the f64 scratch to 64 Ki rows)
_CHUNK = 65536


def optimal_rank(s: np.ndarray, shape) -> int:
    """Gavish-Donoho optimal hard threshold rank for a noisy matrix.

    ω(β) ≈ 0.56 β³ − 0.95 β² + 1.82 β + 1.43 with β = n/m (m ≥ n);
    keep singular values above ω·median(s).  At least one mode is kept.
    """
    m, n = max(shape), min(shape)
    beta = n / m
    omega = 0.56 * beta ** 3 - 0.95 * beta ** 2 + 1.82 * beta + 1.43
    tau = omega * np.median(s)
    return max(int((s > tau).sum()), 1)


def frobenius_sq(a, chunk: int = _CHUNK) -> float:
    """``‖a‖_F²`` accumulated in float64 over row chunks (no full f64 copy),
    on the tensor's device for a tensor, in numpy for an array.

    The sketched-rank criterion subtracts the sketch energy from this —
    the tail can be orders of magnitude smaller than the total, so f32
    accumulation error would swamp it."""
    total = 0.0
    for lo in range(0, a.shape[0], chunk):
        blk = a[lo:lo + chunk]
        if isinstance(blk, torch.Tensor):
            total += float(torch.square(blk.double()).sum())
        else:
            total += float(np.square(blk.astype(np.float64, copy=False)).sum())
    return total


def optimal_rank_sketched(s: np.ndarray, shape, fro_norm_sq: float) -> int:
    """Gavish-Donoho rank from a TRUNCATED spectrum (randomized-SVD sketch).

    The criterion needs the median of the *full* spectrum, but a sketch only
    carries the top ``l`` values — their median overestimates the noise
    floor and biases the rank low.  The unseen tail is reconstructed from
    energy conservation: ``Σ_tail s² = ‖A‖_F² − Σ_sketch s²``, modeled as a
    flat noise floor ``s_tail = sqrt(tail_energy / (n_total − l))``.  When
    the true median falls inside the tail, that floor IS the median
    estimate; otherwise the sketch median is used directly.
    """
    m, n = max(shape), min(shape)
    l = s.shape[0]
    if l >= n:  # sketch covers the whole spectrum — exact criterion
        return optimal_rank(s, shape)
    beta = n / m
    omega = 0.56 * beta ** 3 - 0.95 * beta ** 2 + 1.82 * beta + 1.43
    tail_energy = max(float(fro_norm_sq) - float(np.square(s).sum()), 0.0)
    tail_rms = np.sqrt(tail_energy / max(n - l, 1))
    if l > n // 2:
        median = float(np.sort(s)[l - 1 - n // 2])  # (n//2)-th largest
    else:
        median = float(tail_rms)
    tau = omega * median
    return max(int((s > tau).sum()), 1)


def as_matrix(a, device) -> torch.Tensor:
    """``a`` as a contiguous f32 tensor on ``device`` (no copy where it
    already is one)."""
    return torch.as_tensor(a, dtype=torch.float32).to(device).contiguous()


def _gram(a: torch.Tensor) -> np.ndarray:
    """``aᵀa`` in float64 on ``a``'s device, one row chunk cast at a time;
    returned on the host for the eigendecomposition."""
    n = a.shape[1]
    gram = torch.zeros((n, n), dtype=torch.float64, device=a.device)
    for lo in range(0, a.shape[0], _CHUNK):
        blk = a[lo:lo + _CHUNK].double()
        gram += blk.T @ blk
    return gram.cpu().numpy()


def _eigh_descending(gram: np.ndarray) -> tuple:
    """Host f64 ``eigh`` of the Gram matrix: singular values (descending)
    and right singular vectors."""
    lam, v = np.linalg.eigh(gram)
    lam, v = lam[::-1], v[:, ::-1]
    return np.sqrt(np.maximum(lam, 0.0)), v


def _modes(a: torch.Tensor, v_scaled: np.ndarray) -> torch.Tensor:
    """The f32 mode product ``a @ (V·Σ⁻¹)`` on ``a``'s device."""
    return a @ torch.from_numpy(v_scaled.astype(np.float32)).to(a.device)


def _tall_skinny_svd(a: torch.Tensor, max_rank: int = None) -> tuple:
    """Exact thin SVD of a tall-skinny matrix by the float64 snapshot
    method: the Gram matrix ``aᵀa`` accumulated in f64 on the device, its
    ``n×n`` eigendecomposition in host f64, and the modes as one f32
    matmul on the device.

    In float64 the Gram squaring is harmless — singular values resolve down
    to ~√(eps·√m)·σ₁ ≈ 3e-7·σ₁, below the f32 input data's own precision.
    ``s`` always carries the FULL spectrum (rank selection needs it); with
    ``max_rank`` only that many mode/V columns are materialized.  Returns
    ``(U, s, V)``: U a tensor on ``a``'s device, s and V host f32."""
    n = a.shape[1]
    s, v = _eigh_descending(_gram(a))
    floor = np.finfo(np.float64).eps ** 0.5 * max(s[0], 1e-300)
    inv = np.where(s > floor, 1.0 / np.maximum(s, floor), 0.0)
    cols = n if max_rank is None else max(min(int(max_rank), n), 1)
    u = _modes(a, v[:, :cols] * inv[None, :cols])
    return u, s.astype(np.float32), v[:, :cols].astype(np.float32)


def economy_svd_device(a: torch.Tensor, max_rank: int = None) -> tuple:
    """:func:`economy_svd` of an f32 tensor, keeping U on its device:
    returns ``(U tensor, s, V)`` with s and V host f32."""
    m, n = a.shape
    if m >= 8 * n and m >= 4096 and m * n * n <= 1e11:
        return _tall_skinny_svd(a, max_rank)
    # the JAX package zero-pads the rows to a power of two only to bound
    # XLA's compiled shapes; zero rows change neither s nor V, and an eager
    # SVD compiles nothing, so the port does not pad
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    return u, s.cpu().numpy(), vt.T.cpu().numpy()


def economy_svd(a, max_rank: int = None, device=None) -> tuple:
    """Exact thin SVD ``a = U diag(s) Vᵀ``; returns numpy ``(U, s, V)``
    with V the right singular vectors as columns (``V[:, i]``).

    ``s`` always carries the full spectrum; with ``max_rank`` only that
    many U/V columns are materialized on the tall-skinny route (the
    spectrum is free there, the tall mode gemm is not).  Tall-skinny
    matrices take the float64 Gram route (:func:`_tall_skinny_svd`),
    squarish ones ``torch.linalg.svd``."""
    u, s, v = economy_svd_device(as_matrix(a, resolve_device(device)),
                                 max_rank)
    return u.cpu().numpy(), s, v


def randomized_svd_device(a: torch.Tensor, rank: int, n_oversample: int = 10,
                          n_iter: int = 2, seed: int = 0) -> tuple:
    """Randomized range finder + small SVD of an f32 tensor on its device.

    Sketch width ``l = min(rank + n_oversample, n)``; power iterations with
    QR re-orthogonalization for spectral accuracy.  The Gaussian sketch Ω
    is drawn on the CPU from a generator seeded with ``seed`` and then
    moved, so every device uses the same sketch.  Returns tensors
    ``(U [m, rank], s [rank], V [n, rank])``."""
    n = a.shape[1]
    l = min(rank + n_oversample, n)
    gen = torch.Generator().manual_seed(int(seed))
    omega = torch.randn((n, l), generator=gen,
                        dtype=torch.float32).to(a.device, a.dtype)
    q = torch.linalg.qr(a @ omega).Q              # [m, l]
    for _ in range(n_iter):
        z = torch.linalg.qr(a.T @ q).Q            # [n, l]
        q = torch.linalg.qr(a @ z).Q
    ub, s, vt = torch.linalg.svd(q.T @ a, full_matrices=False)
    return (q @ ub)[:, :rank], s[:rank], vt[:rank].T


def randomized_svd(a, rank: int, n_oversample: int = 10, n_iter: int = 2,
                   seed: int = 0, device=None) -> tuple:
    """Randomized thin SVD of rank ``rank``; returns numpy ``(U, s, V)``."""
    u, s, v = randomized_svd_device(as_matrix(a, resolve_device(device)),
                                    int(rank), int(n_oversample),
                                    int(n_iter), seed)
    return u.cpu().numpy(), s.cpu().numpy(), v.cpu().numpy()
