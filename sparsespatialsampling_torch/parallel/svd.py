"""Distributed randomized SVD: the snapshot matrix row-sharded over a mesh.

Port of the JAX package's ``parallel/svd.py``: the tall-skinny
Halko-Martinsson-Tropp range finder with each shard's products on its own
row block (library ``torch.matmul``, as the JAX package's ``jnp.dot``
outside any Pallas kernel), the ``[l, l]`` Gram matrices and ``[n, l]``,
``[l, n]`` projections summed on the root in shard order, and the small
factorisations (``eigh``, the QR of ``z``, the SVD of ``b``) on the root.
Orthogonalisation is two rounds of Gram whitening (the CholeskyQR2
pattern) with a rank-revealing ``eigh`` instead of a Cholesky factor:
where the sketch is numerically rank-deficient, the eigenvalue floor of
``1e-10·λmax`` zeroes the dead directions instead of producing NaN.

The Gaussian sketch Ω is drawn on the CPU from a generator seeded with
``seed`` (as ``ops/svd.randomized_svd_device`` draws it), so every mesh
uses the same sketch.  The products run in f32, never TF32 (PyTorch's
default ``allow_tf32 = False``).
"""
import torch

from .mesh import Mesh, all_gather, pad_to_multiple, psum, shard_rows


def _gram_whiten(ys: list, mesh: Mesh) -> list:
    """One Gram-whitening step of the row-sharded ``y``:
    ``q = y · V diag(λ^-½) Vᵀ`` with the eigenvalue floor ``1e-10·λmax``;
    dead directions map to zero columns."""
    gram = psum([y.T @ y for y in ys], mesh)
    lam, v = torch.linalg.eigh(gram)
    floor = 1e-10 * torch.clamp_min(lam[-1], 1e-30)
    inv_sqrt = torch.where(lam > floor,
                           torch.rsqrt(torch.maximum(lam, floor)),
                           torch.zeros_like(lam))
    w, vt = v * inv_sqrt[None, :], v.T
    return [(y @ w.to(y.device)) @ vt.to(y.device) for y in ys]


def _gram_whiten2(ys: list, mesh: Mesh) -> list:
    """Two whitening rounds, for orthogonality to f32 precision."""
    return _gram_whiten(_gram_whiten(ys, mesh), mesh)


def distributed_rsvd_device(a, rank: int, mesh: Mesh, n_oversample: int = 10,
                            n_iter: int = 2, seed: int = 0) -> tuple:
    """Randomized thin SVD of ``a [m, n]`` with its rows split over
    ``mesh`` (zero rows pad them to a multiple of the shard count; they
    change no product).  Returns tensors on the root ``(U [m, rank],
    s [rank], V [n, rank])``."""
    # each row block goes from where ``a`` lies to its shard's device
    a = torch.as_tensor(a, dtype=torch.float32)
    m, n = a.shape
    l = min(rank + n_oversample, n)
    blocks = shard_rows(pad_to_multiple(a, mesh.size), mesh)
    gen = torch.Generator().manual_seed(int(seed))
    omega = torch.randn((n, l), generator=gen, dtype=torch.float32)
    qs = _gram_whiten2([b @ omega.to(b.device) for b in blocks], mesh)
    for _ in range(n_iter):
        # power iteration: z = Aᵀq (summed over the row blocks), y = A z
        z = torch.linalg.qr(psum([b.T @ q for b, q in zip(blocks, qs)],
                                 mesh)).Q
        qs = _gram_whiten2([b @ z.to(b.device) for b in blocks], mesh)
    ub, s, vt = torch.linalg.svd(
        psum([q.T @ b for b, q in zip(blocks, qs)], mesh),
        full_matrices=False)
    u = all_gather([q @ ub.to(q.device) for q in qs], mesh)
    return u[:m, :rank], s[:rank], vt[:rank].T


def distributed_rsvd(a, rank: int, mesh: Mesh, n_oversample: int = 10,
                     n_iter: int = 2, seed: int = 0) -> tuple:
    """:func:`distributed_rsvd_device` as numpy ``(U, s, V)``."""
    u, s, v = distributed_rsvd_device(a, int(rank), mesh, int(n_oversample),
                                      int(n_iter), seed)
    return u.cpu().numpy(), s.cpu().numpy(), v.cpu().numpy()
