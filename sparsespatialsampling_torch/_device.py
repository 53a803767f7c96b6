"""Device resolution for the port's public entry points.

Counterpart of the JAX package's ``_backend.py``, without its compilation
cache logic (PyTorch runs eagerly; the one hand-written kernel is built by
``_build.py``).  Every entry point takes ``device=None``, which means the
card: a caller who wants the CPU says so, and a missing card is an error,
never a silent fall back to the CPU.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise when CUDA is asked for but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available to this process; pass device='cpu' to "
            "run the port on the CPU (its kernels then use their plain "
            "PyTorch versions).")
    return dev
