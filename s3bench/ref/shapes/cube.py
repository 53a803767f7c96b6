"""``{"type": "cube", "lower", "upper"}``: an axis-aligned box, its bounds
inclusive."""
import numpy as np
import torch


def bounds(spec: dict) -> tuple:
    return (np.asarray(spec["lower"], float),
            np.asarray(spec["upper"], float))


def inside(spec: dict, p: torch.Tensor) -> torch.Tensor:
    lo = torch.as_tensor(spec["lower"], dtype=p.dtype, device=p.device)
    hi = torch.as_tensor(spec["upper"], dtype=p.dtype, device=p.device)
    return ((p >= lo) & (p <= hi)).all(-1)
