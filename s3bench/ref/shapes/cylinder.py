"""``{"type": "cylinder", "position", "radius"}``: a circular cylinder
between the centres of its end discs ``position = [start, end]``.  A
point is inside when its projection onto the axis lies in ``[0, |axis|]``
and its distance from the axis line, ``|axis × (p - start)| / |axis|``,
is at most the radius (both bounds inclusive).  A frustum (a radius at
each end) is not supported."""
import numpy as np
import torch


def _radius(spec: dict) -> float:
    r = spec["radius"]
    if not isinstance(r, (int, float)):
        raise ValueError(f"the reference's cylinder takes one radius, not "
                         f"{r!r}")
    return float(r)


def bounds(spec: dict) -> tuple:
    """The end discs' centres' box widened by the radius on every side."""
    ends = np.asarray(spec["position"], float)
    r = _radius(spec)
    return ends.min(0) - r, ends.max(0) + r


def inside(spec: dict, p: torch.Tensor) -> torch.Tensor:
    r = _radius(spec)
    ends = torch.as_tensor(spec["position"], dtype=p.dtype, device=p.device)
    start, axis = ends[0], ends[1] - ends[0]
    length = torch.linalg.vector_norm(axis)
    rel = p - start
    along = (rel * axis).sum(-1) / length
    cross = torch.linalg.cross(axis.expand_as(rel), rel, dim=-1)
    distance = torch.linalg.vector_norm(cross, dim=-1) / length
    return (along >= 0) & (along <= length) & (distance <= r)
