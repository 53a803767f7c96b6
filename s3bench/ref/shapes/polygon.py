"""``{"type": "polygon", "coordinates"}``: a 2D polygon and the even-odd
rule: a point is inside when a ray towards +x crosses the closed boundary
an odd number of times (an open ring is closed); a horizontal edge is
crossed by no ray."""
import numpy as np
import torch


def bounds(spec: dict) -> tuple:
    pts = np.asarray(spec["coordinates"], float)
    return pts.min(0), pts.max(0)


def inside(spec: dict, p: torch.Tensor) -> torch.Tensor:
    b = np.asarray(spec["coordinates"], dtype=np.float64)
    if not np.allclose(b[0], b[-1]):
        b = np.concatenate([b, b[:1]])
    e = torch.as_tensor(b, dtype=p.dtype, device=p.device)
    x1, y1, x2, y2 = e[:-1, 0], e[:-1, 1], e[1:, 0], e[1:, 1]
    rise = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
    out = []
    for lo in range(0, p.shape[0], 1 << 16):
        x, y = p[lo:lo + (1 << 16), 0:1], p[lo:lo + (1 << 16), 1:2]
        straddle = (y1 > y) != (y2 > y)
        x_cross = (x2 - x1) * (y - y1) / rise + x1
        out.append((straddle & (x < x_cross)).sum(1) % 2 == 1)
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                  device=p.device)
