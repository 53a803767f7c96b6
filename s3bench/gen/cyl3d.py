"""The synthetic cylinder3D Re=3900 wake (``bench.py``'s
``synthetic_cylinder3d``, bench workload 2): points uniform in
[0, 2.2] x [0, 0.41] x [0, 0.41], none within 0.05 of the cylinder's
axis (x, y) = (0.2, 0.2), float64, with the TKE-like wake metric
``(x > 0.2) · exp(-max(x - 0.25, 0) / 0.8) · exp(-(y - 0.2)² / 0.02)
+ 0.01``, float64; and the snapshots of upstream's example as this
repo's mirror makes them (``examples/s3_for_cylinder3D_Re3900.py``), a
wave convected through the wake, float32 ``[N, 1, S]``.  Each
``(seed, job)`` draws its own cloud; the field's formula is the same for
every cloud."""
import numpy as np
import torch

AXIS_XY = (0.2, 0.2)
RADIUS = 0.05


def make(config: dict, rng: np.random.Generator, device="cpu") -> dict:
    """The cloud and its metric, on the host (``device`` is not needed).
    About 0.9 % of the box lies inside the cylinder: 1 % more points are
    drawn (and 100, so that a small cloud too has enough) and the first
    ``n_points`` outside it are kept."""
    n = int(config["n_points"])
    lower, upper = config["box"]
    xyz = rng.uniform(lower, upper, size=(int(n * 1.01) + 100, 3))
    r = np.hypot(xyz[:, 0] - AXIS_XY[0], xyz[:, 1] - AXIS_XY[1])
    xyz = xyz[r > RADIUS][:n]
    if xyz.shape[0] != n:
        raise RuntimeError(f"drew {xyz.shape[0]} points outside the "
                           f"cylinder, not {n}")
    x, y = xyz[:, 0], xyz[:, 1]
    metric = ((x > 0.2) * np.exp(-np.maximum(x - 0.25, 0) / 0.8)
              * np.exp(-((y - 0.2) ** 2) / 0.02) + 0.01).astype(np.float64)
    return {"points": xyz, "metric": metric}


def snapshots(config: dict, inputs: dict, n_snapshots: int,
              device) -> np.ndarray:
    """``[N, 1, S]`` float32 on the host: ``metric · (1 + 0.3 sin(10 x -
    20 t) cos(8 z))`` at ``t = 0.01 i``, computed in float64 on ``device``
    65,536 points at a time and copied back.  Each snapshot is a field of
    its own, not a multiple of one."""
    pts = torch.as_tensor(inputs["points"], dtype=torch.float64,
                          device=device)
    metric = torch.as_tensor(inputs["metric"], dtype=torch.float64,
                             device=device)
    out = np.empty((pts.shape[0], 1, n_snapshots), dtype=np.float32)
    t = 0.01 * torch.arange(n_snapshots, dtype=torch.float64,
                            device=device)[None]
    for lo in range(0, pts.shape[0], 1 << 16):
        p = pts[lo:lo + (1 << 16)]
        x, z = p[:, 0:1], p[:, 2:3]
        field = metric[lo:lo + p.shape[0], None] * (
            1 + 0.3 * torch.sin(10 * x - 20 * t) * torch.cos(8 * z))
        out[lo:lo + p.shape[0], 0] = field.to(torch.float32).cpu().numpy()
    return out
