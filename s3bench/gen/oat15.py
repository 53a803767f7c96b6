"""The synthetic OAT15A transonic-buffet slice (``chip_smoke.py``'s
``synthetic_oat15``, itself ``bench.py:222-272``): points uniform in
[-0.5, 1.5] x [-0.5, 0.5] outside a 240-vertex NACA-0012-like airfoil on
the chord [0, 1], float64, with a shock ridge, a wake and a broadband
texture as the metric; and the snapshots of its buffet cycle, float32
``[N, 1, S]``.  Each ``(seed, job)`` draws its own cloud; the field's
formula is the same for every cloud."""
import numpy as np
import torch


def airfoil_polygon(n: int = 240) -> np.ndarray:
    """NACA-0012-like closed profile on the chord [0, 1]."""
    xc = (1 - np.cos(np.linspace(0.0, np.pi, n // 2))) / 2
    t = 0.12
    yt = 5 * t * (0.2969 * np.sqrt(xc) - 0.1260 * xc - 0.3516 * xc ** 2
                  + 0.2843 * xc ** 3 - 0.1036 * xc ** 4)
    upper = np.stack([xc, yt], axis=1)
    lower = np.stack([xc[::-1], -yt[::-1]], axis=1)
    return np.concatenate([upper, lower[1:-1]])


def inside_polygon(xy, poly: np.ndarray):
    """Even-odd rule over the closed polygon (``xy`` a numpy array or a
    tensor), tested only for the points inside its bounding box (the
    others are outside)."""
    p = torch.as_tensor(xy)
    e = torch.as_tensor(np.concatenate([poly, poly[:1]]), dtype=p.dtype,
                        device=p.device)
    lo, hi = e.min(0).values, e.max(0).values
    out = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    rows = torch.nonzero(((p >= lo) & (p <= hi)).all(1))[:, 0]
    x1, y1, x2, y2 = e[:-1, 0], e[:-1, 1], e[1:, 0], e[1:, 1]
    x, y = p[rows, 0:1], p[rows, 1:2]
    straddle = (y1 > y) != (y2 > y)
    rise = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
    xcross = (x2 - x1) * (y - y1) / rise + x1
    out[rows] = (straddle & (x < xcross)).sum(1) % 2 == 1
    return out.cpu().numpy() if isinstance(xy, np.ndarray) else out


def _texture(x, y):
    """Twelve fixed sine modes (their wavenumbers and phases drawn once,
    from seed 7: part of the field, not of the cloud)."""
    trng = np.random.default_rng(7)
    tex = torch.zeros_like(x)
    for _ in range(12):
        kx, ky = trng.uniform(4, 40, 2)
        ph = trng.uniform(0, 2 * np.pi, 2)
        tex = tex + torch.sin(kx * x + ph[0]) * torch.sin(ky * y + ph[1])
    return tex


def make(config: dict, rng: np.random.Generator, device="cpu") -> dict:
    """The cloud (drawn by ``rng`` on the host) and its metric (float64,
    computed on ``device``)."""
    n = int(config["n_points"])
    lower, upper = config["box"]
    # about 4 % of the box lies inside the airfoil: draw 6 % more
    drawn = torch.as_tensor(rng.uniform(lower, upper,
                                        size=(int(n * 1.06), 2)),
                            device=device)
    poly = airfoil_polygon()
    xy = drawn[~inside_polygon(drawn, poly)][:n]
    if xy.shape[0] != n:
        raise RuntimeError(f"drew {xy.shape[0]} points outside the airfoil, "
                           f"not {n}")
    x, y = xy[:, 0], xy[:, 1]
    shock = torch.exp(-((x - 0.45) ** 2) / 0.002) * torch.exp(
        -(y - 0.05) ** 2 / 0.01)
    wake = (x > 0.9) * torch.exp(-(x - 0.9) / 0.4) * torch.exp(-y ** 2
                                                               / 0.02)
    metric = shock + 0.6 * wake + 0.071 * torch.abs(_texture(x, y)) / 12 \
        + 0.05
    return {"points": xy.cpu().numpy(), "metric": metric.cpu().numpy(),
            "polygon": poly}


def snapshots(config: dict, inputs: dict, n_snapshots: int,
              device) -> np.ndarray:
    """``[N, 1, S]`` float32 on the host: the shock ridge oscillating
    about x = 0.45 over the buffet period, the wake convected and the
    texture, computed on ``device`` 4,096 points at a time (so that the
    making holds some 100 MB of device memory at most, well under what
    a job holds) and copied back."""
    pts = torch.as_tensor(inputs["points"], dtype=torch.float64,
                          device=device)
    out = np.empty((pts.shape[0], 1, n_snapshots), dtype=np.float32)
    t = torch.arange(n_snapshots, dtype=torch.float64, device=device)[None]
    phase = 2 * np.pi * t / float(config["buffet_period_snapshots"])
    for lo in range(0, pts.shape[0], 4096):
        p = pts[lo:lo + 4096]
        x, y = p[:, 0:1], p[:, 1:2]
        shock = (torch.exp(-((x - 0.45 - 0.03 * torch.sin(phase)) ** 2)
                           / 0.002) * torch.exp(-(y - 0.05) ** 2 / 0.01))
        wake = ((x > 0.9) * torch.exp(-(x - 0.9) / 0.4)
                * torch.exp(-y ** 2 / 0.02)
                * (1 + 0.25 * torch.sin(phase - 6.0 * x)))
        field = (shock + 0.6 * wake + 0.071 * torch.abs(_texture(x, y)) / 12
                 + 0.05)
        out[lo:lo + p.shape[0], 0] = field.to(torch.float32).cpu().numpy()
    return out
