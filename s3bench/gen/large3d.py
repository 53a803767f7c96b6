"""The 3D cloud of the reference's large-scale example
(``examples/s3_synthetic_large_scale.py``, bench workload 6): points
uniform in [0, 4] x [0, 1] x [0, 1], float32, and its turbulent-wake
metric ``exp(-max(x - 0.5, 0)) · exp(-((y - 0.5)² + (z - 0.5)²) / 0.1)
+ 0.01``, float64.  Each ``(seed, job)`` draws its own cloud of the
configuration's size."""
import numpy as np


def make(config: dict, rng: np.random.Generator, device="cpu") -> dict:
    """The cloud and its metric, on the host (``device`` is not needed)."""
    lower, upper = config["box"]
    xyz = rng.uniform(lower, upper,
                      size=(int(config["n_points"]), 3)).astype(np.float32)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    metric = (np.exp(-np.maximum(x - 0.5, 0))
              * np.exp(-((y - 0.5) ** 2 + (z - 0.5) ** 2) / 0.1)
              + 0.01).astype(np.float64)
    return {"points": xyz, "metric": metric}
