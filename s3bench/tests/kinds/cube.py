"""Cases of the ``cube`` kind: a 2D and a 3D box, kept inside and not, with
points on their faces, edges and vertices."""
import numpy as np


def cases(rng):
    """``(spec, points, near)`` a case; every point is decided alike
    (``near`` None)."""
    from conftest import boundary_points
    out = []
    for d in (2, 3):
        lo = np.array([0.125, -0.5, 0.25][:d])
        hi = np.array([0.75, 0.5, 1.0][:d])
        for keep in (True, False):
            spec = {"type": "cube", "name": "box", "keep_inside": keep,
                    "lower": lo.tolist(), "upper": hi.tolist()}
            out.append((spec, boundary_points(rng, lo, hi, 4000), None))
    return out
