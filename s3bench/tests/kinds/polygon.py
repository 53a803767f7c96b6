"""Cases of the ``polygon`` kind: the airfoil of ``gen/oat15.py`` and an
open L-shaped ring with horizontal and vertical edges, with points on
their vertices and edges and on the horizontal lines through their
vertices."""
import numpy as np


def _ring_points(rng, ring, n):
    """Points on a closed ring's vertices and edges, and on the horizontal
    lines through its vertices (rays through a vertex)."""
    a, b = ring, np.roll(ring, -1, axis=0)
    t = rng.uniform(0, 1, size=(n, 1))
    e = rng.integers(0, len(a), size=n)
    on_edges = a[e] + t * (b[e] - a[e])
    lo, hi = ring.min(0), ring.max(0)
    rows = rng.integers(0, len(a), size=n)
    through = np.stack([rng.uniform(lo[0] - 0.1, hi[0] + 0.1, n),
                        ring[rows, 1]], axis=1)
    return np.concatenate([ring, (a + b) / 2, on_edges, through])


def _distance_to_ring(p, ring):
    """Each point's distance to the nearest edge of the closed ``ring``."""
    a, b = ring, np.roll(ring, -1, axis=0)
    ab = b - a
    t = np.clip((((p[:, None] - a) * ab).sum(-1) / (ab * ab).sum(-1)), 0, 1)
    return np.linalg.norm(p[:, None] - (a + t[..., None] * ab), axis=-1).min(1)


def cases(rng):
    """``(spec, points, near)`` a case.  The L's vertices are dyadic, so a
    point on its edges is exactly there and every point is decided alike
    (``near`` None).  On the airfoil's edges a point may be decided apart
    where its crossing abscissa rounds, as the reference divides by the
    edge's rise and the program multiplies by its rounded reciprocal:
    ``near`` gives such points' distance to the ring."""
    import harness
    from conftest import boundary_points
    airfoil = harness.load_module("gen", "oat15").airfoil_polygon()
    ell = np.array([[0, 0], [1, 0], [1, 0.5], [0.5, 0.5], [0.5, 1],
                    [0, 1]], dtype=float)
    out = []
    for ring, keep, exact in ((airfoil, False, False), (ell, True, True),
                              (ell, False, True)):
        spec = {"type": "polygon", "name": "ring", "keep_inside": keep,
                "coordinates": ring}
        lo, hi = ring.min(0), ring.max(0)
        near = None if exact else (
            lambda p, ring=ring: _distance_to_ring(p, ring))
        out.append((spec, np.concatenate([
            boundary_points(rng, lo, hi, 2000),
            _ring_points(rng, ring, 2000)]), near))
    return out
