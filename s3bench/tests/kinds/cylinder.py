"""Cases of the ``cylinder`` kind: an axis-aligned and an oblique
cylinder, kept inside and not, with points on their lateral surfaces, end
caps, rims and axes, beside points around them."""
import numpy as np


def _surface_points(rng, start, end, radius, n):
    """Points on the lateral surface, the end caps and the rims of the
    cylinder ``start``-``end``, and on its axis (beyond its ends too)."""
    axis = end - start
    unit = axis / np.linalg.norm(axis)
    u = np.cross(unit, [1.0, 0.0, 0.0] if abs(unit[0]) < 0.9
                 else [0.0, 1.0, 0.0])
    u /= np.linalg.norm(u)
    v = np.cross(unit, u)

    def at(t, r, phi):
        return (start + t[:, None] * axis
                + r[:, None] * (np.cos(phi)[:, None] * u
                                + np.sin(phi)[:, None] * v))
    phi = rng.uniform(0, 2 * np.pi, size=(4, n))
    t = rng.uniform(0, 1, size=n)
    cap = rng.integers(0, 2, size=n).astype(float)
    r = radius * np.sqrt(rng.uniform(0, 1, size=n))
    return np.concatenate([
        at(t, np.full(n, radius), phi[0]),            # lateral surface
        at(cap, r, phi[1]),                           # end caps
        at(cap, np.full(n, radius), phi[2]),          # rims
        at(rng.uniform(-0.5, 1.5, size=n), np.zeros(n), phi[3])])  # axis


def _distance_to_surface(p, start, end, radius):
    """Each point's distance to the finite cylinder's surface."""
    axis = end - start
    length = np.linalg.norm(axis)
    rel = p - start
    along = rel @ axis / length
    radial = np.linalg.norm(rel - along[:, None] * axis / length, axis=1)
    past = np.maximum(np.maximum(-along, along - length), 0)
    within = (along >= 0) & (along <= length)
    inner = np.minimum(np.minimum(radius - radial, along), length - along)
    outer = np.hypot(np.maximum(radial - radius, 0), past)
    return np.where(within & (radial <= radius), inner, outer)


def _exact_points(rng, n):
    """Points of the axis-aligned case whose coordinates are dyadic, so
    that both sides compute every product and root exactly: on the
    lateral surface (3-4-5 offsets of the radius 5/8), the caps, the
    rims and the axis."""
    offsets = np.array([[3, 4], [4, 3], [5, 0], [0, 5]], float) / 8
    offsets = np.concatenate([offsets * [sx, sy] for sx in (1, -1)
                              for sy in (1, -1)])
    k = rng.integers(0, len(offsets), size=n)
    z = rng.integers(0, 65, size=n) / 64 + 0.125
    caps = rng.choice([0.125, 1.125], size=n)
    inside_disc = rng.integers(-4, 5, size=(n, 2)) / 8
    lateral = np.column_stack([0.25 + offsets[k, 0], 0.5 + offsets[k, 1], z])
    capped = np.column_stack([0.25 + inside_disc[:, 0],
                              0.5 + inside_disc[:, 1], caps])
    rims = np.column_stack([0.25 + offsets[k, 0], 0.5 + offsets[k, 1],
                            caps])
    axis = np.column_stack([np.full(n, 0.25), np.full(n, 0.5),
                            rng.integers(-32, 97, size=n) / 64])
    return np.concatenate([lateral, capped, rims, axis])


def cases(rng):
    """``(spec, points, near)`` a case.  The axis-aligned cylinder's axis
    has length 1 and its radius is 5/8: every point on it is exactly there
    and decided alike (``near`` None).  On the oblique one a point on the
    surface may be decided apart, as the reference divides by the axis's
    length and the program multiplies by its rounded reciprocal and fuses
    the cross product's terms: ``near`` gives such points' distance to the
    surface."""
    from conftest import boundary_points
    out = []
    aligned = (np.array([0.25, 0.5, 0.125]), np.array([0.25, 0.5, 1.125]),
               0.625)
    oblique = (np.array([0.1, -0.2, 0.3]), np.array([0.9, 0.7, 1.1]), 0.3)
    for (start, end, radius), exact in ((aligned, True), (oblique, False)):
        lo = np.minimum(start, end) - radius
        hi = np.maximum(start, end) + radius
        if exact:
            on = _exact_points(rng, 500)
            near = None
        else:
            on = _surface_points(rng, start, end, radius, 100)
            near = (lambda p, s=start, e=end, r=radius:
                    _distance_to_surface(p, s, e, r))
        pts = np.concatenate([boundary_points(rng, lo, hi, 4000), on])
        for keep in (True, False):
            spec = {"type": "cylinder", "name": "cylinder",
                    "keep_inside": keep,
                    "position": [start.tolist(), end.tolist()],
                    "radius": radius}
            out.append((spec, pts, near))
    return out
