"""Grid walls of smoke phases, in turns, on one card.

    python3 smoke_compare.py OLD_DIR NEW_DIR [ROUNDS]
    python3 smoke_compare.py --routes DIR [ROUNDS]

The first form runs two checkouts: each run is a fresh process in one
checkout, in the order OLD, NEW, NEW, OLD, then NEW, OLD, OLD, NEW, and so
on for ROUNDS (default 2) pairs of pairs.  A run builds that checkout's
kernels and calls the checkout's own ``chip_smoke.py`` phases
``grid2d_metric``, ``oat2d``, ``cylinder3d``, ``mdl2d``, ``grid3d`` and
``stl3d`` (each checks its pinned grid, its kNN index built cold), then prints one JSON line of their ``refine_total``,
``init`` and epoch walls (``SMOKE_COMPARE_PHASES=oat2d,mdl2d`` in the
environment runs only those).  Write an older commit into a git-ignored
directory first, e.g. ``git archive <commit> | tar -x -C
_smoke_checkout/parent``.

The second form runs one checkout's three routes in turns (graphs, eager
body, host loop, host loop, eager body, graphs, ...): the device-resident
loops (``SamplingTree.DEVICE_LOOP = True``, the default: the adaptive loop
and the geometry loop) with each window iteration a replay of a captured
CUDA graph (``SamplingTree._LOOP_GRAPHS = True``, the default), the same
loops with their bodies run eagerly (``_LOOP_GRAPHS = False``), and the
host loop and the host's per-level geometry walk (``DEVICE_LOOP =
False``), over every grid workload with a pin (``ROUTE_PHASES``); each
run's line also carries the routes' counters, the graphs' among them.
Every line carries the geometry phase's wall.

The last line is the card's ``nvidia-smi`` name and power limit.
"""
import json
import os
import subprocess
import sys
import tempfile

PHASES = ("grid2d_metric", "oat2d", "cylinder3d", "mdl2d", "grid3d",
          "stl3d")
# the switches of each route: (DEVICE_LOOP, _LOOP_GRAPHS)
ROUTES = {"graphs": (True, True), "eager_body": (True, False),
          "host_loop": (False, True)}
ROUTE_PHASES = ("grid3d", "grid2d_metric", "oat2d", "cylinder3d", "mdl2d",
                "mdl2d_25k", "c2d_reltol", "stl3d")


def walls(checkout: str, route: str = None) -> dict:
    """One run's walls, in this process (the child of :func:`main`);
    ``route`` (of ``ROUTES``) sets the routes."""
    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import chip_smoke
    from sparsespatialsampling_torch import _build
    from sparsespatialsampling_torch.engine import tree
    _build.build_all()
    out = {"checkout": checkout}
    phases = tuple(os.environ.get("SMOKE_COMPARE_PHASES", "").split(",")
                   if os.environ.get("SMOKE_COMPARE_PHASES") else PHASES)
    if route is not None:
        from sparsespatialsampling_torch.engine.tree import SamplingTree
        SamplingTree.DEVICE_LOOP, SamplingTree._LOOP_GRAPHS = ROUTES[route]
        out["route"] = route
        phases = ROUTE_PHASES
    with tempfile.TemporaryDirectory() as tmp:
        for name in phases:
            # every phase builds its kNN index cold (a checkout older than
            # the engine's index cache has none)
            getattr(tree, "_KNN_INDEX_CACHE", {}).clear()
            args = (tmp,)
            if name == "stl3d":
                args += (os.path.join(tmp, "sphere.stl"),)
                chip_smoke.sphere_stl(args[1])
            d = getattr(chip_smoke, f"phase_{name}")(*args)[0]
            out[name] = {"refine_total": d["wall_s"]["refine_total"],
                         "init": d["wall_s"]["init"],
                         "geometry": d["wall_s"]["geometry"],
                         "epoch_wall_s": d["epoch_wall_s"]}
            if route is not None:
                out[name]["adaptive_split_s"] = d["adaptive_split_s"]
                out[name]["adaptive_route"] = d["adaptive_route"]
                out[name]["geometry_route"] = d["geometry_route"]
    return out


def main() -> int:
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--one":
        route = sys.argv[3] if len(sys.argv) == 4 else None
        print(json.dumps(walls(sys.argv[2], route)), flush=True)
        return 0
    if len(sys.argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    rounds = int(sys.argv[3]) if len(sys.argv) == 4 else 2
    if sys.argv[1] == "--routes":
        a, b, c = ([sys.argv[2], route] for route in ROUTES)
        order = [a, b, c, c, b, a] * rounds
    else:
        a, b = [sys.argv[1]], [sys.argv[2]]
        order = ([a, b, b, a, b, a, a, b] * rounds)[:4 * rounds]
    for args in order:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", *args], stdout=subprocess.PIPE,
                             text=True, check=True)
        print(run.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
