"""Grid walls of two checkouts' smoke phases, in turns, on one card.

    python3 smoke_compare.py OLD_DIR NEW_DIR [ROUNDS]

Each run is a fresh process in one checkout, in the order OLD, NEW, NEW,
OLD, then NEW, OLD, OLD, NEW, and so on for ROUNDS (default 2) pairs of
pairs.  A run builds that checkout's kernels and calls the checkout's own
``chip_smoke.py`` phases ``grid2d_metric``, ``oat2d``, ``cylinder3d`` and
``mdl2d`` (each checks its pinned grid), then prints one JSON line of
their ``refine_total``, ``init`` and epoch walls.  The last line is the
card's ``nvidia-smi`` name and power limit.  Write an older commit into a
git-ignored directory first, e.g. ``git archive <commit> | tar -x -C
_smoke_checkout/parent``.
"""
import json
import os
import subprocess
import sys
import tempfile

PHASES = ("grid2d_metric", "oat2d", "cylinder3d", "mdl2d")


def walls(checkout: str) -> dict:
    """One run's walls, in this process (the child of :func:`main`)."""
    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import chip_smoke
    from sparsespatialsampling_torch import _build
    _build.build_all()
    out = {"checkout": checkout}
    with tempfile.TemporaryDirectory() as tmp:
        for name in PHASES:
            d, _ = getattr(chip_smoke, f"phase_{name}")(tmp)
            out[name] = {"refine_total": d["wall_s"]["refine_total"],
                         "init": d["wall_s"]["init"],
                         "epoch_wall_s": d["epoch_wall_s"]}
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(walls(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    old, new = sys.argv[1], sys.argv[2]
    rounds = int(sys.argv[3]) if len(sys.argv) == 4 else 2
    order = [old, new, new, old, new, old, old, new] * rounds
    for checkout in order[:4 * rounds]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", checkout], stdout=subprocess.PIPE,
                             text=True, check=True)
        print(run.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
