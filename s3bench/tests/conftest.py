"""The harness's own tests (run them with ``python -m pytest s3bench/tests``
from the root of the repository; the tests marked ``cuda`` need a card)."""
import json
import shutil
import sys
from pathlib import Path

import pytest

S3BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(S3BENCH), str(S3BENCH.parent)]


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def boundary_points(rng, lo, hi, n):
    """Points around the box ``[lo, hi]``, about half of their coordinates
    snapped to a bound: on its faces, edges and vertices (its corners
    too)."""
    import numpy as np
    d = len(lo)
    p = rng.uniform(lo - 0.25, hi + 0.25, size=(n, d))
    snap = rng.integers(0, 4, size=(n, d))
    p = np.where(snap == 1, lo, np.where(snap == 2, hi, p))
    corners = np.array([[(hi if (c >> a) & 1 else lo)[a] for a in range(d)]
                        for c in range(2 ** d)])
    return np.concatenate([p, corners])


def tiny_root(root: Path) -> Path:
    """A copy of the benchmark's generators, metrics and bounds under
    ``root`` with two tiny cells: ``t3.sweep`` (the 3D cloud at 3,000
    points, two grids) and ``t2.sweep`` (the airfoil at 3,000 points, two
    grids, the export of 6 snapshots)."""
    for sub in ("gen", "metrics", "roofline"):
        shutil.copytree(S3BENCH / sub, root / sub)
    shutil.copy(S3BENCH / "peaks.json", root / "peaks.json")
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    c3 = json.loads((S3BENCH / "configs/large3d.json").read_text())
    c3.update(name="t3", n_points=3000,
              settings={"uniform_levels": 2, "n_cells_max": 500,
                        "n_cells_iter_start": 20})
    (root / "configs/t3.json").write_text(json.dumps(c3))
    c2 = json.loads((S3BENCH / "configs/oat15.json").read_text())
    c2.update(name="t2", n_points=3000, n_snapshots=6)
    (root / "configs/t2.json").write_text(json.dumps(c2))
    limits = {"cells_unmatched_pct": 0.0, "metric_trace_gap": 1e-5}
    (root / "traffic/t3.sweep.json").write_text(json.dumps(
        {"config": "t3", "grids": [{}, {"n_cells_max": 300}],
         "export": False, "pool": 4, "limits": limits}))
    limits = {**limits, "field_gap": 1e-5}
    (root / "traffic/t2.sweep.json").write_text(json.dumps(
        {"config": "t2",
         "grids": [{"uniform_levels": 3, "min_metric": 0.5},
                   {"uniform_levels": 3, "n_cells_max": 400}],
         "geometry_settings": {"airfoil": {"min_refinement_level": 6}},
         "export": True, "pool": 4, "limits": limits}))
    return root


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_root(tmp_path / "bench")
