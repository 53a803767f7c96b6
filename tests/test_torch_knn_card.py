"""The kNN index's build on the card against its build on the CPU.

The order, the plan and the neighbour table run on the index's device, so
CUDA's stable sort, ``bincount`` and f64 division must give the CPU
route's bytes (which ``tests/test_torch_knn.py`` holds against the JAX
package).  A 200,000-point 3D cloud (the box of the large-scale example,
with duplicate points) and a 2D cloud (with a dense core and one point
repeated past the capacity, so the plan shrinks over several passes and
reads its counts back for the percentile) are built on both devices, and
every output is compared bit for bit: the permutation, the padded points,
norms and values, the plan (h, C, dims, passes, cell ids, counts,
overflow, the dilated occupancy), the neighbour table and the grid's
layouts.  ``cuda`` marker: skips without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparsespatialsampling_torch.ops import knn as tknn  # noqa: E402


def _cloud(d):
    rng = np.random.default_rng(20 + d)
    if d == 3:
        pts = rng.uniform([0.0, 0.0, 0.0], [4.0, 1.0, 1.0], (199_000, 3))
        return np.concatenate([pts, pts[rng.choice(199_000, 1000)]])
    pts = np.concatenate([rng.uniform([-0.5, -0.5], [1.5, 0.5], (90_000, 2)),
                          rng.normal([0.2, 0.0], 0.01, (30_000, 2)),
                          np.full((100, 2), 0.7)])
    return pts


def _plan(cloud):
    perm = tknn._morton_order(cloud)
    plan = tknn._plan_grid(cloud[perm], cloud.shape[0],
                           tknn.KNNIndex.GRID_OCCUPANCY,
                           tknn.KNNIndex.GRID_CAPACITY,
                           tknn.KNNIndex.GRID_SHRINK_TARGET)
    plan["occ"] = tknn._max_dilated_occupancy(plan["counts"], plan["dims"],
                                              plan["C"])
    plan["nb"] = tknn._grid_neighbor_table(
        torch.from_numpy(plan["dims"]).to(cloud.device), plan["n_cells"])
    plan["perm"] = perm
    return plan


def _equal(got, ref, what):
    if isinstance(got, torch.Tensor):
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3], ids=["2d", "3d"])
def test_card_build_is_the_cpu_build(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the build's device route")
    pts = _cloud(d)
    values = np.sin(pts.sum(axis=1)).astype(np.float32)
    cpu = tknn.KNNIndex(pts, values=values, device="cpu")
    card = tknn.KNNIndex(pts, values=values, device="cuda")
    _equal(card._perm, cpu._perm, "_perm")
    for name in ("_points", "_points_sq", "_perm_dev", "_values"):
        _equal(getattr(card, name), getattr(cpu, name), name)
    assert set(card._grid) == set(cpu._grid)
    for key, ref in cpu._grid.items():
        _equal(card._grid[key], ref, key)

    centred = torch.from_numpy(cpu._points_host)
    pc, pg = _plan(centred), _plan(centred.cuda())
    assert set(pg) == set(pc)
    for key, ref in pc.items():
        _equal(pg[key], ref, key)
    if d == 2:
        # several passes, and the over-capacity branch's read of counts
        assert pc["passes"] >= 3 and int(pc["counts"].max()) > pc["C"]
