"""The plain reference against the program's CPU path on tiny clouds, the
control (the reference in bfloat16 in the program's place) and the faults
the check must catch."""
import numpy as np
import pytest
import torch

import harness
from ref.knn import ExactKNN


@pytest.mark.parametrize("d,hole", [(2, False), (2, True), (3, False)])
def test_exact_knn_is_the_brute_force(d, hole):
    rng = np.random.default_rng(d)
    pts = rng.uniform(0, 1, size=(4000, d))
    if hole:
        pts = pts[np.linalg.norm(pts - 0.5, axis=1) > 0.3]
    q = np.concatenate([rng.uniform(-0.2, 1.2, size=(500, d)),
                        np.full((3, d), 0.5)])
    knn = ExactKNN(torch.from_numpy(pts))
    d2, idx = knn.query(torch.from_numpy(q), 9)
    full = ((q[:, None, :] - pts[None]) ** 2).sum(-1)
    want = np.lexsort((np.broadcast_to(np.arange(len(pts)), full.shape),
                       full), axis=1)[:, :9]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(d2.numpy(),
                                  np.take_along_axis(full, want, 1))


@pytest.mark.parametrize("name", ["t3.sweep", "t2.sweep"])
def test_reference_agrees_with_the_program(tiny, name):
    """The program's grid and export on the CPU are the reference's: no
    cell differs, the traces and the field within float32 rounding."""
    cell = harness.Cell(name, tiny)
    inputs = cell.inputs(2 ** 32 + 7, 0, "cpu")
    rec = harness.run_job(cell, inputs, "cpu", tiny / "out", keep=True)
    numbers = harness.check(cell, inputs, rec["grids"], "cpu")
    assert numbers["cells_unmatched_pct"] == 0.0
    assert numbers["metric_trace_gap"] < 1e-6
    if cell.export:
        assert numbers["field_gap"] < 1e-6
    ok, _ = harness.verdict(numbers, cell.traffic["limits"])
    assert ok


@pytest.mark.parametrize("name", ["t3.sweep", "t2.sweep"])
def test_control_is_not_correct(tiny, name):
    """The reference in bfloat16 in the program's place fails the check
    under the limits of the benchmark's own cells of its configuration."""
    cell = harness.Cell(name, tiny)
    inputs = cell.inputs(11, 0, "cpu")
    grids = harness.control_grids(cell, inputs, "cpu", torch.bfloat16)
    numbers = harness.check(cell, inputs, grids, "cpu")
    for real in (harness.HERE / "traffic").glob("*.json"):
        limits = harness.load_json(real)["limits"]
        if harness.load_json(real)["config"] != cell.config["generator"]:
            continue
        if any(v is None for v in limits.values()):
            continue
        ok, shown = harness.verdict(numbers, limits)
        assert not ok, (real.name, shown)
    # and the reference in float64 there passes its own check
    same = harness.control_grids(cell, inputs, "cpu", torch.float64)
    ok, shown = harness.verdict(harness.check(cell, inputs, same, "cpu"),
                                cell.traffic["limits"])
    assert ok, shown


def _faulty(monkeypatch, fault):
    """Break the timed path underneath the harness."""
    import sparsespatialsampling_torch as s3t
    from sparsespatialsampling_torch.engine.tree import SamplingTree
    if fault == "state_unchanged":
        # the adaptive refinement returns at once: the grid stays at its
        # uniform sweeps
        monkeypatch.setattr(SamplingTree, "_check_stopping_criteria",
                            lambda self: False)
        return
    orig_gen = s3t.SparseSpatialSampling.execute_grid_generation
    orig_interp = s3t.ExportData.interpolate

    def half_grid(self):
        orig_gen(self)
        n = len(self.levels) // 2
        self.levels, self.centers = self.levels[:n], self.centers[:n]
        self.faces = self.faces[:n]

    def half_field(self, *args, **kwargs):
        out = orig_interp(self, *args, **kwargs).copy()
        keep = out[: out.shape[0] // 2]
        return np.concatenate([keep, np.repeat(keep.mean(0, keepdims=True),
                                               out.shape[0] - len(keep), 0)])

    def altered_trace(self):
        orig_gen(self)
        self.data_final_mesh["metric_per_iter"][-1] *= 1.0 + 1e-3

    def altered_field(self, *args, **kwargs):
        out = orig_interp(self, *args, **kwargs).copy()
        out[len(out) // 3, 0, 2] *= 1.01
        return out
    if fault == "half_batch":
        monkeypatch.setattr(s3t.SparseSpatialSampling,
                            "execute_grid_generation", half_grid)
        monkeypatch.setattr(s3t.ExportData, "interpolate", half_field)
    elif fault == "altered_answer":
        monkeypatch.setattr(s3t.SparseSpatialSampling,
                            "execute_grid_generation", altered_trace)
    elif fault == "altered_field":
        monkeypatch.setattr(s3t.ExportData, "interpolate", altered_field)


@pytest.mark.parametrize("name,fault", [
    ("t3.sweep", "state_unchanged"), ("t3.sweep", "half_batch"),
    ("t3.sweep", "altered_answer"), ("t2.sweep", "state_unchanged"),
    ("t2.sweep", "half_batch"), ("t2.sweep", "altered_answer"),
    ("t2.sweep", "altered_field")])
def test_faults_are_not_correct(tiny, monkeypatch, name, fault):
    """The rest of a run (the job through the public entry points, the
    check, the verdict) with the timed path broken: ``correct`` false.
    One card, so no exchange between cards to leave out."""
    cell = harness.Cell(name, tiny)
    inputs = cell.inputs(23, 0, "cpu")
    _faulty(monkeypatch, fault)
    rec = harness.run_job(cell, inputs, "cpu", tiny / "out", keep=True)
    ok, shown = harness.verdict(
        harness.check(cell, inputs, rec["grids"], "cpu"),
        cell.traffic["limits"])
    assert not ok, shown


def test_near_tie_stops_give_each_decision(tiny):
    """Stop decisions that a captured metric 2e-3 apart would take
    otherwise (at this size the captured metric grows by about 1e-2 an
    iteration, so the target's and relTol's decisions are near-ties) yield
    the grid of each decision, the reference's own first."""
    from ref.s3 import reference_grid
    cell = harness.Cell("t2.sweep", tiny)
    inputs = cell.inputs(5, 0, "cpu")
    specs, _, _, knn = harness._reference_inputs(cell, inputs, "cpu")
    grids = reference_grid(knn, specs, dict(cell.grids[0]))
    its = [g.iterations for g in grids]
    assert len(grids) >= 2 and len(set(its)) == len(its)
    assert grids[0].iterations == max(its)
    # every alternative is a prefix of the reference's own run
    for g in grids[1:]:
        assert g.trace == grids[0].trace[:len(g.trace)]


# a geometry kind's cases are a file of its own, ``kinds/<type>.py``, whose
# ``cases(rng)`` gives specs with seeded points on and around them
KINDS = sorted(p.stem for p in (harness.HERE / "ref/shapes").glob("*.py"))


def test_every_kind_has_both_sides_and_a_case():
    for sub in ("geometry", "tests/kinds"):
        assert KINDS == sorted(p.stem for p in
                               (harness.HERE / sub).glob("*.py")), sub


@pytest.mark.parametrize("kind", KINDS)
def test_reference_inside_is_the_program_s(kind):
    """On seeded points, on the shapes' faces, edges and vertices too, the
    reference's inside test is the program object's ``mask_points``, and its
    cell flags are ``check_cells``, in both modes (removal and surface
    proximity), on lattice cells around the shape."""
    import ref.geometry
    make = harness.load_module("geometry", kind).make
    rng = np.random.default_rng(list(b"s3bench") + [KINDS.index(kind)])
    cases = harness.load_module("kinds", kind, harness.HERE / "tests").cases
    for spec, pts, near in cases(rng):
        obj = make(spec, False, None)
        p = torch.from_numpy(pts)
        got = ref.geometry.kind(spec).inside(spec, p).numpy()
        want = obj.mask_points(p).numpy()
        apart = np.nonzero(got != want)[0]
        if near is not None and apart.size:
            # only where the kind's case says the two may round apart: on
            # its boundary, and few
            assert apart.size <= 0.01 * len(pts)
            assert near(pts[apart]).max() < 1e-15
            keep = np.ones(len(pts), dtype=bool)
            keep[apart] = False
            got, want = got[keep], want[keep]
        np.testing.assert_array_equal(got, want)
        lo, hi = ref.geometry.kind(spec).bounds(spec)
        d = len(lo)
        h = float(np.max(hi - lo)) / 32
        coords = rng.integers(-4, 37, size=(3000, d))
        offsets = np.array([[(c >> a) & 1 for a in range(d)]
                            for c in range(2 ** d)])
        nodes = torch.from_numpy(
            lo + (coords[:, None, :] + offsets[None]) * h)
        for surface in (False, True):
            got = ref.geometry.cell_flags(spec, nodes, surface)
            want = obj.check_cells(nodes, surface)
            np.testing.assert_array_equal(got.numpy(), want.numpy())
            assert 0 < int(got.sum()) < len(got), (spec["keep_inside"],
                                                   surface)
