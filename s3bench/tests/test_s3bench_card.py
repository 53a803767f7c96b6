"""On the card: one short run of a cell through the command, and the
tiny cells' check there (``python -m pytest s3bench/tests -m cuda``)."""
import json
import subprocess
import sys

import pytest

import harness


@pytest.mark.cuda
def test_short_run_of_a_cell(card):
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"),
                          "--workload", "oat15.cold", "--seed", "77",
                          "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900,
                         cwd=harness.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert {"job_s", "peak_mem_gb", "setup_s"} <= set(result["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["t3.sweep", "t2.sweep"])
def test_reference_agrees_on_the_card(card, tiny, name):
    cell = harness.Cell(name, tiny)
    inputs = cell.inputs(31, 0, card)
    rec = harness.run_job(cell, inputs, card, tiny / "out", keep=True)
    ok, shown = harness.verdict(
        harness.check(cell, inputs, rec["grids"], card),
        cell.traffic["limits"])
    assert ok, shown
