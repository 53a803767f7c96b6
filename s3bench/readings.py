"""The readings that set a cell's limits: the program's numbers on many
seeds, and the control's, in one process on the card.

    python3 s3bench/readings.py --workload <cell> --seeds 11,12,... [--control 21,22,23]

For each seed the checked job of a run with that seed (its inputs, the
program's job, the reference) is read as ``run.py`` reads it; for each
control seed the reference computed in bfloat16 is put in the program's
place (``harness.control_grids``) and judged the same way.  One JSON line
a seed on standard output.
"""
import json
import shutil
import sys
from pathlib import Path
from time import perf_counter


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    args = ap.parse_args(argv)
    import torch
    import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload)
    out_dir = harness.REPO / ".s3bench_out" / f"readings_{cell.name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control.split(",") if s]
    if seeds:
        warm = cell.inputs(seeds[0], -1, "cuda")
        harness.run_job(cell, warm, "cuda", out_dir)
        del warm
    for kind, seed in [("program", s) for s in seeds] + [
            ("control", s) for s in control]:
        job = cell.keep_job(seed)
        inputs = cell.inputs(seed, job, "cuda")
        t0 = perf_counter()
        if kind == "program":
            grids = harness.run_job(cell, inputs, "cuda", out_dir,
                                    keep=True)["grids"]
        else:
            grids = harness.control_grids(cell, inputs, "cuda",
                                          torch.bfloat16)
        t1 = perf_counter()
        numbers = harness.check(cell, inputs, grids, "cuda")
        line = {"workload": cell.name, "kind": kind, "seed": seed,
                "job": job, "numbers": numbers,
                "cells": [len(g["levels"]) for g in grids],
                "iterations": [g["iterations"] for g in grids],
                "produce_s": t1 - t0, "check_s": perf_counter() - t1}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent)]
    sys.exit(main())
