"""Run one cell of the benchmark of ``sparsespatialsampling_torch``:

    python3 s3bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` with ``--trace 1``, and ``checks``, the numbers compared
beside their limits); standard error ends with the same numbers.
"""
import sys
from pathlib import Path

if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    # the harness's modules, and the program from the checkout's root
    sys.path[:0] = [str(here), str(here.parent)]
    import harness
    sys.exit(harness.main())
