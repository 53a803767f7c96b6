"""``prefetch_s``: the program's ``s3.prefetch`` spans
(``sparsespatialsampling_torch.trace``): the worker thread that builds the
export's weight cache after each grid, whether the job exports or not;
summed over a job's grids and averaged over the jobs of the traced run.
Nothing to read where the program records no spans."""


def read(run):
    try:
        from sparsespatialsampling_torch import trace
    except ImportError:
        return None
    records = trace.records()
    if not records or not run.jobs:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in records
               if r["name"] == "s3.prefetch") / 1e9 / len(run.jobs)
