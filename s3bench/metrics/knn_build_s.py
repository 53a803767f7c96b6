"""``knn_build_s``: the program's ``knn.build`` spans
(``sparsespatialsampling_torch.trace``): the kNN index's cold builds,
each ended by a synchronise; summed over a job's grids and averaged over
the jobs of the traced run.  Nothing to read where the program records
no spans."""


def read(run):
    try:
        from sparsespatialsampling_torch import trace
    except ImportError:
        return None
    records = trace.records()
    if not records or not run.jobs:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in records
               if r["name"] == "knn.build") / 1e9 / len(run.jobs)
