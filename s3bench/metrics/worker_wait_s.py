"""``worker_wait_s``: the program's ``workers.join`` spans on the main
thread (``sparsespatialsampling_torch.trace``): the waits for its worker
threads (the previous grid's export prefetch) before a run takes a cached
kNN index, before a graph capture and in the export; summed over a job's
grids and averaged over the jobs of the traced run.  Nothing to read
where the program records no spans."""
import threading


def read(run):
    try:
        from sparsespatialsampling_torch import trace
    except ImportError:
        return None
    records = trace.records()
    if not records or not run.jobs:
        return None
    main = threading.main_thread().ident
    return sum(r["end_ns"] - r["start_ns"] for r in records
               if r["name"] == "workers.join" and r["thread"] == main
               ) / 1e9 / len(run.jobs)
