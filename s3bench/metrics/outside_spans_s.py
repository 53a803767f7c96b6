"""``outside_spans_s``: what is left of a job's wall once every span the
program recorded (``sparsespatialsampling_torch.trace``), on any thread,
is taken away as an interval: the benchmark's own statements and the
program's code outside its spans; averaged over the jobs of the traced
run.  Nothing to read where the program records no spans."""


def read(run):
    try:
        from sparsespatialsampling_torch import trace
    except ImportError:
        return None
    records = trace.records()
    if not records or not run.jobs:
        return None
    covered, end = 0, None
    for s, e in sorted((r["start_ns"], r["end_ns"]) for r in records):
        if end is None or s > end:
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    wall = sum(j["wall"] for j in run.jobs)
    return (wall - covered / 1e9) / len(run.jobs)
