"""``geometry_host_s``: the program's ``engine.geometry_level`` spans
(``sparsespatialsampling_torch.trace``): the geometry phase's levels run
on the host's walk, each ended by a synchronise, whatever sent them
there (the counts of each span name the cause); summed over a job's
grids and averaged over the jobs of the traced run.  Nothing to read
where the run recorded no such span."""


def read(run):
    try:
        from sparsespatialsampling_torch import trace
    except ImportError:
        return None
    levels = [r for r in trace.records()
              if r["name"] == "engine.geometry_level"]
    if not levels or not run.jobs:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in levels) / 1e9 / len(
        run.jobs)
