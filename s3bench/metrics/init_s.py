"""``init_s``: the benchmark's span around ``SparseSpatialSampling(...)``, ended
by a synchronise: the kNN index build, or the key's hash where the
index is reused; summed over a job's grids and averaged over
the jobs of the run."""


def read(run):
    return sum(j["init_s"] for j in run.jobs) / len(run.jobs)
