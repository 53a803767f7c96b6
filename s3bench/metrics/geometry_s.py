"""``geometry_s``: the program's ``data_final_mesh["t_geometry"]``: the
geometry-surface refinement, which a cell without a refined geometry
has not; summed over a job's grids and averaged over
the jobs of the run."""


def read(run):
    if all(j["geometry_s"] is None for j in run.jobs):
        return None
    return sum(j["geometry_s"] or 0.0 for j in run.jobs) / len(run.jobs)
