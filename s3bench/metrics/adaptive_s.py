"""``adaptive_s``: the program's ``data_final_mesh["t_adaptive"]``: the adaptive
refinement; summed over a job's grids and averaged over
the jobs of the run."""


def read(run):
    return sum(j["adaptive_s"] for j in run.jobs) / len(run.jobs)
