"""``checkpoint_s``: the program's ``data_final_mesh["t_checkpoint"]``: the
``s_cube`` checkpoint write of ``execute_grid_generation``; summed over a job's grids and averaged over
the jobs of the run."""


def read(run):
    return sum(j["checkpoint_s"] for j in run.jobs) / len(run.jobs)
