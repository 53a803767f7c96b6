"""``renumber_s``: the program's ``data_final_mesh["t_renumbering"]``: the
nodes' dedup and the renumbering; summed over a job's grids and averaged over
the jobs of the run."""


def read(run):
    return sum(j["renumber_s"] for j in run.jobs) / len(run.jobs)
