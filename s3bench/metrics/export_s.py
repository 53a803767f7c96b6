"""``export_s``: the benchmark's span around ``ExportData(...)`` and
``interpolate``, ended by a synchronise, which a cell that does not
export has not; summed over a job's grids and averaged over
the jobs of the run."""


def read(run):
    if not run.cell.export:
        return None
    return sum(j["export_s"] for j in run.jobs) / len(run.jobs)
