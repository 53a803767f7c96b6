"""``job_s``: the window's job walls summed over the whole jobs it
completed, divided by their number (host clock)."""


def read(run):
    if not run.jobs:
        return None
    return sum(j["wall"] for j in run.jobs) / len(run.jobs)
