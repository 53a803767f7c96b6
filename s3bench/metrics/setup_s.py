"""``setup_s``: from the start of the process to the end of set-up
(loading, kernel builds on a checkout's first run, the warm-up job)."""


def read(run):
    return run.setup_s
