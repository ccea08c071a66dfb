"""job_p95_ms (end to end, host clock): the 95th percentile over every job
of the window of its wall, Pipeline.create to the band on the host."""

from ..stats import percentile


def read(run):
    if not run.job_walls:
        return None
    return percentile(run.job_walls, 95) * 1e3
