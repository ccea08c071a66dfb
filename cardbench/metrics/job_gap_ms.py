"""job_gap_ms (pipeline entry, program span): the port's between-job gap
(row `job_gap` of its table: from the return of a finalize's copy to the
host, torch_backend._to_host, to the next job's first upload or commit)
in host milliseconds a job of the traced window: what the host does while
the card has nothing of the jobs queued, the finalize's tail, the result
and the next job's create and ingest up to its first device work. A
window of n jobs closes n - 1 gaps; the sum is divided by n."""

from .. import program_spans


def read(run):
    return program_spans.ms_per_job(run, "job_gap")
