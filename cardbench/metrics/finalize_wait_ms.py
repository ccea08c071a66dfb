"""finalize_wait_ms (pipeline entry, program span): the host seconds of
the port's `pcr.finalize.d2h` span less the copies' own device seconds
(its CUDA events, none on the CPU), in ms a job of the traced window: how
long the finalize's copy waits for device work queued before it (K2 in
`gauss_s4.device`)."""

from .. import program_spans


def read(run):
    rows = program_spans.spans(run, "finalize.d2h")
    if rows is None:
        return None
    wait = rows[0]["s"] - (rows[0]["device_s"] or 0.0)
    return wait * 1e3 / len(run.job_ends)
