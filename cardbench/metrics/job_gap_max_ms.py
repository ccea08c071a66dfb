"""job_gap_max_ms (pipeline entry, program span): the traced window's
longest single between-job gap (row `job_gap` of the port's table, its
`max_s`), in host milliseconds. Beside `job_gap_ms` it tells one long
stall from a cost every job pays."""

from .. import program_spans


def read(run):
    rows = program_spans.spans(run, "job_gap")
    if rows is None or rows[0].get("max_s") is None:
        return None
    return rows[0]["max_s"] * 1e3
