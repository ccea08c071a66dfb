"""rot_entries_per_pt (device layout, program counter): the port's
`rot_entries` counter (the entries its K4 / K5 commits fold, halo copies
included) over the points of the traced window's jobs: how many times the
halo layout copies a point."""

from .. import program_spans


def read(run):
    snap = program_spans.snapshot(run)
    if snap is None or not run.job_ends:
        return None
    entries = snap["counters"].get("rot_entries")
    if not entries:
        return None
    return entries / (run.points_per_job * len(run.job_ends))
