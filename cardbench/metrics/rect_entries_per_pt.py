"""rect_entries_per_pt (device layout, program counter): the port's
`rect_entries` counter (the K3 entries its commits fold whose rectangle
meets their tile: one a Bresenham run of a line, and one more for each
further tile a run spans) over the points of the traced window's jobs: the
runs a line, halo copies included."""

from .. import program_spans


def read(run):
    snap = program_spans.snapshot(run)
    if snap is None or not run.job_ends:
        return None
    entries = snap["counters"].get("rect_entries")
    if not entries:
        return None
    return entries / (run.points_per_job * len(run.job_ends))
