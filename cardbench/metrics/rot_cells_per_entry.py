"""rot_cells_per_entry (kernels, program counter): the port's
`rot_window_cells` counter (the cells of each K4 / K5 entry's window cut
to its tile, summed) over its `rot_entries`: the dense window the kernel
walks an entry. Says on stderr the window cells a point as well, beside
which the glyph's `work` has said how many (point, cell) pairs a point
the ellipse keeps."""

import sys

from .. import program_spans


def read(run):
    snap = program_spans.snapshot(run)
    if snap is None or not run.job_ends:
        return None
    entries = snap["counters"].get("rot_entries")
    cells = snap["counters"].get("rot_window_cells")
    if not entries or cells is None:
        return None
    points = run.points_per_job * len(run.job_ends)
    print(f"cardbench: rot_cells_per_entry: {cells / entries:.2f} window "
          f"cells an entry, {cells / points:.2f} a point",
          file=sys.stderr, flush=True)
    return cells / entries
