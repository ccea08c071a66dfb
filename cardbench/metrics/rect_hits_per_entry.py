"""rect_hits_per_entry (kernels, program counter): the port's `rect_hits`
counter (the row hits K3's walk takes: each entry's rows in its tile
times the 32-column warp blocks its columns meet, summed) over its
`rect_entries`. Says on stderr the hits a point as well, beside which the
glyph's `work` has said how many cells a point the strokes keep."""

import sys

from .. import program_spans


def read(run):
    snap = program_spans.snapshot(run)
    if snap is None or not run.job_ends:
        return None
    entries = snap["counters"].get("rect_entries")
    hits = snap["counters"].get("rect_hits")
    if not entries or hits is None:
        return None
    points = run.points_per_job * len(run.job_ends)
    print(f"cardbench: rect_hits_per_entry: {hits / entries:.3f} row hits "
          f"an entry, {hits / points:.2f} a point", file=sys.stderr,
          flush=True)
    return hits / entries
