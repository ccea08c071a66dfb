"""rect_staged_per_entry (kernels, program counter): the port's
`rect_staged` counter (the entry slots K3's CTAs copy into shared memory:
each tile run's sub-chunks times the block size times the bands of its
tile that stage it) over its `rect_entries`. One where every entry is
staged once, by the one CTA whose rows it meets, plus the padding of each
tile run to whole sub-chunks."""

import sys

from .. import program_spans


def read(run):
    snap = program_spans.snapshot(run)
    if snap is None or not run.job_ends:
        return None
    entries = snap["counters"].get("rect_entries")
    staged = snap["counters"].get("rect_staged")
    if not entries or staged is None:
        return None
    print(f"cardbench: rect_staged_per_entry: {staged / entries:.4f} entry "
          f"slots staged an entry", file=sys.stderr, flush=True)
    return staged / entries
