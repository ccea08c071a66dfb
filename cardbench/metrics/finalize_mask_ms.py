"""finalize_mask_ms (pipeline entry, program span): host milliseconds a
job of the traced window in the port's `pcr.finalize.mask` spans: the
band's allocation and the touched-tile masking (Pipeline._mask_strip and
the packed finalize's loop)."""

from .. import program_spans


def read(run):
    return program_spans.ms_per_job(run, "finalize.mask")
