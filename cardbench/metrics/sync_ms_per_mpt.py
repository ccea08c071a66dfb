"""sync_ms_per_mpt (device layout, program span): host milliseconds in
the port's `pcr.sync` span, the host blocked on the card
(device_prep.sync: the layout's sizes, the arena's buffer wait), per
million points of the traced window's jobs."""

from .. import program_spans


def read(run):
    return program_spans.ms_per_mpt(run, "sync")
