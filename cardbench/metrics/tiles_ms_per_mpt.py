"""tiles_ms_per_mpt (pipeline entry, program span): host milliseconds in
the port's `pcr.ingest.tiles` span (Pipeline._track_tiles: the set of
tiles a cloud touched, derived again from every point's cell) per million
points of the traced window's jobs."""

from .. import program_spans


def read(run):
    return program_spans.ms_per_mpt(run, "ingest.tiles")
