"""ingest_self_ms_per_mpt (pipeline entry, program span): the self time
of the port's `pcr.ingest` span (one a public Pipeline.ingest call), the
host milliseconds no span nested in it on the caller's thread covers, per
million points of the traced window's jobs: what the named spans leave
unexplained."""

from .. import program_spans


def read(run):
    return program_spans.ms_per_mpt(run, "ingest", key="self_s")
