"""upload_ms_per_mpt (transfer, program span): host milliseconds in the
port's `pcr.ingest.buffer` (_Arena.checkout: the wait for a pinned
buffer's last upload, or a new pinned allocation) and `pcr.ingest.upload`
(_Arena.put: the copy's enqueue) spans, per million points of the traced
window's jobs."""

from .. import program_spans


def read(run):
    return program_spans.ms_per_mpt(run, "ingest.buffer", "ingest.upload")
