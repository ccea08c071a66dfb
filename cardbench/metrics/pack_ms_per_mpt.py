"""pack_ms_per_mpt (transfer, program span): host milliseconds in the
port's `pcr.ingest.pack` span (the wire packed into its pinned buffer,
TorchEngine._upload_words's fill: native.pack_point_wire, or numpy) per
million points of the traced window's jobs."""

from .. import program_spans


def read(run):
    return program_spans.ms_per_mpt(run, "ingest.pack")
