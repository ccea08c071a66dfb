"""syncs_per_call (device layout, program counter): the port's `syncs`
counter (every device_prep.sync) over its `pcr.ingest` spans, the host
synchronisations an ingest call makes."""

from .. import program_spans


def read(run):
    rows = program_spans.spans(run, "ingest")
    if rows is None or not rows[0]["n"]:
        return None
    syncs = program_spans.snapshot(run)["counters"].get("syncs", 0)
    return syncs / rows[0]["n"]
