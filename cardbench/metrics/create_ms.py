"""create_ms (pipeline entry, program span): host milliseconds a job of
the traced window in the port's `pcr.create` span (Pipeline.create:
validation, the native thread cap, the engine's state tensors and its
arena with the arena's copy stream)."""

from .. import program_spans


def read(run):
    return program_spans.ms_per_job(run, "create")
