"""finalize_pin_ms (transfer, program span): host milliseconds a job of
the traced window in the port's `pcr.finalize.pin` span, the checkout of
the pinned host block a finalize's copy lands in (torch_backend._to_host,
inside `finalize.d2h`, so also inside `finalize_wait_ms`). Says on stderr
beside it the bytes a job by which torch's pinned pool grew to give the
blocks (`d2h_pin_new_bytes`) and the checkout's longest call. None off a
card, where the copy lands in pageable memory."""

import sys

from .. import program_spans


def read(run):
    ms = program_spans.ms_per_job(run, "finalize.pin")
    if ms is None:
        return None
    row = program_spans.spans(run, "finalize.pin")[0]
    grew = program_spans.snapshot(run)["counters"].get("d2h_pin_new_bytes")
    jobs = len(run.job_ends)
    grew = "not counted" if grew is None else f"{grew / jobs:.0f} B a job"
    print(f"cardbench: finalize_pin_ms: {ms:.6f}: pinned pool growth "
          f"{grew}, longest checkout {row['max_s'] * 1e3:.6f} ms",
          file=sys.stderr, flush=True)
    return ms
