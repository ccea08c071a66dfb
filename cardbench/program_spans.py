"""
The port's own spans and counters, for the per-layer metrics that read
them: `pcr_tpu_torch.utils.profiling.snapshot()`, the table the port fills
while a torch profiler records. Besides jobs.py, the one module of the
harness that imports the port.

A run is one process, and its traced window is the only time a profiler
records in it (the warm-up job runs before), so the table's totals are the
window's. A metric of the window's points divides by `points_per_job`
times the jobs completed, a metric a job by the jobs completed. A program
without the table (no `snapshot`) gives None, and so does an untraced run:
the metrics that read it are then left out.
"""

from __future__ import annotations


def snapshot(run):
    """The port's table after a traced run: {"spans": {name: {"s",
    "self_s", "n", "device_s"}}, "counters": {name: int}}; else None."""
    if run.trace is None:
        return None
    from pcr_tpu_torch.utils import profiling
    read = getattr(profiling, "snapshot", None)
    return read() if read is not None else None


def spans(run, *names):
    """The snapshot's rows of the spans `names` that the run recorded, or
    None where it recorded none of them (or there is no snapshot)."""
    snap = snapshot(run)
    if snap is None or not run.job_ends:
        return None
    rows = [snap["spans"][n] for n in names if n in snap["spans"]]
    return rows or None


def ms_per_mpt(run, *names, key: str = "s"):
    """Host milliseconds (`key` "s", or "self_s" for what no nested span
    covers) of the spans `names`, summed, per million points of the
    window's jobs."""
    rows = spans(run, *names)
    if rows is None:
        return None
    mpts = run.points_per_job * len(run.job_ends) / 1e6
    return sum(r[key] for r in rows) * 1e3 / mpts


def ms_per_job(run, name: str):
    """Host milliseconds of the span `name` a job of the window."""
    rows = spans(run, name)
    if rows is None:
        return None
    return rows[0]["s"] * 1e3 / len(run.job_ends)
