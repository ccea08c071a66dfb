"""h2d_gbs (transfer, device trace): the bytes the port's uploads hand to
the copy (the harness counts them at `_Arena.put`, the port's one way to
the card) over the device time of the profiler's `Memcpy HtoD` rows, in
GB/s (1e9 B). The rows' own byte counts are not among the fields that
torch's KinetoEvent exposes."""


def read(run):
    t = run.trace
    if t is None or not t.h2d_s or not run.h2d_bytes:
        return None
    return run.h2d_bytes / t.h2d_s / 1e9
