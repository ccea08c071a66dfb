"""gauss_run_skew (device layout, program counter): the port's
`gauss_peak_x_runs` counter (each K2 chunk's longest tile run in live
entries, halo copies included, times its runs that hold a live entry) over
its `gauss_entries`: the entries-weighted mean, over the window's K2
commits, of each chunk's longest run over its mean run. 1 where every run
is as long; one CTA of K2 scans its tile's whole run, so the longest sets
the kernel's length. Says on stderr the K2 entries a job beside it (the
counters sum over chunks, so a chunk's longest run in entries is not
recovered from them)."""

import sys

from .. import program_spans


def read(run):
    snap = program_spans.snapshot(run)
    if snap is None or not run.job_ends:
        return None
    entries = snap["counters"].get("gauss_entries")
    peak_x_runs = snap["counters"].get("gauss_peak_x_runs")
    if not entries or peak_x_runs is None:
        return None
    jobs = len(run.job_ends)
    print(f"cardbench: gauss_run_skew: {peak_x_runs / entries:.3f}: "
          f"{entries / jobs:.0f} K2 entries a job, longest run x runs "
          f"{peak_x_runs / jobs:.0f} a job", file=sys.stderr, flush=True)
    return peak_x_runs / entries
