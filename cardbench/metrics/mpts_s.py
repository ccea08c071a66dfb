"""mpts_s (end to end, host clock): the points of every job completed in
the window over the time from the window's start to the last job's end,
in millions a second. The last job started runs past the window's close
and counts, so the rate covers all the work and all the time it took."""


def read(run):
    if not run.job_ends:
        return None
    n = len(run.job_ends)
    return run.points_per_job * n / (run.job_ends[-1] - run.window_start) / 1e6
