"""splat_roofline (kernels, device trace): the least time the card needs
for the window's accumulates (peaks.least_time of the glyph's work count,
recounted from the points, times the jobs) over the device time of every
kernel launched inside a TorchEngine.commit span, in percent."""


def read(run):
    t = run.trace
    if (t is None or run.least_time_per_job_s is None
            or not t.commit_kernel_s or not run.job_ends):
        return None
    return (100.0 * run.least_time_per_job_s * len(run.job_ends)
            / t.commit_kernel_s)
