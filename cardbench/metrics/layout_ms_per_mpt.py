"""layout_ms_per_mpt (device layout, the port's CUDA-event timeline):
milliseconds from each chunk's "uploaded" mark to its "end" mark
(pcr_tpu_torch.engine.device_prep.timeline), summed over the traced
window, per million points its jobs ingested."""


def read(run):
    if run.layout_s is None or not run.job_ends:
        return None
    return run.layout_s * 1e3 / (run.points_per_job * len(run.job_ends) / 1e6)
