"""peak_dev_gib (device, the allocator's counter): torch.cuda's
max_memory_allocated over the window (its peak is reset at the window's
start), in GiB."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2 ** 30
