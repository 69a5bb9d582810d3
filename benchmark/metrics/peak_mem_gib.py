"""``torch.cuda.max_memory_allocated`` over the window (reset as it
starts), in GiB."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
