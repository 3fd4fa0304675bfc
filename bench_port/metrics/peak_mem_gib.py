"""torch.cuda.max_memory_allocated() over the window, after a reset at its
start, in GiB."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
