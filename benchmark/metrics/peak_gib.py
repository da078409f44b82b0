"""The card's peak of allocated memory over the window
(``torch.cuda.max_memory_allocated()``, reset at the window's start), GiB."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
