"""The card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(run):
    return run.window.peak_bytes / 2 ** 30 if run.window.peak_bytes else None
