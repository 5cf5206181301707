"""The device memory the window's tensors took at their peak
(``torch.cuda.max_memory_allocated`` after a reset at the window's start),
in GiB."""


def read(rec):
    return rec.peak_window_bytes / 2**30 if rec.peak_window_bytes else None
