"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after ``reset_peak_memory_stats``), GiB."""


def read(run):
    b = run.window.get("peak_bytes")
    return b / 2 ** 30 if b else None
