"""Peak memory the allocator held for tensors over the window (GiB),
``torch.cuda.max_memory_allocated`` after a reset at the window's start."""


def read(run):
    peak = run.counters.get("peak_bytes", 0.0)
    return peak / 2 ** 30 if peak > 0 else None
