"""peak_mem_gib (GiB): the most device memory the caching allocator held
for the process during the window (``torch.cuda.max_memory_allocated``,
reset at the window's start), with the index resident."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None
