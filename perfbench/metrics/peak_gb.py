"""peak_gb (end to end): the most device memory the process held over the
whole run (torch.cuda.max_memory_reserved: the caching allocator's
reserve, the graph pool included), in GB (10^9 bytes)."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
