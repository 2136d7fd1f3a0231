"""peak_mem_mb: torch.cuda.max_memory_allocated() over the window, reset
once the warm-up request has been served, in MB (10^6 bytes)."""


def read(run):
    return run.peak_bytes / 1e6 if run.peak_bytes else None
