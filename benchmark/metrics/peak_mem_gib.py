"""peak_mem_gib (GiB, device counter): torch.cuda.max_memory_allocated()
over the window, the peak statistics reset at the window's start."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2 ** 30
