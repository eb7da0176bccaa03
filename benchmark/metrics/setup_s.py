"""Seconds from the process's start to the window: imports, the kernel build or its reuse, loading, and the warm-up iteration."""

def read(run):
    return run.setup_s
