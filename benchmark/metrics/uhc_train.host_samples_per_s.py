"""Samples of all the window's whole training iterations over the time from the window's start to the end of the last one, on the host's clock (the rate the host's dispatch sets)."""

def read(run):
    return run.rate()
