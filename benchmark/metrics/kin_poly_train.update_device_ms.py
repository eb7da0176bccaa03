"""Device milliseconds of the AR epoch's profiled updates: GAE, 10 PPO epochs through the step GRU's re-run, 20 step-BC epochs, the metrics' fetch."""

from harness import readers_ar


def read(run):
    return readers_ar.update_ms(run)
