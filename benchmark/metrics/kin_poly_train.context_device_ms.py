"""Device milliseconds of the AR epoch's profiled context build: the window sampling, TrajARNet's context GRU and open-loop rollout over each env's 100 frames, the smoothing, the ground truth's FK, the envs' reset."""

from harness import readers_ar


def read(run):
    return readers_ar.context_ms(run)
