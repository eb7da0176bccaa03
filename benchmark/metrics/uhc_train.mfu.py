"""The FLOPs one unit's algorithm needs (nets and physics, from shapes) over its time and the float32 peak of 67 TFLOP/s, in percent."""

from harness import readers


def read(run):
    return readers.mfu(run)
