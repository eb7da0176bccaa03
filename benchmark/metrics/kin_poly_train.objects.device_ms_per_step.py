"""Device milliseconds per control step, in the profiled rollout stretch, of the activities launched while the innermost of the harness's spans open was that of the movable objects (span physics.objects: the object frames, the object-side contact Jacobian and Delassus block, the contact wrench and the free-body integration)."""

from harness import readers_ar


def read(run):
    return readers_ar.group_ms_per_step(run, "objects")
