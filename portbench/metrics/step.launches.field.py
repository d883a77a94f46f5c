"""Device kernels a KDK step: the kernels in the traced window over its
steps (the call's start and end included)."""
from portbench import readers

MOVES = "field_step_ms"


def read(rec):
    return readers.launches_per_step(rec)
