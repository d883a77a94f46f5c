"""The device's idle share over the traced window: 1 minus the union of
kernel, copy and fill intervals in the profiler's trace over the window."""
from portbench import readers

MOVES = "field_step_ms"


def read(rec):
    return readers.idle_share(rec)
