"""Host reads that wait for the device a KDK step: the program's ``*.sync``
spans inside its ``integrator.chunk`` spans, over the window's steps."""
from portbench import spans

MOVES = "field_step_ms"


def read(rec):
    return spans.syncs_per_step(rec)
