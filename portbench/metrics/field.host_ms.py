"""Host ms a KDK step in the external field's ``force``: the program's
``field.force`` spans inside its chunks, less the host's waits on the
device inside them (``*.sync`` spans, and the CUDA runtime's calls, where a
launch blocks while the launch queue is full behind the gravity kernel),
over the window's steps.  Read in a traced run: the profiler's cost of
each of the field's ops is in it."""
from portbench import spans

MOVES = "field_step_ms"


def read(rec):
    return spans.host_ms(rec, "field.force")
