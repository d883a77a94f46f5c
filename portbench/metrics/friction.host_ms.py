"""Host ms a KDK step in the friction term: the program's ``friction.step``
spans inside its chunks, less the host's waits on the device inside them
(``*.sync`` spans, and the CUDA runtime's calls, where a launch blocks
while the launch queue is full), over the window's steps.

Read in a traced run, so the profiler's cost of each of the friction's ops
is in it: up to half of the reading at ``mwlmc_sat.n1m``, whose friction
runs ~21,000 ops a step.  A change that cuts the number of ops cuts that
cost too, and reads better here than its own saving."""
from portbench import spans

MOVES = "field_step_ms"


def read(rec):
    return spans.host_ms(rec, "friction.step")
