"""The traced window's device idle time under the program's
``integrator.*`` spans (``integrator.chunk``'s own time: the KDK updates
between its children), each idle instant put down to the innermost span
open on the host, over the window."""
from portbench import spans

MOVES = "step_ms"


def read(rec):
    return spans.idle_share(rec, "integrator")
