"""The traced window's device idle time under the program's ``entry.*``
spans (the call's start, the boundaries' fetches and restart writes),
each idle instant put down to the innermost span open on the host, over
the window."""
from portbench import spans

MOVES = "field_step_ms"


def read(rec):
    return spans.idle_share(rec, "entry")
