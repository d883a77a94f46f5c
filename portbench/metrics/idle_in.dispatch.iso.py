"""The traced window's device idle time under the program's ``dispatch.*``
spans (the slab sort, the gravity call's host side and its branch read),
each idle instant put down to the innermost span open on the host, over
the window."""
from portbench import spans

MOVES = "step_ms"


def read(rec):
    return spans.idle_share(rec, "dispatch")
