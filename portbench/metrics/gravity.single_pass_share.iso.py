"""The sorted path's single-pass evaluations over all its evaluations in
the window, from the program's counter cuda_direct.BRANCHES."""
from portbench import readers

MOVES = "step_ms"


def read(rec):
    return readers.single_pass_share(rec)
