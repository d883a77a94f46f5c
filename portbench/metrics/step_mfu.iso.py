"""The whole step's share of the card's FP32 peak: the window's force
evaluations' operations (n^2 x 19 each) over 67 TFLOP/s times the traced
window, in %."""
from portbench import readers

MOVES = "step_ms"


def read(rec):
    return readers.step_mfu_pct(rec)
