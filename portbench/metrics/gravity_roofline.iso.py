"""The gravity kernels' share of their roofline: the least time of the
window's force evaluations (n^2 Newtonian pairs each, 2.836e-13 s a pair
on an H100) over the device time of the kernels named below, in %."""
from portbench import readers

MOVES = "step_ms"
PATTERNS = ("direct_tile_kernel", "band_kernel", "combine_kernel",
            "moment_tile_kernel", "moment_finalise_kernel")


def read(rec):
    return readers.roofline_pct(rec, PATTERNS)
