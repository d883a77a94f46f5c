"""The window's wall time over its KDK steps, in ms a step: one
``run_simulation`` call, its start and its end included."""


def read(rec):
    return rec["window_s"] * 1e3 / rec["steps"]
