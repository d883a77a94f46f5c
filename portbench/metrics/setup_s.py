"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernel library (built or loaded), the initial conditions, the
field's build and the warm-up calls."""


def read(rec):
    return rec["setup_s"]
