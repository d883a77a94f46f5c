"""Physical constants and unit conventions.

The framework works in galactic-dynamics units throughout: length in kpc,
velocity in km/s, mass in Msun.  The derived time unit is kpc/(km/s)
~= 0.978 Gyr.  This matches the reference framework's convention
(reference: run.py:80, run.py:97-103).
"""
from __future__ import annotations

from typing import Literal

#: Gravitational constant in (kpc, km/s, Msun) units.
G_DEFAULT: float = 4.300917270069976e-06

#: Unit system description, for user introspection.
NBODY_UNITS = {
    "kpc": 1.0,            # length unit
    "Msun": 1.0,           # mass unit
    "kpc / (km/s)": 1.0,   # time unit (derived)
    "km/s": 1.0,           # velocity unit
    "G": G_DEFAULT,        # gravitational constant in these units
}

#: Tiny additive regularisation folded into every pairwise r^2 so that the
#: self-interaction term (masked out anyway) never divides by zero.
#: Same value as the reference (fields.py:825).
PAIRWISE_EPS2: float = 1e-15

#: The five supported softening kernels, by name and integer id.
#: Ids match the reference's CUDA `kernel_id` switch (cuda_kernels.py:156-165).
KERNEL_IDS = {
    "newtonian": 0,
    "plummer": 1,
    "dehnen_k1": 2,
    "dehnen_k2": 3,
    "spline": 4,
}

KERNEL_NAMES = {v: k for k, v in KERNEL_IDS.items()}

KernelName = Literal["newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline"]

Precision = Literal["float32", "float64", "float32_kahan", "float32_fast"]


def validate_kernel(kernel: str) -> str:
    if kernel not in KERNEL_IDS:
        raise ValueError(
            f"Unknown softening kernel {kernel!r}; expected one of "
            f"{sorted(KERNEL_IDS)}"
        )
    return kernel


def validate_precision(precision: str) -> str:
    if precision not in ("float32", "float64", "float32_kahan",
                         "float32_fast"):
        raise ValueError(
            f"Unknown precision {precision!r}; expected 'float32', "
            "'float64', 'float32_kahan' or 'float32_fast'"
        )
    return precision
