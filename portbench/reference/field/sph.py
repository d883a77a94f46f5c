"""Real spherical harmonics in the 4-pi-normalised basis (Y_00 == 1).

Frozen copy of ``_real_sph_harm`` from
``nbody_streams_tpu_torch/potentials/fit.py``, for the GalPot builders."""
from __future__ import annotations

import math

import numpy as np

MUL0 = 2.0 * math.sqrt(math.pi)        # m = 0 angular multiplier
MUL1 = 2.0 * math.sqrt(2.0 * math.pi)  # m != 0


def _real_sph_harm(labels, pos):
    """Y_lm values per particle in the framework's 4-pi-normalised basis
    (Y_00 == 1), shape (n_lm, N)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    r = np.sqrt(x**2 + y**2 + z**2) + 1e-300
    rc = np.sqrt(x**2 + y**2) + 1e-300
    ct = z / r
    st = rc / r
    cp = x / rc
    sp = y / rc
    lmax = max(l for l, _ in labels)
    mmax = max(abs(m) for _, m in labels)

    cos_m = {0: np.ones_like(cp)}
    sin_m = {0: np.zeros_like(sp)}
    for m in range(1, mmax + 1):
        cos_m[m] = cos_m[m - 1] * cp - sin_m[m - 1] * sp
        sin_m[m] = sin_m[m - 1] * cp + cos_m[m - 1] * sp

    p = {}
    for m in range(0, mmax + 1):
        pref = math.sqrt((2 * m + 1)
                         / (4.0 * math.pi * math.factorial(2 * m)))
        dfact = 1.0
        for i in range(1, 2 * m, 2):
            dfact *= i
        pmm = ((-1.0) ** m) * pref * dfact * st**m
        p[(m, m)] = pmm
        if m + 1 <= lmax:
            p[(m + 1, m)] = math.sqrt(2 * m + 3.0) * ct * pmm
        for l in range(m + 2, lmax + 1):
            a = math.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = math.sqrt(((l - 1.0) ** 2 - m * m)
                          / (4.0 * (l - 1.0) ** 2 - 1.0))
            p[(l, m)] = a * (ct * p[(l - 1, m)] - b * p[(l - 2, m)])

    out = np.empty((len(labels), len(x)))
    for i, (l, m) in enumerate(labels):
        am = abs(m)
        mul = MUL0 if m == 0 else MUL1
        trig = cos_m[am] if m >= 0 else sin_m[am]
        out[i] = mul * p[(l, am)] * trig
    return out
