# Frozen copy of nbody_streams_tpu_torch/potentials/coefs.py, trimmed to the
# container the MW+LMC field's expansions are built into: the benchmark's
# float64 reference of the field.  It imports nothing of the program, so a
# later change there does not move it.
"""The multipole expansion's coefficient container.

Conventions (Agama's): real spherical harmonics with orthonormalised
associated Legendre functions and angular multiplier 2*sqrt(pi) (m=0) /
2*sqrt(2*pi) (m!=0); cos modes m>=0, sin modes m<0; so the l=0,m=0 column
is the spherical average of Phi.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["MultipoleCoefs"]


@dataclass
class MultipoleCoefs:
    """Spherical-harmonic BFE: Phi_lm(r) tables on a radial grid.

    R_grid (nR,), lm_labels [(l, m)], phi (nR, n_lm),
    dphi_dr (nR, n_lm) or None, metadata dict.
    """

    R_grid: np.ndarray
    lm_labels: list
    phi: np.ndarray
    dphi_dr: np.ndarray | None = None
    metadata: dict = field(default_factory=dict)
