# Frozen copy of nbody_streams_tpu_torch/potentials/analytic.py, trimmed to the
# two classes the MW+LMC field builds: the benchmark's float64 reference of
# the field.  It imports nothing of the program, so a later change there
# does not move it.
"""Analytic external potentials (Agama parameter conventions).

The disk ansatz of GalPot and the frame's uniform acceleration, each a
batched ``_phi`` over an (N, 3) tensor; forces, Hessians and densities
come from autograd via the base class.  The axis and origin guards (``+1e-30`` inside square roots)
are kept: ``torch.where`` and ``sqrt`` have the same NaN-gradient traps
as their jnp forms.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .constants import G_DEFAULT
from .base import Potential

__all__ = ["DiskAnsatzPotential", "UniformAcceleration"]

_EPS = 1e-30


def _r2(arr):
    x, y, z = arr.unbind(1)
    return x * x + y * y + z * z


def _r(arr):
    return torch.sqrt(_r2(arr) + _EPS)


class DiskAnsatzPotential(Potential):
    """Separable disk ansatz Phi(r, z) = f(r) H(z) (Kuijken & Dubinski):

    f(r) = 4 pi G Sigma exp(-(r/hr)^(1/n) - hin/r), r = spherical radius;
    H(z): exponential (scaleHeight > 0), isothermal sech^2 (< 0), or
    razor-thin (== 0), matching the GalPot residuals in galpot.py.
    """

    def __init__(self, surfaceDensity: float = 1.0, scaleRadius: float = 1.0,
                 scaleHeight: float = 0.1, innerCutoffRadius: float = 0.0,
                 sersicIndex: float = 1.0, G: float = G_DEFAULT):
        super().__init__()
        self.pref = 4.0 * math.pi * float(G) * float(surfaceDensity)
        self.hr = float(scaleRadius)
        self.hz = float(scaleHeight)
        self.hin = float(innerCutoffRadius)
        self.inv_n = 1.0 / float(sersicIndex)

    def _phi(self, arr, t):
        r = _r(arr)
        f = self.pref * torch.exp(-((r / self.hr) ** self.inv_n)
                                  - self.hin / r)
        # |z| by where: its derivative at z = 0 is +1, as jnp.abs's, so
        # the Hessian on the plane keeps the midplane density (torch.abs
        # would give sign(0) = 0 there)
        z = arr[:, 2]
        az = torch.where(z >= 0, z, -z)
        if abs(self.hz) < 1e-10:
            hval = 0.5 * az
        elif self.hz > 0:
            u = az / self.hz
            hval = 0.5 * self.hz * (torch.exp(-u) - 1.0 + u)
        else:
            b = -self.hz
            u = az / (2.0 * b)
            # H = b ln cosh(z/2b), overflow-safe form
            hval = b * (u - math.log(2.0) + torch.log1p(torch.exp(-2.0 * u)))
        return f * hval


class UniformAcceleration(Potential):
    """Spatially uniform acceleration field: Phi = -(a(t) . x).

    Either constant (``ax, ay, az``; buffer ``a``) or time-dependent via
    ``table`` = (T, 4) rows [t, ax, ay, az] (cubic spline ``_a_of_t`` in t,
    clamped outside the range) — the Agama ``type=UniformAcceleration,
    file=...`` form of the non-inertial MW-frame correction in the MW-LMC
    workflow.
    """

    def __init__(self, ax: float = 0.0, ay: float = 0.0, az: float = 0.0,
                 table=None, file=None):
        super().__init__()
        if file is not None and table is None:
            table = np.loadtxt(file)
        if table is not None:
            arr = np.asarray(table, float)
            if arr.ndim != 2 or arr.shape[1] != 4:
                raise ValueError(
                    f"UniformAcceleration table must be (T, 4) rows "
                    f"[t, ax, ay, az]; got shape {arr.shape}")
            from .interp import spline_coeffs

            order = np.argsort(arr[:, 0])
            self._a_of_t = spline_coeffs(arr[order, 0], arr[order, 1:4])
            self.a = None
            self.time_dependent = True
        else:
            self._a_of_t = None
            self.register_buffer("a", torch.tensor(
                [float(ax), float(ay), float(az)], dtype=torch.float64))

    def accel(self, t):
        return self.a if self._a_of_t is None else self._a_of_t(t)

    def _phi(self, arr, t):
        a = self._like(self.accel(t), arr)
        return -(arr * a).sum(-1)

