"""Analytic external potentials (Agama parameter conventions).

Counterpart of ``nbody_streams_tpu/potentials/analytic.py``: the same ten
classes, constructors and formulas, each a batched ``_phi`` over an
(N, 3) tensor; forces, Hessians and densities come from autograd via the
base class.  The axis and origin guards (``+1e-30`` inside square roots)
are kept: ``torch.where`` and ``sqrt`` have the same NaN-gradient traps
as their jnp forms.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import G_DEFAULT
from .base import Potential

__all__ = [
    "NFWPotential",
    "PlummerPotential",
    "HernquistPotential",
    "DehnenPotential",
    "IsochronePotential",
    "MiyamotoNagaiPotential",
    "LogHaloPotential",
    "DiskAnsatzPotential",
    "UniformAcceleration",
    "AnalyticPotential",
    "ANALYTIC_TYPE_MAP",
]

_EPS = 1e-30


def _r2(arr):
    x, y, z = arr.unbind(1)
    return x * x + y * y + z * z


def _r(arr):
    return torch.sqrt(_r2(arr) + _EPS)


class NFWPotential(Potential):
    """Phi = -G M ln(1 + r/rs) / r  (M = 4 pi rho0 rs^3)."""

    def __init__(self, mass: float = 1.0, scaleRadius: float = 1.0,
                 G: float = G_DEFAULT):
        super().__init__()
        self.GM = float(G) * float(mass)
        self.rs = float(scaleRadius)

    def _phi(self, arr, t):
        r = _r(arr)
        return -self.GM * torch.log1p(r / self.rs) / r


class PlummerPotential(Potential):
    """Phi = -G M / sqrt(r^2 + b^2)."""

    def __init__(self, mass: float = 1.0, scaleRadius: float = 1.0,
                 G: float = G_DEFAULT):
        super().__init__()
        self.GM = float(G) * float(mass)
        self.b2 = float(scaleRadius) ** 2

    def _phi(self, arr, t):
        return -self.GM / torch.sqrt(_r2(arr) + self.b2)


class HernquistPotential(Potential):
    """Phi = -G M / (r + a)."""

    def __init__(self, mass: float = 1.0, scaleRadius: float = 1.0,
                 G: float = G_DEFAULT):
        super().__init__()
        self.GM = float(G) * float(mass)
        self.a = float(scaleRadius)

    def _phi(self, arr, t):
        return -self.GM / (_r(arr) + self.a)


class DehnenPotential(Potential):
    """Dehnen (1993) spherical:
    Phi = -(G M / a) (1 - (r/(r+a))^{2-gamma}) / (2-gamma) for gamma != 2,
    Phi = -(G M / a) ln(1 + a/r) for gamma == 2.  gamma in [0, 3).
    """

    def __init__(self, mass: float = 1.0, scaleRadius: float = 1.0,
                 gamma: float = 1.0, G: float = G_DEFAULT):
        super().__init__()
        if not 0.0 <= gamma < 3.0:
            raise ValueError(f"gamma must be in [0, 3), got {gamma}")
        self.GM = float(G) * float(mass)
        self.a = float(scaleRadius)
        self.gamma = float(gamma)

    def _phi(self, arr, t):
        r = _r(arr)
        if abs(self.gamma - 2.0) < 1e-12:
            return -(self.GM / self.a) * torch.log1p(self.a / r)
        u = r / (r + self.a)
        ex = 2.0 - self.gamma
        return -(self.GM / self.a) * (1.0 - u ** ex) / ex


class IsochronePotential(Potential):
    """Phi = -G M / (b + sqrt(r^2 + b^2))."""

    def __init__(self, mass: float = 1.0, scaleRadius: float = 1.0,
                 G: float = G_DEFAULT):
        super().__init__()
        self.GM = float(G) * float(mass)
        self.b = float(scaleRadius)

    def _phi(self, arr, t):
        return -self.GM / (self.b + torch.sqrt(_r2(arr) + self.b * self.b))


class MiyamotoNagaiPotential(Potential):
    """Phi = -G M / sqrt(R^2 + (a + sqrt(z^2 + b^2))^2)."""

    def __init__(self, mass: float = 1.0, scaleRadius: float = 1.0,
                 scaleHeight: float = 0.1, G: float = G_DEFAULT):
        super().__init__()
        self.GM = float(G) * float(mass)
        self.a = float(scaleRadius)
        self.b2 = float(scaleHeight) ** 2

    def _phi(self, arr, t):
        x, y, z = arr.unbind(1)
        ad = self.a + torch.sqrt(z * z + self.b2)
        return -self.GM / torch.sqrt(x * x + y * y + ad * ad)


class LogHaloPotential(Potential):
    """Phi = (v0^2/2) ln(rc^2 + x^2 + y^2/p^2 + z^2/q^2) (triaxial)."""

    def __init__(self, velocity: float = 1.0, coreRadius: float = 0.01,
                 axisRatioY: float = 1.0, axisRatioZ: float = 1.0,
                 scaleRadius: float | None = None, G: float = G_DEFAULT):
        # G accepted (and ignored) for factory uniformity only: the
        # logarithmic halo is parameterised by v0, not GM.  Anything
        # else (e.g. a typo'd kwarg) must raise like the other classes.
        # Agama names the core radius 'scaleRadius' for type=Logarithmic
        super().__init__()
        if scaleRadius is not None:
            coreRadius = scaleRadius
        self.v02 = float(velocity) ** 2
        self.rc2 = float(coreRadius) ** 2
        self.p2 = float(axisRatioY) ** 2
        self.q2 = float(axisRatioZ) ** 2

    def _phi(self, arr, t):
        x, y, z = arr.unbind(1)
        m2 = self.rc2 + x * x + y * y / self.p2 + z * z / self.q2
        return 0.5 * self.v02 * torch.log(m2)


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
            from ..utils.interp import spline_coeffs

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


ANALYTIC_TYPE_MAP = {
    "nfw": NFWPotential,
    "plummer": PlummerPotential,
    "hernquist": HernquistPotential,
    "dehnen": DehnenPotential,
    "dehnensph": DehnenPotential,
    "isochrone": IsochronePotential,
    "miyamotonagai": MiyamotoNagaiPotential,
    "logarithmic": LogHaloPotential,
    "loghalo": LogHaloPotential,
    "diskansatz": DiskAnsatzPotential,
    "uniformacceleration": UniformAcceleration,
}


def AnalyticPotential(type: str, **kwargs):
    """Factory matching Agama constructor syntax:
    ``AnalyticPotential(type='NFW', mass=1e12, scaleRadius=20)``."""
    key = type.lower().replace("_", "").replace(" ", "")
    if key not in ANALYTIC_TYPE_MAP:
        raise ValueError(
            f"Unknown analytic potential type {type!r}; supported: "
            f"{sorted(set(ANALYTIC_TYPE_MAP))}"
        )
    return ANALYTIC_TYPE_MAP[key](**kwargs)
