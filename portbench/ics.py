"""Initial conditions from the seed, made on the device in a few large
calls of a ``torch.Generator`` on that device, in float64.

* ``plummer_sphere``: the Aarseth, Henon & Wielen (1974) sampler of an
  isotropic Plummer sphere in equilibrium (radii by the inverse of M(<r),
  speeds by rejection from q^2 (1 - q^2)^(7/2)); a frozen copy of the
  program's ``ic.make_plummer_sphere`` in torch.
* ``jeans_sigma2``: the isotropic Jeans dispersion of one Plummer
  component in the potential of several (Hernquist 1993), tabulated in
  float64 on the host and interpolated per particle, for Gaussian
  velocities.
"""
from __future__ import annotations

import math

import numpy as np
import torch

G = 4.300917270069976e-06   # kpc (km/s)^2 / Msun

# the rejection envelope of q^2 (1 - q^2)^(7/2), whose largest value is
# 0.0920 at q^2 = 2/9
_H_MAX = 0.09375


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number;
    folded into 64 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def _uniform(g, n, device, lo=0.0, hi=1.0):
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return lo + (hi - lo) * u


def isotropic(g, n, device):
    """(n, 3) unit vectors, isotropic."""
    cos_t = _uniform(g, n, device, -1.0, 1.0)
    phi = _uniform(g, n, device, 0.0, 2.0 * math.pi)
    sin_t = torch.sqrt(1.0 - cos_t * cos_t)
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], 1)


def plummer_radii(g, n, a, device):
    """Radii of a Plummer sphere of scale ``a``: M(<r) / M = u."""
    u = _uniform(g, n, device)
    return a / torch.sqrt(u ** (-2.0 / 3.0) - 1.0)


def plummer_speed_fraction(g, n, device):
    """q = v / v_esc of the isotropic Plummer DF, by rejection in bulk."""
    out = torch.empty(n, dtype=torch.float64, device=device)
    filled = 0
    while filled < n:
        m = 2 * (n - filled) + 1024
        q = _uniform(g, m, device)
        y = _uniform(g, m, device, 0.0, _H_MAX)
        q = q[y <= q * q * (1.0 - q * q) ** 3.5][: n - filled]
        out[filled: filled + q.numel()] = q
        filled += q.numel()
    return out


def plummer_sphere(g, n, mass, a, device):
    """(pos, vel) of an equilibrium Plummer sphere, float64 on ``device``,
    centre of mass and net momentum removed."""
    r = plummer_radii(g, n, a, device)
    pos = r[:, None] * isotropic(g, n, device)
    v_esc = torch.sqrt(2.0 * G * mass / torch.sqrt(r * r + a * a))
    vel = (plummer_speed_fraction(g, n, device) * v_esc)[:, None] \
        * isotropic(g, n, device)
    return pos - pos.mean(0), vel - vel.mean(0)


def plummer_density(r, mass, a):
    return 3.0 * mass / (4.0 * math.pi * a ** 3) \
        * (1.0 + (r / a) ** 2) ** -2.5


def enclosed_mass(r, components, point_mass=0.0):
    """M(<r) of Plummer ``components`` [(mass, a), ...] and a central
    point mass."""
    out = np.full_like(np.asarray(r, float), float(point_mass))
    for mass, a in components:
        out = out + mass * r ** 3 / (r * r + a * a) ** 1.5
    return out


def jeans_sigma2(mass, a, components, point_mass=0.0, n_grid=4096):
    """(ln r grid, sigma^2 on it) of the Plummer component (``mass``,
    ``a``) in the potential of ``components`` and ``point_mass``:
    sigma^2(r) = (1 / rho(r)) int_r^inf rho(s) G M(<s) / s^2 ds, by the
    trapezoid rule in ln s from 1e4 a inwards (the tail beyond it is
    below 1e-12 of the value at a)."""
    lnr = np.linspace(math.log(1e-4 * a), math.log(1e4 * a), n_grid)
    r = np.exp(lnr)
    rho = plummer_density(r, mass, a)
    integrand = rho * G * enclosed_mass(r, components, point_mass) / r
    seg = 0.5 * (integrand[1:] + integrand[:-1]) * np.diff(lnr)
    outside = np.concatenate([np.cumsum(seg[::-1])[::-1], [0.0]])
    return lnr, outside / rho


def jeans_velocities(g, r, lnr_grid, sigma2_grid):
    """Gaussian isotropic velocities with the tabulated sigma^2 at each
    radius ``r`` (linear in ln r between grid points)."""
    device = r.device
    x = torch.log(r.clamp(min=math.exp(lnr_grid[0]),
                          max=math.exp(lnr_grid[-1])))
    grid = torch.as_tensor(lnr_grid, device=device)
    s2 = torch.as_tensor(sigma2_grid, device=device)
    k = torch.searchsorted(grid, x).clamp(1, grid.numel() - 1)
    w = (x - grid[k - 1]) / (grid[k] - grid[k - 1])
    sigma = torch.sqrt(s2[k - 1] + w * (s2[k] - s2[k - 1]))
    z = torch.randn(r.numel(), 3, generator=g, device=device,
                    dtype=torch.float64)
    return sigma[:, None] * z
