"""Chandrasekhar dynamical friction on a satellite's centre, float64.

The term the program applies (BT2008 eq. 8.13 with a variable Coulomb
logarithm), written out from its physics and its documented choices:

* the centre: a fixed-iteration shrinking sphere (start from the centre of
  mass and the largest distance from it, halve the aperture 5 times,
  recentring on the enclosed mass each time; the velocity is the mean of
  the particles inside the last aperture), refreshed every
  ``update_interval`` steps;
* between refreshes the centre is predicted kinematically from the last
  one: r += v dt + a_df dt^2 / 2, v += a_df dt;
* a_df = -4 pi G^2 M rho ln(Lambda) [erf(X) - 2X/sqrt(pi) exp(-X^2)] / v^2
  v_hat, X = v / (sqrt(2) sigma(r)), ln(Lambda) = ln max(r v^2 / (G M),
  1.1), with rho the field's density at the centre and sigma(r) its
  isotropic Jeans dispersion along the x axis at the run's mid time,
  a clamped cubic spline of ln sigma in ln r;
* it acts on the particles within twice the sphere's last aperture.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .field.interp import spline_coeffs


def shrinking_sphere(pos, vel, mass, n_iter=5, frac=0.5):
    """(r_com, v_com, r_sphere), float64."""
    com = (pos * mass[:, None]).sum(0) / mass.sum()
    r = torch.linalg.norm(pos - com, dim=1).max()
    for _ in range(n_iter):
        r_new = r * frac
        inside = torch.linalg.norm(pos - com, dim=1) <= r_new
        w = mass * inside
        if w.sum() > 0:
            com = (pos * w[:, None]).sum(0) / w.sum()
            r = r_new
    w = mass * (torch.linalg.norm(pos - com, dim=1) <= r)
    return com, (vel * w[:, None]).sum(0) / w.sum(), r


def jeans_sigma(field, t, G, grid=None):
    """sigma(r) of ``field`` at time ``t``: (1/rho) int_r^inf rho |g_r| dr
    on a log grid along the x axis (trapezoid in ln r), as a callable."""
    r = np.geomspace(1e-2, 2e3, 200) if grid is None else np.asarray(grid)
    pts = torch.as_tensor(np.column_stack([r, 0 * r, 0 * r]),
                          dtype=torch.float64)
    pts = pts.to(next(field.buffers()).device)
    rho = np.maximum(field.density(pts, t).cpu().numpy(), 1e-300)
    g_r = np.abs(field.force(pts, t)[:, 0].cpu().numpy())
    lnr = np.log(r)
    f = rho * g_r * r
    seg = 0.5 * (f[1:] + f[:-1]) * np.diff(lnr)
    outside = np.concatenate([np.cumsum(seg[::-1])[::-1], [0.0]])
    ln_sig = np.log(np.sqrt(np.maximum(outside / rho, 1e-12)))
    spline = spline_coeffs(lnr, ln_sig, extrapolate="clamp")

    def sigma(rq):
        x = torch.log(torch.clamp_min(torch.as_tensor(rq, dtype=torch.float64
                                                      ).reshape(1), 1e-10))
        return float(torch.exp(spline(x))[0])

    return sigma


def chandrasekhar(r_com, v_com, M, rho, sigma, G):
    """The (3,) friction acceleration at the centre."""
    r = float(torch.linalg.norm(r_com))
    v = float(torch.linalg.norm(v_com))
    if r <= 1e-6 or v <= 1e-6:
        return torch.zeros_like(v_com)
    x = v / (math.sqrt(2.0) * max(sigma, 1e-6))
    ln_lambda = math.log(max(r / (G * M / v ** 2 + 1e-9), 1.1))
    bracket = math.erf(x) - 2.0 / math.sqrt(math.pi) * x * math.exp(-x * x)
    a_mag = 4.0 * math.pi * G * G * M * rho * ln_lambda * bracket / v ** 2
    return -v_com / v * a_mag


class Friction:
    """The term through one KDK step from a refresh: ``at_refresh`` at the
    step's start, ``predicted`` at its end."""

    def __init__(self, field, M_sat, G, t_mid, apply_radius_factor=2.0):
        self.field = field
        self.M = float(M_sat)
        self.G = float(G)
        self.sigma = jeans_sigma(field, t_mid, G)
        self.factor = float(apply_radius_factor)

    def _accel(self, r_com, v_com, t):
        rho = float(self.field.density(r_com[None, :], t)[0])
        sig = self.sigma(float(torch.linalg.norm(r_com)))
        return chandrasekhar(r_com, v_com, self.M, rho, sig, self.G)

    def at_refresh(self, pos, vel, mass, t, v_com=None):
        """The centre (from every particle) and a_df at a refresh; a given
        ``v_com`` stands for the centre's velocity."""
        r_com, v_mean, r_sph = shrinking_sphere(pos, vel, mass)
        v_com = v_mean if v_com is None else v_com
        return {"r_com": r_com, "v_com": v_com, "r_sphere": r_sph,
                "a_df": self._accel(r_com, v_com, t), "t": t}

    def predicted(self, state, t):
        """The predictor's centre and a_df at ``t``."""
        dt = t - state["t"]
        a = state["a_df"]
        r_com = state["r_com"] + state["v_com"] * dt + 0.5 * a * dt * dt
        v_com = state["v_com"] + a * dt
        return {"r_com": r_com, "v_com": v_com,
                "r_sphere": state["r_sphere"],
                "a_df": self._accel(r_com, v_com, t), "t": t}

    def on(self, state, pos):
        """(S, 3) friction at particles ``pos`` and the distance of each
        from the edge of the applied sphere over its radius."""
        cut = self.factor * state["r_sphere"]
        d = torch.linalg.norm(pos - state["r_com"], dim=1)
        acc = torch.where((d <= cut)[:, None], state["a_df"][None, :],
                          torch.zeros_like(pos))
        return acc, (d - cut).abs() / cut
