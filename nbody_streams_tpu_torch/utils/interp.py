"""Piecewise-polynomial evaluation for time-varying modifiers.

Counterpart of ``nbody_streams_tpu/utils/interp.py``.  Spline
*construction* stays SciPy on the host (once, when a potential is built);
*evaluation* is torch on the tables' device.  ``PPoly`` holds the
breakpoints ``x`` and coefficients ``c`` as buffers, so ``.to(device,
dtype)`` moves them with the potential that owns them.

A Python-number time (the integrator's ``t``) selects its interval on the
host, from a float64 copy of the breakpoints: the device sees only the
slice ``c[:, k]`` and the host offset, so no value crosses back to the host
and nothing synchronises.  A tensor time takes the batched path
(``searchsorted`` on the device), as the JAX package does for every call;
a 0-dim one (the friction's CUDA graph passes its time so) reads nothing
back either.
"""
from __future__ import annotations

import bisect

import numpy as np
import torch
from torch import nn

__all__ = ["PPoly", "spline_coeffs", "hermite_coeffs", "pchip_coeffs"]


class PPoly(nn.Module):
    """Piecewise cubic polynomial y(t), clamped or linearly extrapolated.

    Built from a SciPy PPoly (CubicSpline / CubicHermiteSpline): holds
    breakpoints (K+1,) and coefficients (order, K, D).
    """

    def __init__(self, breakpoints, coeffs, extrapolate: str = "clamp"):
        super().__init__()
        if extrapolate not in ("clamp", "linear"):
            raise ValueError(extrapolate)
        c = np.asarray(coeffs, float)
        if c.ndim == 2:
            c = c[:, :, None]
        self.register_buffer("x", torch.as_tensor(
            np.asarray(breakpoints, float)))
        self.register_buffer("c", torch.as_tensor(c))      # (order, K, D)
        self.dim = c.shape[-1]
        self.extrapolate = extrapolate
        self._x_host = np.asarray(breakpoints, float)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._x_host = self.x.detach().cpu().numpy().astype(float)

    @classmethod
    def from_scipy(cls, ppoly, extrapolate: str = "clamp"):
        return cls(ppoly.x, ppoly.c, extrapolate)

    def _host_interval(self, t: float):
        """(k, dt, t - tc) for a host time: the JAX rules (clamp t to the
        breakpoints, interval by searchsorted side='right', clipped)."""
        xh = self._x_host
        tc = min(max(float(t), xh[0]), xh[-1])
        k = min(max(bisect.bisect_right(xh, tc) - 1, 0), len(xh) - 2)
        return k, tc - xh[k], float(t) - tc

    def _horner(self, coef, dt):
        """sum_i coef[i] dt^(order-1-i) for a host dt (coef (order, D))."""
        val = coef[0]
        for i in range(1, coef.shape[0]):
            val = torch.add(coef[i], val, alpha=dt)
        return val

    def _dcoef(self, coef):
        order = coef.shape[0]
        powers = torch.arange(order - 1, 0, -1, dtype=coef.dtype,
                              device=coef.device)
        return coef[:-1] * powers.reshape((-1,) + (1,) * (coef.ndim - 1))

    def _batched(self, t, derivative: bool):
        t = torch.as_tensor(t, dtype=self.c.dtype, device=self.c.device)
        if t.ndim == 0:
            # indexing the tables with a 0-dim index tensor would read it
            # back to the host: take the interval of a one-element batch
            val = self._batched(t.reshape(1), derivative)
            return val.reshape(val.shape[1:])
        tc = torch.clamp(t, self.x[0], self.x[-1])
        k = torch.clamp(torch.searchsorted(self.x, tc, right=True) - 1,
                        0, self.x.shape[0] - 2)
        dtb = (tc - self.x[k])[..., None]
        coef = self.c[:, k, :]                       # (order, ..., D)
        dcoef = self._dcoef(coef)
        der = dcoef[0]
        for i in range(1, dcoef.shape[0]):
            der = der * dtb + dcoef[i]
        if derivative:
            return der
        val = coef[0]
        for i in range(1, coef.shape[0]):
            val = val * dtb + coef[i]
        if self.extrapolate == "linear":
            val = val + der * (t - tc)[..., None]
        return val

    def forward(self, t):
        if isinstance(t, torch.Tensor):
            val = self._batched(t, False)
        else:
            k, dt, beyond = self._host_interval(t)
            coef = self.c[:, k, :]
            val = self._horner(coef, dt)
            if self.extrapolate == "linear" and beyond != 0.0:
                val = torch.add(val, self._horner(self._dcoef(coef), dt),
                                alpha=beyond)
        return val[..., 0] if self.dim == 1 else val

    def derivative_at(self, t):
        if isinstance(t, torch.Tensor):
            der = self._batched(t, True)
        else:
            k, dt, _ = self._host_interval(t)
            der = self._horner(self._dcoef(self.c[:, k, :]), dt)
        return der[..., 0] if self.dim == 1 else der


def spline_coeffs(times, values, extrapolate: str = "clamp") -> PPoly:
    """Not-a-knot cubic spline through (times, values)."""
    from scipy.interpolate import CubicSpline

    times = np.asarray(times, float)
    values = np.asarray(values, float)
    if times.size < 2:
        # constant: degenerate single-interval polynomial
        v = np.atleast_1d(values.reshape(times.size, -1)[0])
        c = np.zeros((4, 1, v.size))
        c[3, 0] = v
        return PPoly(np.array([times[0] - 1.0, times[0] + 1.0]), c,
                     extrapolate)
    bc = "not-a-knot" if times.size > 3 else "natural"
    return PPoly.from_scipy(CubicSpline(times, values, bc_type=bc),
                            extrapolate)


def hermite_coeffs(times, values, derivs,
                   extrapolate: str = "clamp") -> PPoly:
    """Cubic Hermite spline matching values and first derivatives."""
    from scipy.interpolate import CubicHermiteSpline

    times = np.asarray(times, float)
    if times.size < 2:
        # constant fallback, same contract as spline_coeffs (a one-row
        # trajectory table is a fixed offset)
        return spline_coeffs(times, values, extrapolate)
    return PPoly.from_scipy(
        CubicHermiteSpline(times, np.asarray(values, float),
                           np.asarray(derivs, float)),
        extrapolate,
    )


def pchip_coeffs(times, values, extrapolate: str = "clamp") -> PPoly:
    """Monotone (PCHIP) cubic through (times, values) — no ringing.

    The right interpolant for amplitude/scale *schedules* (on/off
    windows, dissolution ramps): a not-a-knot spline through a
    near-step table overshoots by orders of magnitude, while PCHIP
    preserves the data's monotone segments exactly.
    """
    from scipy.interpolate import PchipInterpolator

    times = np.asarray(times, float)
    values = np.asarray(values, float)
    if times.size < 2:
        return spline_coeffs(times, values, extrapolate)
    return PPoly.from_scipy(PchipInterpolator(times, values), extrapolate)
