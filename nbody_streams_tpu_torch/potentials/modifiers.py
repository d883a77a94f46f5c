"""Potential modifiers: Shifted, Scaled, Evolving (Agama semantics).

Counterpart of ``nbody_streams_tpu/potentials/modifiers.py``.  Time
interpolation is precomputed into piecewise polynomials (``PPoly``) at
build time.  The integrator's ``t`` is a Python float, so the interval of
a trajectory, a schedule or an evolving sequence is selected on the host
(where the JAX package uses ``searchsorted`` or ``lax.switch`` in the
traced step): the device sees only slices of the tables and host scalars,
and nothing reads a device value back.
"""
from __future__ import annotations

import bisect

import numpy as np
import torch
from torch import nn

from ..utils.interp import hermite_coeffs, pchip_coeffs, spline_coeffs
from .base import Potential

__all__ = ["ShiftedPotential", "ScaledPotential", "EvolvingPotential"]


class ShiftedPotential(Potential):
    """Evaluate ``inner`` at ``xyz - center(t)``.

    center: (3,) static (buffer ``static_center``) | (T, 4) rows [t,x,y,z]
    (cubic spline) | (T, 7) rows [t,x,y,z,vx,vy,vz] (cubic Hermite), as
    the submodule ``traj``.  Clamped outside the time range.
    """

    def __init__(self, inner: Potential, center):
        super().__init__()
        self.inner = inner
        arr = np.asarray(center, dtype=float)
        if arr.ndim == 1 and arr.shape == (3,):
            self.register_buffer("static_center", torch.as_tensor(arr))
            self.traj = None
            self.time_dependent = inner.time_dependent
        elif arr.ndim == 2 and arr.shape[1] in (4, 7):
            order = np.argsort(arr[:, 0])
            arr = arr[order]
            if arr.shape[1] >= 7:
                self.traj = hermite_coeffs(arr[:, 0], arr[:, 1:4],
                                           arr[:, 4:7])
            else:
                self.traj = spline_coeffs(arr[:, 0], arr[:, 1:4])
            self.static_center = None
            self.time_dependent = True
        else:
            raise ValueError(
                "center must be (3,), (T,4) [t,xyz] or (T,7) [t,xyz,vxyz]; "
                f"got shape {arr.shape}"
            )

    def center(self, t):
        if self.traj is None:
            return self.static_center
        return self.traj(t)

    def _shift(self, arr, t):
        return arr - self._like(self.center(t), arr)

    def _phi(self, arr, t):
        return self.inner._phi(self._shift(arr, t), t)

    def _force_v(self, arr, t):
        return self.inner._force_v(self._shift(arr, t), t)

    def _hess_v(self, arr, t):
        return self.inner._hess_v(self._shift(arr, t), t)

    def _phi_force_v(self, arr, t):
        return self.inner._phi_force_v(self._shift(arr, t), t)


class ScaledPotential(Potential):
    """Agama 'scale' modifier: Phi'(x, t) = a(t) s(t) Phi(x s(t)) with
    s = 1/scale (force scales as a s^2, hessian as a s^3).

    scale: float | (T,2) rows [t, scale] | (T,3) rows [t, ampl, scale];
    monotone (PCHIP) cubics (``scale_spl``, ``ampl_spl``), clamped
    outside the table range; the factors are 0-dim device tensors.
    """

    def __init__(self, inner: Potential, scale, ampl: float = 1.0):
        super().__init__()
        self.inner = inner
        arr = None if np.isscalar(scale) else np.asarray(scale, float)
        if arr is None or arr.ndim == 0:
            self.scale_spl = None
            self.ampl_spl = None
            self.scale_val = float(scale)
            self.ampl_val = float(ampl)
            self.time_dependent = inner.time_dependent
            return
        if arr.ndim != 2 or arr.shape[1] not in (2, 3):
            raise ValueError(
                "scale must be float, (T,2) [t,scale] or (T,3) "
                f"[t,ampl,scale]; got shape {arr.shape}"
            )
        arr = arr[np.argsort(arr[:, 0])]
        self.scale_spl = pchip_coeffs(arr[:, 0], arr[:, -1],
                                      extrapolate="clamp")
        if arr.shape[1] == 3:
            self.ampl_spl = pchip_coeffs(arr[:, 0], arr[:, 1],
                                         extrapolate="clamp")
            self.ampl_val = None
        else:
            self.ampl_spl = None
            self.ampl_val = float(ampl)
        self.scale_val = None
        self.time_dependent = True

    def _factors(self, t):
        if self.scale_spl is None:
            s = 1.0 / self.scale_val
            a = self.ampl_val
        else:
            s = 1.0 / self.scale_spl(t)
            a = (self.ampl_val if self.ampl_spl is None
                 else self.ampl_spl(t))
        return a, s

    def _phi(self, arr, t):
        a, s = self._factors(t)
        return a * s * self.inner._phi(arr * s, t)

    def _force_v(self, arr, t):
        a, s = self._factors(t)
        return a * s * s * self.inner._force_v(arr * s, t)

    def _hess_v(self, arr, t):
        a, s = self._factors(t)
        return a * s * s * s * self.inner._hess_v(arr * s, t)

    def _phi_force_v(self, arr, t):
        a, s = self._factors(t)
        phi, f = self.inner._phi_force_v(arr * s, t)
        return a * s * phi, a * s * s * f


class EvolvingPotential(Potential):
    """Linear (or nearest) interpolation between snapshot potentials.

    The bracketing interval is chosen on the host from the Python-number
    ``t`` (the JAX package's ``lax.switch`` over per-interval branches),
    so only the two bracketing snapshots run.

    Homogeneous Multipole and CylSpline sequences (the FIRE workflow)
    take the JAX package's *stacked* paths: the per-snapshot tables are
    stacked on a leading time axis (buffers ``stk_*``) and the bracketing
    pair is read from them.  Multipole: the monopole uses the plain
    (non-invPhi0) construction, and both snapshots' radial functions are
    evaluated and lerped (the power-law extrapolation is not linear in its
    exponent).  CylSpline: the bicubic node tensors and outer PowerLaw
    coefficients are lerped, with log scaling and pruning off and a shared
    asinh scale.
    """

    time_dependent = True

    def __init__(self, potentials, times, interpolate: bool = True):
        super().__init__()
        if len(potentials) != len(times):
            raise ValueError(
                f"len(potentials)={len(potentials)} != len(times)="
                f"{len(times)}"
            )
        if len(potentials) < 1:
            raise ValueError("need at least one snapshot potential")
        order = np.argsort(np.asarray(times, float))
        t_sorted = np.asarray(times, float)[order]
        if len(t_sorted) > 1 and (np.diff(t_sorted) <= 0).any():
            # duplicate epochs make the lerp weight 0/0 = NaN and every
            # force silently NaN — reject up front
            dup = t_sorted[:-1][np.diff(t_sorted) <= 0]
            raise ValueError(
                f"snapshot times must be distinct; duplicated: {dup[:5]}")
        self.pots = nn.ModuleList([potentials[i] for i in order])
        self.register_buffer("times", torch.as_tensor(t_sorted))
        self._t_host = t_sorted
        self.interpolate = bool(interpolate)
        self._stacked = None
        self.template = None
        if self.interpolate and len(self.pots) >= 3:
            self._stacked = self._try_stack_multipole()
            if self._stacked is None:
                self._stacked = self._try_stack_cylspline()

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._t_host = self.times.detach().cpu().numpy().astype(float)

    def _stack(self, kind, template, tables):
        self.template = template
        for name, vals in tables.items():
            self.register_buffer("stk_" + name, torch.stack(vals))
        return kind

    def _try_stack_multipole(self):
        """Stack homogeneous Multipole snapshots."""
        from .multipole import MultipolePotential

        if not all(isinstance(p, MultipolePotential) for p in self.pots):
            return None
        g0 = self.pots[0].x_grid.cpu().numpy()
        if not all(tuple(p.x_grid.shape) == g0.shape
                   and np.allclose(p.x_grid.cpu().numpy(), g0)
                   for p in self.pots[1:]):
            return None
        # rebuild with the linear (plain-column) construction
        plain = [MultipolePotential(p.coefs, monopole_scaling=False)
                 for p in self.pots]
        if not all(p.labels == plain[0].labels for p in plain[1:]):
            return None
        return self._stack("multipole", plain[0], {
            k: [getattr(p, k) for p in plain]
            for k in ("coeffs", "f_in", "v_in", "f_out", "v_out")})

    def _try_stack_cylspline(self):
        """Stack homogeneous CylSpline snapshots (FIRE star/gas
        sequences)."""
        from .cylspline import CylSplinePotential

        if not all(isinstance(p, CylSplinePotential) for p in self.pots):
            return None
        c0 = self.pots[0].coefs
        r0 = np.asarray(c0.R_grid)
        z0 = np.asarray(c0.z_grid)
        m0 = [int(m) for m in c0.m_values]
        for p in self.pots[1:]:
            c = p.coefs
            if (np.asarray(c.R_grid).shape != r0.shape
                    or not np.allclose(np.asarray(c.R_grid), r0)
                    or np.asarray(c.z_grid).shape != z0.shape
                    or not np.allclose(np.asarray(c.z_grid), z0)
                    or [int(m) for m in c.m_values] != m0):
                return None
        if len({p.lmax_outer for p in self.pots}) != 1:
            return None
        rscale = self.pots[0].rscale       # shared asinh scale
        plain = [CylSplinePotential(p.coefs, log_scaling=False,
                                    lmax_outer=self.pots[0].lmax_outer,
                                    rscale=rscale, prune=False)
                 for p in self.pots]
        if not all(p.m_vals == plain[0].m_vals
                   and p.outer_labels == plain[0].outer_labels
                   for p in plain[1:]):
            return None
        return self._stack("cylspline", plain[0], {
            "nodes": [p.nodes for p in plain],
            "outer_w": [p.outer_w for p in plain]})

    def _weights(self, t):
        """(interval index, alpha in [0, 1]) on the host, with clamping:
        the JAX rules (clip t, searchsorted side='right', clip)."""
        th = self._t_host
        n = len(th)
        if n == 1:
            return 0, 0.0
        tc = min(max(float(t), th[0]), th[-1])
        i = min(max(bisect.bisect_right(th, tc) - 1, 0), n - 2)
        return i, (tc - th[i]) / (th[i + 1] - th[i])

    def _stacked_phi(self, arr, t):
        i, alpha = self._weights(t)
        tmpl = self.template
        if self._stacked == "cylspline":
            nodes = ((1.0 - alpha) * self.stk_nodes[i]
                     + alpha * self.stk_nodes[i + 1])
            outer_w = ((1.0 - alpha) * self.stk_outer_w[i]
                       + alpha * self.stk_outer_w[i + 1])
            return tmpl._phi(arr, t, nodes=nodes, outer_w=outer_w)
        from .multipole import _radial_plain

        r, cos_t, sin_t, cos_p, sin_p = tmpl._sph(arr)
        xlog = torch.log(r)
        x_grid = self._like(tmpl.x_grid, arr)

        def rad(k):
            tabs = [self._like(getattr(self, "stk_" + name)[k], arr)
                    for name in ("coeffs", "f_in", "v_in", "f_out",
                                 "v_out")]
            return _radial_plain(xlog, x_grid, *tabs, tmpl.x0, tmpl.x1)[0]

        radial = (1.0 - alpha) * rad(i) + alpha * rad(i + 1)
        ang = tmpl._angular(cos_t, sin_t, cos_p, sin_p)
        return (radial * ang).sum(1)

    def _dispatch(self, method, arr, t):
        if len(self.pots) == 1:
            return getattr(self.pots[0], method)(arr, t)
        i, alpha = self._weights(t)
        if not self.interpolate:
            return getattr(self.pots[i + 1 if alpha > 0.5 else i],
                           method)(arr, t)
        return ((1.0 - alpha) * getattr(self.pots[i], method)(arr, t)
                + alpha * getattr(self.pots[i + 1], method)(arr, t))

    def _phi(self, arr, t):
        if self._stacked is not None:
            return self._stacked_phi(arr, t)
        return self._dispatch("_phi", arr, t)

    def _force_v(self, arr, t):
        if self._stacked is not None:
            return Potential._force_v(self, arr, t)
        return self._dispatch("_force_v", arr, t)

    def _hess_v(self, arr, t):
        if self._stacked is not None:
            return Potential._hess_v(self, arr, t)
        return self._dispatch("_hess_v", arr, t)

    def _phi_force_v(self, arr, t):
        if self._stacked is not None:
            return Potential._phi_force_v(self, arr, t)
        return (self._dispatch("_phi", arr, t),
                self._dispatch("_force_v", arr, t))
