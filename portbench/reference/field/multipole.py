# Frozen copy of nbody_streams_tpu_torch/potentials/multipole.py, trimmed to
# what the MW+LMC field needs (no file readers or projection): the benchmark's float64 reference of the field.  It
# imports nothing of the program, so a later change there does not move it.
"""Multipole (spherical-harmonic BFE) potential — torch evaluator.

Counterpart of ``nbody_streams_tpu/potentials/multipole.py``.  The host
build is the JAX package's, in NumPy/SciPy: C2 quintic Hermite segments in
x = ln r with node second derivatives from the natural-quintic system
(``_quintic_d2``), the Agama invPhi0 monopole treatment with the
Lambert-W inner/outer power-law fits (``_powerlaw_match``), power-law
asymptotes, and zero-column pruning.  Its tables are registered buffers
under the JAX attribute names (``x_grid``, ``coeffs``, ``f_in``, ``v_in``,
``f_out``, ``v_out``).

Evaluation is batched torch over an (N, 3) tensor, one op over the
harmonic axis where the JAX package loops over (l, m) in Python: the
associated Legendre recurrence runs over l for every m at once
(``legendre_nrm``), cos/sin(m phi) over m (``trig_m_recurrence``), and the
stored harmonics are gathered from those tables.  Forces and Hessians come
from autograd through the evaluator (the interpolant is C2).  The guards
are the JAX package's: ``+1e-30`` on the axis and at the origin, a
``where``-based clamp of ln r to the grid (``clamp`` would pass the whole
gradient at a tie, ``jnp.clip`` half of it), and exponents capped at 60 so
that float32 stays finite at absurd radii.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .base import Potential
from .coefs import MultipoleCoefs

__all__ = ["MultipolePotential"]

MUL0 = 2.0 * math.sqrt(math.pi)        # m = 0 angular multiplier
MUL1 = 2.0 * math.sqrt(2.0 * math.pi)  # m != 0


def trig_m_recurrence(cos_p, sin_p, mmax):
    """(cos(m phi), sin(m phi)), each (N, mmax+1), for m = 0..mmax by the
    angle-addition recurrence; shared by the Multipole angular factors and
    the CylSpline Fourier sum / outer expansion."""
    cos_m, sin_m = [torch.ones_like(cos_p)], [torch.zeros_like(sin_p)]
    for _ in range(mmax):
        c, s = cos_m[-1], sin_m[-1]
        cos_m.append(c * cos_p - s * sin_p)
        sin_m.append(s * cos_p + c * sin_p)
    return torch.stack(cos_m, 1), torch.stack(sin_m, 1)


def _legendre_consts(lmax, mmax):
    """Host constants of the recurrence: COEF_m, per l the a_lm and
    -a_lm b_lm of the upward step (zero where m > l - 2), the selector
    (rows l <= mmax + 1 only) of the two
    closed-form rows (P~_mm at l = m, P~_{m+1,m} at l = m + 1), and
    sqrt(2m+3)."""
    coef = []
    for m in range(mmax + 1):
        pref = math.sqrt((2 * m + 1)
                         / (4.0 * math.pi * math.factorial(2 * m)))
        dfact = 1.0
        for i in range(1, 2 * m, 2):
            dfact *= i
        coef.append(((-1.0) ** m) * pref * dfact)
    a = np.zeros((lmax + 1, mmax + 1))
    b = np.zeros((lmax + 1, mmax + 1))
    for l in range(2, lmax + 1):
        for m in range(0, min(l - 2, mmax) + 1):
            a[l, m] = math.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b[l, m] = math.sqrt((((l - 1.0) ** 2 - m * m)
                                 / (4.0 * (l - 1.0) ** 2 - 1.0)))
    sel = np.zeros((min(lmax, mmax + 1) + 1, 2, mmax + 1))
    for m in range(min(lmax, mmax) + 1):
        sel[m, 0, m] = 1.0
        if m + 1 <= lmax:
            sel[m + 1, 1, m] = 1.0
    e = np.array([math.sqrt(2 * m + 3.0) for m in range(mmax + 1)])
    return dict(coef=np.array(coef), a=a, nab=-a * b, sel=sel, e=e)


def legendre_nrm(cos_t, sin_t, consts):
    """Orthonormalised associated Legendre P~_lm with CS phase, as an
    (N, lmax+1, mmax+1) tensor (zero where m > l), from the constant
    tensors of ``_legendre_consts`` (in the dtype of ``cos_t``):
    P~_mm = COEF_m sin^m(theta),  COEF_m = (-1)^m PREFACT_m (2m-1)!!,
    P~_{m+1,m} = sqrt(2m+3) cos P~_mm, and the upward l-recurrence
      P~_lm = a (cos P~_{l-1,m} - b P~_{l-2,m})
      a = sqrt((4l^2-1)/(l^2-m^2)), b = sqrt(((l-1)^2-m^2)/(4(l-1)^2-1))
    run for every m at once, one fused multiply-add a row:
    P~_lm = (a cos) P~_{l-1,m} + (-a b) P~_{l-2,m}."""
    a, nab = consts["a"], consts["nab"]
    n_m = a.shape[1]
    # sin^m by repeated products (cumprod's backward reads the device to
    # look for zeros: a host sync)
    spow = [torch.ones_like(sin_t)]
    for _ in range(n_m - 1):
        spow.append(spow[-1] * sin_t)
    pmm = consts["coef"] * torch.stack(spow, 1)            # (N, M+1)
    diag = torch.stack([pmm, (consts["e"] * cos_t[:, None]) * pmm], 1)
    # rows l <= mmax + 1: P~_ll and P~_{l, l-1}, zero elsewhere
    dg = (diag[:, None, :, :] * consts["sel"][None]).sum(2)
    dg = dg.unbind(1)
    # a cos for every row at once; unbind's backward is one stack
    acos = (cos_t[:, None, None] * a[None]).unbind(1)
    rows = []
    for l in range(a.shape[0]):
        if l < 2:
            rows.append(dg[l])
            continue
        row = torch.addcmul(rows[l - 2] * nab[l], acos[l], rows[l - 1])
        rows.append(row + dg[l] if l < len(dg) else row)
    return torch.stack(rows, 1)


class HarmonicBasis(nn.Module):
    """The framework's 4-pi-normalised real harmonics Y_lm (Y_00 == 1;
    cos modes m >= 0, sin modes m < 0) for a list of (l, m) labels: the
    Legendre table and the cos / sin tables are built once a call, and
    each label's column is gathered from them.  All constants are
    (non-persistent) buffers, so nothing is copied from the host when a
    call runs on the card."""

    def __init__(self, labels, dtype=torch.float64):
        super().__init__()
        self.lmax = max(l for l, _ in labels)
        self.mmax = max(abs(m) for _, m in labels)
        mm = self.mmax + 1
        for k, v in _legendre_consts(self.lmax, self.mmax).items():
            self.register_buffer("_" + k, torch.as_tensor(v, dtype=dtype),
                                 persistent=False)
        p_idx = [l * mm + abs(m) for l, m in labels]
        t_idx = [abs(m) if m >= 0 else mm + abs(m) for _, m in labels]
        mul = [MUL0 if m == 0 else MUL1 for _, m in labels]
        self.register_buffer("_p_idx", torch.tensor(p_idx),
                             persistent=False)
        self.register_buffer("_t_idx", torch.tensor(t_idx),
                             persistent=False)
        self.register_buffer("_mul", torch.tensor(mul, dtype=dtype),
                             persistent=False)

    def forward(self, cos_t, sin_t, cos_p, sin_p):
        """(N, C) columns Y_lm in label order."""
        like = Potential._like
        consts = {k: like(getattr(self, "_" + k), cos_t)
                  for k in ("coef", "a", "nab", "sel", "e")}
        p = legendre_nrm(cos_t, sin_t, consts)
        cos_m, sin_m = trig_m_recurrence(cos_p, sin_p, self.mmax)
        trig = torch.cat([cos_m, sin_m], 1)
        # index_select, whose backward is an index_add (no host sync)
        cols = torch.index_select(p.reshape(p.shape[0], -1), 1, self._p_idx)
        return (like(self._mul, cos_t) * cols) \
            * torch.index_select(trig, 1, self._t_idx)


def _quintic_d2(x, f, d1):
    """Node second derivatives for the C2 quintic spline through
    (f, d1), from the tridiagonal system enforcing a continuous 4th
    derivative at interior nodes and f'''' = 0 at the ends (the
    'natural quintic'; same construction as Agama constructQuinticSpline).

    x (K,), f/d1 (K, C); returns (K, C).
    """
    from scipy.linalg import solve_banded

    n = x.shape[0]
    hi = 1.0 / np.diff(x)                       # (n-1,)
    hi2 = (hi * hi)[:, None]
    df = f[1:] - f[:-1]

    diag = np.zeros(n)
    diag[1:] += 3.0 * hi
    diag[:-1] += 3.0 * hi
    sup = -hi.copy()                            # A[i, i+1]
    sub = -hi.copy()                            # A[i+1, i]
    rhs = np.zeros_like(f)
    rhs[1:] -= (20.0 * df * hi[:, None] - 12.0 * d1[1:]
                - 8.0 * d1[:-1]) * hi2
    rhs[:-1] += (20.0 * df * hi[:, None] - 12.0 * d1[:-1]
                 - 8.0 * d1[1:]) * hi2

    # natural ends: f'''' = 0
    sup[0] = -2.0 * hi[0]
    rhs[0] = (30.0 * df[0] * hi[0] - 14.0 * d1[1]
              - 16.0 * d1[0]) * hi[0] ** 2
    sub[-1] = -2.0 * hi[-1]
    rhs[-1] = (-30.0 * df[-1] * hi[-1] + 14.0 * d1[-2]
               + 16.0 * d1[-1]) * hi[-1] ** 2

    ab = np.zeros((3, n))
    ab[0, 1:] = sup
    ab[1] = diag
    ab[2, :-1] = sub
    return solve_banded((1, 1), ab, rhs)


def _quintic_hermite_coeffs(x, f, d1, d2):
    """Per-interval quintic coefficients (ascending powers of dt).

    x (K,), f/d1/d2 (K, C): values and first/second derivatives at nodes.
    Returns (K-1, 6, C).
    """
    h = np.diff(x)[:, None]                      # (K-1, 1)
    f0, f1 = f[:-1], f[1:]
    g0, g1 = d1[:-1], d1[1:]
    s0, s1 = d2[:-1], d2[1:]
    a0 = f0
    a1 = g0
    a2 = s0 / 2.0
    A = f1 - (a0 + a1 * h + a2 * h * h)
    B = g1 - (a1 + 2.0 * a2 * h)
    C = s1 - 2.0 * a2
    h2 = h * h
    a3 = (10.0 * A - 4.0 * B * h + 0.5 * C * h2) / (h * h2)
    a4 = (-15.0 * A + 7.0 * B * h - C * h2) / (h2 * h2)
    a5 = (6.0 * A - 3.0 * B * h + 0.5 * C * h2) / (h2 * h2 * h)
    return np.stack([a0, a1, a2, a3, a4, a5], axis=1)  # (K-1, 6, C)


def _powerlaw_match(v, r1, r2, phi1, phi2, dphi1):
    """Fit Phi(r) = U (r/r1)^s + W (r/r1)^v through (phi1, dphi1) at r1
    and phi2 at r2, solving for the exponent s with the Lambert W
    function (Agama's computeExtrapolationCoefs; the non-trivial root is
    on branch k = -1 for A > -1 and k = 0 for A < -1).

    Returns (s, U, W, degenerate); ``degenerate`` means s -> v, where
    the second solution is (r/r1)^v * ln(r/r1) and (U, W) are its
    coefficients: Phi = (W + U ln(r/r1)) (r/r1)^v.
    """
    from scipy.special import lambertw

    lnr = math.log(r2 / r1)
    g1 = r1 * dphi1                       # dPhi/d ln r at r1
    num = g1 - v * phi1
    den = phi1 - phi2 * math.exp(-v * lnr)
    tiny = 100.0 * np.finfo(float).eps
    if (abs(num) <= tiny * max(abs(g1), abs(v * phi1))
            or abs(den) <= tiny * max(abs(phi1), abs(phi2))):
        return None
    a = lnr * num / den
    if not np.isfinite(a) or a >= 0.0:
        return None
    if abs(a + 1.0) < math.sqrt(np.finfo(float).eps):
        s = float(v)
    else:
        branch = -1 if a > -1.0 else 0
        s = v + (a - float(np.real(lambertw(a * math.exp(a),
                                            k=branch)))) / lnr
    if not np.isfinite(s):
        return None
    # near-degenerate: prefer the log solution — it is exact for
    # NFW-family halos, while the two-term pair's U, W blow up like
    # 1/(s - v) and extrapolate poorly
    if abs(s - v) < 0.05:
        return float(v), float(g1 - v * phi1), float(phi1), True
    u = (g1 - v * phi1) / (s - v)
    w = (g1 - s * phi1) / (v - s)
    return float(s), float(u), float(w), False


def _monopole_scaling(r, phi0, dphi0):
    """Agama invPhi0 monopole treatment: the transform
    P(x) = log(invPhi0 - 1/Phi) (near-linear in x = ln r for
    double-power-law potentials) plus two-term inner/outer extrapolation
    coefficients.

    Returns (P, dP/dx, params) or None if ineligible.
    params = (invPhi0, s_in, U_in, W_in, s_out, U_out, W_out,
    outer_log) — outer_log selects the degenerate
    (W + U ln(r/rN)) / r continuation (exact for NFW-like halos).
    """
    # ---- inner: Phi = U (r/r0)^s + W, v = 0 -----------------------------
    fit = _powerlaw_match(0, r[0], r[1], phi0[0], phi0[1], dphi0[0])
    if fit is None or fit[3] or fit[0] == 0.0:
        # degenerate s -> 0 would be a log divergence at the centre;
        # use the constant-density-core form instead (Agama fallback)
        s_in = 2.0
        u_in = 0.5 * r[0] * dphi0[0]
        w_in = phi0[0] - u_in
    else:
        s_in, u_in, w_in = fit[:3]
        # Agama's model selection: if a cubic through the first two
        # nodes predicts dPhi(r2) better than the power law does,
        # adopt the constant-density-core (s = 2) form instead
        r0_, r1_ = r[0], r[1]
        dphi_pl = u_in * s_in * (r1_ / r0_) ** s_in / r1_
        dphi_cub = (r1_ / r0_ * (6.0 * r0_ * (phi0[1] - phi0[0])
                                 / (r1_ - r0_)
                                 - dphi0[0] * (2 * r0_ + r1_))) \
            / (2 * r1_ + r0_)
        if abs(dphi0[1] - dphi_cub) < abs(dphi0[1] - dphi_pl):
            s_in = 2.0
            u_in = 0.5 * r0_ * dphi0[0]
            w_in = phi0[0] - u_in
    inv_phi0 = 1.0 / w_in if (s_in > 0.0 and w_in != 0.0) else 0.0
    if inv_phi0 != 0.0 and np.any(phi0 * inv_phi0 >= 1.0):
        inv_phi0 = 0.0

    # ---- outer: Phi = W (r/rN)^-1 + U (r/rN)^s, v = -1 ------------------
    outer_log = False
    fit = _powerlaw_match(-1, r[-1], r[-2], phi0[-1], phi0[-2], dphi0[-1])
    if fit is None or (fit[0] >= 0.0 and not fit[3]):
        # near-Keplerian: derivative-matched rho ~ r^-4 fallback
        s_out = -2.0
        g1 = r[-1] * dphi0[-1]
        u_out = (g1 + phi0[-1]) / (s_out + 1.0)
        w_out = phi0[-1] - u_out
    else:
        s_out, u_out, w_out, outer_log = fit

    # ---- the transform ---------------------------------------------------
    arg = inv_phi0 - 1.0 / phi0
    if np.any(arg <= 0.0):
        return None
    p = np.log(arg)
    dp = (dphi0 * r / phi0 ** 2) / arg
    if not (np.all(np.isfinite(p)) and np.all(np.isfinite(dp))):
        return None
    return p, dp, (inv_phi0, s_in, u_in, w_in, s_out, u_out, w_out,
                   outer_log)


def _clamp_where(v, lo, hi):
    """Clamp by ``where`` (a tie keeps the whole gradient of the tied
    side's constant: none), as the JAX package clamps."""
    return torch.where(v < lo, lo, torch.where(v > hi, hi, v))


def _radial_plain(xlog, x_grid, coeffs, f_in, v_in, f_out, v_out, x0, x1):
    """Quintic-Hermite radial evaluation with plain power asymptotes.

    ``xlog`` (N,); tables in its dtype.  Shared by
    MultipolePotential._radial and the stacked evolving fast path
    (modifiers.EvolvingPotential).  Returns (values (N, C), raw quintic
    values (N, C), d_in (N, 1), d_out (N, 1)).
    """
    k = torch.clamp(torch.searchsorted(x_grid, xlog.detach(), right=True)
                    - 1, 0, x_grid.shape[0] - 2)
    xc = _clamp_where(xlog, x0, x1)
    dtc = (xc - x_grid[k])[:, None]
    blk = coeffs[k]                                  # (N, 6, C)
    val = blk[:, 5]
    for i in (4, 3, 2, 1, 0):
        val = torch.addcmul(blk[:, i], val, dtc)
    p_quintic = val
    # clamp the extrapolation arguments to their own branch's domain:
    # the untaken branch must stay finite (exp of a large positive
    # argument is inf in float32, and where() gradients turn the
    # untaken-branch inf into NaN)
    d_in = torch.clamp(xlog - x0, max=0.0)[:, None]
    d_out = torch.clamp(xlog - x1, min=0.0)[:, None]
    below = (xlog < x0)[:, None]
    above = (xlog > x1)[:, None]
    val = torch.where(below, f_in * torch.exp(torch.clamp(v_in * d_in,
                                                          max=60.0)), val)
    val = torch.where(above, f_out * torch.exp(torch.clamp(v_out * d_out,
                                                           max=60.0)), val)
    return val, p_quintic, d_in, d_out


class MultipolePotential(Potential):
    """Evaluate an Agama Multipole expansion with torch.

    Parameters
    ----------
    coefs : MultipoleCoefs
    dtype : torch dtype of the stored tables (float64 by default; a run
        moves them with ``.to(device, dtype)``).
    """

    def __init__(self, coefs, dtype=None, monopole_scaling: bool = True):
        super().__init__()
        if not isinstance(coefs, MultipoleCoefs):
            raise TypeError("coefs must be MultipoleCoefs")
        self.coefs = coefs
        self._mono_enabled = bool(monopole_scaling)

        r = np.asarray(coefs.R_grid, float)
        phi = np.asarray(coefs.phi, float)
        if phi.ndim == 1:
            phi = phi[:, None]
        labels = [tuple(p) for p in coefs.lm_labels]

        # Prune (near-)zero harmonics; relative tolerance catches
        # quadrature noise in projected tables.
        tol = 1e-12 * np.abs(phi).max() if phi.size else 0.0
        keep = [i for i in range(phi.shape[1])
                if np.abs(phi[:, i]).max() > tol]
        if not keep:
            keep = [0]
        self.labels = [labels[i] for i in keep]
        phi = phi[:, keep]

        if coefs.dphi_dr is not None:
            dphi_dr = np.asarray(coefs.dphi_dr, float)[:, keep]
        else:
            from scipy.interpolate import CubicSpline

            dphi_dr = CubicSpline(r, phi, axis=0)(r, 1)

        # Radial interpolation in x = ln r
        x = np.log(r)
        f = phi.copy()
        d1 = dphi_dr * r[:, None]                 # df/dx = r dPhi/dr

        # Agama invPhi0 monopole scaling: interpolate
        # P = log(invPhi0 - 1/Phi_00).  Guards: requires a strictly
        # negative, bounded-slope monopole (signed-mass residual tables
        # fall back to the plain per-column treatment).
        self._i_log = -1
        self._mono = None
        if self._mono_enabled and (0, 0) in self.labels:
            i0 = self.labels.index((0, 0))
            slopes = d1[:, i0] / np.where(phi[:, i0] != 0.0,
                                          phi[:, i0], 1.0)
            if np.all(phi[:, i0] < 0.0) and np.all(np.abs(slopes) < 3.0):
                mono = _monopole_scaling(r, phi[:, i0], dphi_dr[:, i0])
                if mono is not None:
                    self._i_log = i0
                    f[:, i0], d1[:, i0] = mono[0], mono[1]
                    self._mono = mono[2]
        d2 = _quintic_d2(x, f, d1)
        coeffs = _quintic_hermite_coeffs(x, f, d1, d2)  # (K-1, 6, C)

        # Power-law asymptotes: Phi_lm = A (r/R_end)^v, matched in value
        # and log-slope; fall back to the theoretical r^l / r^-(l+1)
        # behaviour when the end value is ~0.
        ls = np.array([l for l, _ in self.labels], float)

        colmax = np.abs(f).max(axis=0) + 1e-300

        def _slope(fv, dv, default, lo):
            safe = np.abs(fv) > 1e-300
            v = np.where(safe, dv / np.where(safe, fv, 1.0), default)
            # physical envelope: in vacuum each harmonic is locally
            # A r^l + B r^-(l+1), so the log-slope lies in [-(l+1), l]
            return np.clip(v, lo, ls)

        # a growing-inward continuation is only trusted when the edge
        # value is significant; near-zero edge values continue flat
        lo_in = np.where(np.abs(f[0]) > 1e-2 * colmax, -(ls + 1.0), 0.0)
        v_in = _slope(f[0], d1[0], ls, lo_in)
        v_out = _slope(f[-1], d1[-1], -(ls + 1.0), -(ls + 1.0))
        f_in = f[0].copy()
        f_out = f[-1].copy()
        if self._i_log >= 0:
            # the scaled monopole has its own closed-form extrapolations
            # (see _radial); keep the generic path benign for its column
            v_in[self._i_log] = 0.0
            v_out[self._i_log] = 0.0
            f_in[self._i_log] = 0.0
            f_out[self._i_log] = 0.0

        dt = dtype or torch.float64
        for name, val in (("x_grid", x), ("coeffs", coeffs),
                          ("f_in", f_in), ("v_in", v_in),
                          ("f_out", f_out), ("v_out", v_out)):
            self.register_buffer(name, torch.as_tensor(val, dtype=dt))
        self.x0 = float(x[0])
        self.x1 = float(x[-1])

        self.lmax = max(l for l, _ in self.labels)
        self.mmax = max(abs(m) for _, m in self.labels)
        self.basis = HarmonicBasis(self.labels, dt)
        mono_col = torch.zeros(len(self.labels), dtype=torch.bool)
        if self._i_log >= 0:
            mono_col[self._i_log] = True
        self.register_buffer("_mono_col", mono_col, persistent=False)

    # -- radial part --------------------------------------------------------
    def _radial(self, xlog):
        """All harmonic radial functions Phi_lm: (N, C)."""
        tabs = [self._like(getattr(self, k), xlog) for k in
                ("x_grid", "coeffs", "f_in", "v_in", "f_out", "v_out")]
        val, p_quintic, d_in, d_out = _radial_plain(xlog, *tabs, self.x0,
                                                    self.x1)
        if self._i_log >= 0:
            p_mid = p_quintic[:, self._i_log]  # quintic of scaled monopole
            d_in, d_out = d_in[:, 0], d_out[:, 0]
            # monopole: un-transform Phi = 1/(invPhi0 - e^P) in-grid and
            # use the Agama two-term closed forms beyond the grid
            inv0, s_i, u_i, w_i, s_o, u_o, w_o, olog = self._mono
            phi_mid = 1.0 / (inv0 - torch.exp(p_mid))
            # s_i < 0 diverges inward (Keplerian-like); cap the exponent
            # so float32 stays finite at absurd radii
            phi_in = u_i * torch.exp(torch.clamp(s_i * d_in, max=60.0)) + w_i
            if olog:
                # degenerate s -> -1: (W + U ln(r/rN)) / (r/rN), the
                # exact NFW-like halo continuation
                phi_out = (w_o + u_o * d_out) * torch.exp(-d_out)
            else:
                phi_out = (w_o * torch.exp(-d_out)
                           + u_o * torch.exp(min(s_o, 0.0) * d_out))
            mono = torch.where(xlog < self.x0, phi_in,
                               torch.where(xlog > self.x1, phi_out, phi_mid))
            val = torch.where(self._mono_col, mono[:, None], val)
        return val

    # -- angular part -------------------------------------------------------
    def _angular(self, cos_t, sin_t, cos_p, sin_p):
        """Y factors per stored harmonic, same order as self.labels:
        (N, C)."""
        return self.basis(cos_t, sin_t, cos_p, sin_p)

    @staticmethod
    def _sph(arr):
        """(r, cos_t, sin_t, cos_p, sin_p) with the axis/origin guards."""
        eps = 1e-30
        x, y, z = arr.unbind(1)
        rc2 = x * x + y * y
        r = torch.sqrt(rc2 + z * z + eps)
        rc = torch.sqrt(rc2 + eps)
        return r, z / r, rc / r, x / rc, y / rc

    # -- Potential interface ------------------------------------------------
    def _phi(self, arr, t):
        r, cos_t, sin_t, cos_p, sin_p = self._sph(arr)
        radial = self._radial(torch.log(r))
        ang = self._angular(cos_t, sin_t, cos_p, sin_p)
        return (radial * ang).sum(1)

