"""CylSpline (azimuthal-harmonic 2-D BFE) potential — torch evaluator.

Counterpart of ``nbody_streams_tpu/potentials/cylspline.py``; the same
pipeline (the Agama CylSpline behaviour):

* coordinates scaled as lR = asinh(R/Rscale), lz = asinh(z/Rscale) with
  Rscale = -Mtot/Phi0 (fallback: mid-grid radius),
* m=0 term log-scaled as log(-Phi_0) when Phi_0 < 0 everywhere; other
  harmonics stored as Phi_m/Phi_0,
* 2-D bicubic Hermite interpolation from per-node (f, f_lR, f_lz,
  f_lRlz) tables (buffer ``nodes``, (n_m, nR, nz, 4)) — node derivatives
  from natural cubic splines in lz and clamped-left splines in lR (natural
  for |m| = 1),
* Fourier sum Phi = sum_m Phi_m(R, z) x {cos(m phi), m >= 0;
  sin(|m| phi), m < 0},
* outside the grid: the vacuum harmonic continuation
  Phi_lm(r) = W_lm (r/r0)^-(l+1) (buffer ``outer_w``), least-squares
  fitted on the host to densely sampled boundary values of the interior
  spline with row weights (r/r_enc)^2.  The samples come from this
  module's own evaluator, on the CPU in float64.

Evaluation is batched: each point gathers its cell's 4 x 4 Hermite block
for every harmonic at once, and the bicubic form is an elementwise
multiply-and-sum (no matmul, so TF32 cannot enter).  Azimuth enters as
(cos, sin), never atan2 (NaN gradient on the axis), and the grid clamp
is ``where``-based, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import Potential
from .coefs import CylSplineCoefs, read_cylspl_coefs
from .multipole import HarmonicBasis, _clamp_where, trig_m_recurrence

__all__ = ["CylSplinePotential"]


def _natural_spline_deriv(x, y, axis=0):
    """First derivatives of a natural cubic spline at the nodes."""
    from scipy.interpolate import CubicSpline

    return CubicSpline(x, y, axis=axis, bc_type="natural")(x, 1)


def _clamped_left_spline_deriv(x, y, axis=0):
    """Spline derivatives with f'(x[0]) = 0 (symmetry at the R axis)."""
    from scipy.interpolate import CubicSpline

    other = y.shape[:axis] + y.shape[axis + 1:]
    cs = CubicSpline(x, y, axis=axis,
                     bc_type=((1, np.zeros(other)), "not-a-knot"))
    return cs(x, 1)


def _hermite_basis(s, h):
    """[h00(s), h10(s) h, h01(s), h11(s) h] as (N, 4)."""
    return torch.stack([(2.0 * s - 3.0) * s * s + 1.0,
                        ((s - 2.0) * s + 1.0) * s * h,
                        (3.0 - 2.0 * s) * s * s,
                        (s - 1.0) * s * s * h], 1)


def _cell_blocks(nodes):
    """Per-cell Hermite blocks from the (n_m, nR, nz, 4) node table:
    (nR-1, nz-1, n_m, 4 [u-basis], 4 [v-basis]).  Index [u, v] is the
    JAX layout: u over (R corner, d/dlR) and v over (z corner, d/dlz),
    each in the order of ``_hermite_basis``."""
    n_m, n_r, n_z, _ = nodes.shape
    # corners (iu + a, iv + b) with the node's (f, fx, fy, fxy) split
    # into (d/dlz, d/dlR): f = (0, 0), fx = (0, 1), fy = (1, 0), fxy = (1, 1)
    t = torch.stack([torch.stack([nodes[:, a:n_r - 1 + a, b:n_z - 1 + b]
                                  for b in (0, 1)], -2)
                     for a in (0, 1)], -3)     # (n_m, R, Z, a, b, 4)
    t = t.reshape(n_m, n_r - 1, n_z - 1, 2, 2, 2, 2)   # a, b, dz, dR
    # -> (R, Z, n_m, a, dR, b, dz)
    t = t.permute(1, 2, 0, 3, 6, 4, 5)
    return t.reshape(n_r - 1, n_z - 1, n_m, 4, 4)


class CylSplinePotential(Potential):
    """Evaluate an Agama CylSpline expansion with torch."""

    def __init__(self, coefs, lmax_outer: int = 8, dtype=None,
                 log_scaling: bool = True, rscale: float | None = None,
                 prune: bool = True):
        super().__init__()
        if not isinstance(coefs, CylSplineCoefs):
            coefs = read_cylspl_coefs(coefs)
        self.coefs = coefs

        r_grid = np.asarray(coefs.R_grid, float)
        z_grid = np.asarray(coefs.z_grid, float)
        m_vals = [int(m) for m in coefs.m_values]
        phi = np.asarray(coefs.phi, float)        # (n_m, nR, nz)

        # prune zero harmonics (disabled for stacked evolving sequences,
        # where all snapshots must share a harmonic list)
        tol = 1e-14 * np.abs(phi).max() if prune else -1.0
        keep = [i for i, m in enumerate(m_vals)
                if m == 0 or np.abs(phi[i]).max() > tol]
        m_vals = [m_vals[i] for i in keep]
        phi = phi[keep]
        if 0 not in m_vals:
            raise ValueError("CylSpline requires the m=0 harmonic")
        i0 = m_vals.index(0)
        phi0 = phi[i0]                             # (nR, nz)

        # Rscale from the monopole mass estimate: Mtot ~ -Phi(Rmax, 0) Rmax
        iz_mid = int(np.argmin(np.abs(z_grid)))
        phi_c = phi0[0, iz_mid]
        mtot_g = -phi0[-1, iz_mid] * r_grid[-1]    # G*Mtot estimate
        if rscale is None:
            if phi_c < 0.0 and mtot_g > 0.0:
                rscale = -mtot_g / phi_c
            else:
                rscale = float(r_grid[len(r_grid) // 2])
        self.rscale = float(rscale)

        lr = np.arcsinh(r_grid / rscale)
        lz = np.arcsinh(z_grid / rscale)

        log_scaling = bool(log_scaling) and bool(np.all(phi0 < 0.0))
        self.log_scaling = log_scaling

        nodes = []
        for i, m in enumerate(m_vals):
            f = phi[i]
            if log_scaling:
                f = np.log(-f) if m == 0 else f / phi0
            fy = _natural_spline_deriv(lz, f, axis=1)
            # the zero-slope axis clamp expresses Phi_m ~ R^|m| symmetry
            # at R = 0 — valid for every harmonic EXCEPT |m| = 1, whose
            # axis derivative is generically nonzero (Phi_1 ~ c(z) R)
            if abs(m) == 1:
                fx = _natural_spline_deriv(lr, f, axis=0)
                fxy = _natural_spline_deriv(lr, fy, axis=0)
            else:
                fx = _clamped_left_spline_deriv(lr, f, axis=0)
                fxy = _clamped_left_spline_deriv(lr, fy, axis=0)
            nodes.append(np.stack([f, fx, fy, fxy], axis=-1))
        node_arr = np.stack(nodes)                 # (n_m, nR, nz, 4)

        dt = dtype or torch.float64
        self.m_vals = m_vals
        self.i0 = i0
        self.mmax = max(abs(m) for m in m_vals)
        self.register_buffer("lr_grid", torch.as_tensor(lr, dtype=dt))
        self.register_buffer("lz_grid", torch.as_tensor(lz, dtype=dt))
        self.register_buffer("nodes", torch.as_tensor(node_arr, dtype=dt))
        # column of each harmonic in the (N, 2 (mmax+1)) cos|sin table;
        # the m = 0 column is masked out of the Fourier sum
        t_idx = [abs(m) if m >= 0 else self.mmax + 1 + abs(m)
                 for m in m_vals]
        self.register_buffer("_t_idx", torch.tensor(t_idx),
                             persistent=False)
        self.register_buffer("_not0", torch.tensor(
            [m != 0 for m in m_vals]), persistent=False)
        # the corner-value entries of a cell's 4 x 4 Hermite block
        corners = torch.zeros(4, 4, dtype=torch.bool)
        corners[::2, ::2] = True
        self.register_buffer("_corners", corners, persistent=False)
        self.r_max = float(r_grid[-1])
        self.z_min = float(z_grid[0])
        self.z_max = float(z_grid[-1])

        # ---- outer harmonic continuation -------------------------------
        self.r_b = min(self.r_max, self.z_max, -self.z_min)
        self.r_enc = math.hypot(self.r_max, max(self.z_max, -self.z_min))
        self.r0_outer = min(self.r_max, max(self.z_max, -self.z_min))
        self._prune = bool(prune)
        self.lmax_outer = int(lmax_outer)
        self._build_outer(lmax_outer, dt)

    # ------------------------------------------------------------------
    def _build_outer(self, lmax: int, dt):
        """PowerLaw outer continuation: least squares on densely sampled
        boundary values of the interior spline, row-weighted by
        (r / r_enc)^2 (Agama's determineAsympt with dense sampling)."""
        from scipy.linalg import lstsq

        shrink = 0.9995
        r_b_eff = self.r_max * shrink
        z_top = self.z_max * shrink
        z_bot = self.z_min * shrink
        r0 = self.r0_outer
        mmax_fit = min(lmax, self.mmax)
        labels = [(l, m) for l in range(lmax + 1) for m in self.m_vals
                  if abs(m) <= min(l, mmax_fit)]

        n_phi_q = max(8, 4 * mmax_fit + 4)
        phis = 2.0 * np.pi * (np.arange(n_phi_q) + 0.5) / n_phi_q
        cp, sp = np.cos(phis), np.sin(phis)
        pts = []
        zq = np.linspace(z_bot, z_top, 64)
        for z in zq:                                 # side wall
            pts.append(np.column_stack([r_b_eff * cp, r_b_eff * sp,
                                        np.full(n_phi_q, z)]))
        rq = np.linspace(0.0, r_b_eff, 96)
        for zcap in (z_top, z_bot):                  # caps
            for R in rq:
                pts.append(np.column_stack([R * cp, R * sp,
                                            np.full(n_phi_q, zcap)]))
        pts = np.concatenate(pts)

        # the interior spline at the samples: this evaluator, CPU float64
        p = torch.as_tensor(pts, dtype=torch.float64)
        rc = torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2 + 1e-30)
        with torch.no_grad():
            vals = self._interior(rc, p[:, 2], p[:, 0] / rc, p[:, 1] / rc,
                                  self.nodes.to(torch.float64)).numpy()

        from .fit import _real_sph_harm

        r = np.linalg.norm(pts, axis=1)
        y = _real_sph_harm(labels, pts)              # (nl, npts)
        ll = np.array([l for l, _ in labels], float)
        design = (y * (r[None, :] / r0) ** (-(ll[:, None] + 1.0))).T
        w_row = (r / self.r_enc) ** 2
        sol = lstsq(design * w_row[:, None], vals * w_row)[0]

        scale = np.abs(vals).max()
        tol = 1e-13 * scale if self._prune else -1.0
        keep = [(k, float(v)) for k, v in zip(labels, sol)
                if abs(v) > tol]
        if not keep:
            keep = [((0, 0), float(np.mean(vals * r / r0)))]
        self.outer_labels = [k for k, _ in keep]
        self.outer_l = np.array([l for l, _ in self.outer_labels])
        self.register_buffer("outer_w", torch.as_tensor(
            np.array([v for _, v in keep]), dtype=dt))
        self.outer_basis = HarmonicBasis(self.outer_labels, dt)
        self.register_buffer("_outer_pow", torch.as_tensor(
            self.outer_l + 1.0, dtype=dt), persistent=False)

    # ------------------------------------------------------------------
    def _interior(self, R, z, cos_p, sin_p, nodes):
        """Interior spline sum at (R, z, azimuth), each (N,); inputs
        clamped to the grid.  ``nodes`` in the dtype of ``R``."""
        lr_grid = self._like(self.lr_grid, R)
        lz_grid = self._like(self.lz_grid, R)
        lr = _clamp_where(torch.asinh(R / self.rscale), lr_grid[0],
                          lr_grid[-1])
        lz = _clamp_where(torch.asinh(z / self.rscale), lz_grid[0],
                          lz_grid[-1])
        n_z = lz_grid.shape[0]
        iu = torch.clamp(torch.searchsorted(lr_grid, lr.detach(),
                                            right=True) - 1,
                         0, lr_grid.shape[0] - 2)
        iv = torch.clamp(torch.searchsorted(lz_grid, lz.detach(),
                                            right=True) - 1, 0, n_z - 2)
        hu = lr_grid[iu + 1] - lr_grid[iu]
        hv = lz_grid[iv + 1] - lz_grid[iv]
        bu = _hermite_basis((lr - lr_grid[iu]) / hu, hu)      # (N, 4)
        bv = _hermite_basis((lz - lz_grid[iv]) / hv, hv)

        cells = _cell_blocks(nodes)                # (R-1, Z-1, n_m, 4, 4)
        blk = cells.reshape(-1, *cells.shape[2:])[iu * (n_z - 1) + iv]
        # the four corner values less the first: the value bases sum to
        # one along each axis, so that corner comes out whole and the
        # products carry only differences.  log|Phi_0| is ~12 over a cell
        # that changes it by ~1e-3, so in float32 the plain form loses
        # the force's digits to cancellation in d/dlR and d/dlz
        base = blk[:, :, 0, 0]                             # (N, n_m)
        blk = blk - base[:, :, None, None] * self._corners
        # bicubic form, an elementwise multiply-and-sum for every harmonic
        row = (bu[:, None, :, None] * blk).sum(2)          # (N, n_m, 4)
        fsc = base + (row * bv[:, None, :]).sum(2)         # (N, n_m)

        fsc0 = fsc[:, self.i0]
        phi0 = -torch.exp(fsc0) if self.log_scaling else fsc0
        if len(self.m_vals) == 1:
            return phi0
        cos_m, sin_m = trig_m_recurrence(cos_p, sin_p, self.mmax)
        trig = torch.index_select(torch.cat([cos_m, sin_m], 1), 1,
                                  self._t_idx)
        phim = fsc * phi0[:, None] if self.log_scaling else fsc
        return phi0 + torch.where(self._not0, phim * trig, 0.0).sum(1)

    # ------------------------------------------------------------------
    def _outer(self, r, cos_t, sin_t, cos_p, sin_p, outer_w):
        r = torch.clamp(r, min=0.5 * self.r_b)
        ratio = self.r0_outer / r
        pw = ratio[:, None] ** self._like(self._outer_pow, r)
        y = self.outer_basis(cos_t, sin_t, cos_p, sin_p)
        return (outer_w * pw * y).sum(1)

    # ------------------------------------------------------------------
    def _phi(self, arr, t, nodes=None, outer_w=None):
        eps = 1e-30
        x, y, z = arr.unbind(1)
        R = torch.sqrt(x * x + y * y + eps)
        cos_p = x / R
        sin_p = y / R
        r = torch.sqrt(R * R + z * z)
        cos_t = z / r
        sin_t = R / r

        nodes = self.nodes if nodes is None else nodes
        outer_w = self.outer_w if outer_w is None else outer_w
        inside = (R <= self.r_max) & (z <= self.z_max) & (z >= self.z_min)
        interior = self._interior(R, z, cos_p, sin_p,
                                  self._like(nodes, arr))
        outer = self._outer(r, cos_t, sin_t, cos_p, sin_p,
                            self._like(outer_w, arr))
        return torch.where(inside, interior, outer)

    @classmethod
    def from_file(cls, path, **kw):
        return cls(read_cylspl_coefs(path), **kw)
