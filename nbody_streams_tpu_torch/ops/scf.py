"""Self-consistent-field (SCF / basis-function-expansion) gravity tier.

Counterpart of ``nbody_streams_tpu/ops/scf.py``: the Hernquist–Ostriker
(1992) expansion.  The particle density is projected onto a biorthogonal
potential–density basis and the smooth truncated field is differentiated:
per step an ``(N, P) x (N, Q)`` coefficient contraction and a basis
evaluation, O(N (nmax+1)(lmax+1)^2), no pair interactions.

Scheme (dimensionless s = r/a, xi = (s-1)/(s+1)):

    phi_nl(s)   = - s^l (1+s)^-(2l+1) C_n^{2l+3/2}(xi)      (HO92 eq. 2.9)
    psi_nlm(x)  = phi_nl(s) B_lm(theta, phi)
    Phi(x)      = -(G/a) sum_nlm [ sum_k m_k psi_nlm(x_k) / K_nl ] psi_nlm(x)
    K_nl        = int_0^inf [ phi_nl'(s)^2 + l(l+1) (phi_nl(s)/s)^2 ] s^2 ds

with ``C_n^alpha`` Gegenbauer polynomials, ``B_lm`` the framework's real
harmonics (Y_00 = 1, the Multipole's ``HarmonicBasis``), and K_nl by
Gauss–Legendre quadrature in xi once at setup.

The two contractions are ``torch.matmul``; on a card they run in IEEE
fp32 even when the caller allows TF32 (``torch.backends.cuda.matmul.
allow_tf32`` or ``set_float32_matmul_precision('high')``): TF32's 10-bit
mantissa would put a ~1e-3 floor under the coefficients that (nmax, lmax)
could not lower, as the JAX package pins ``Precision.HIGHEST`` against
the TPU's bf16 passes.  The force is -grad Phi by autograd with respect to
the evaluation points, the coefficients and the ``center='com'`` offset
held fixed (both computed from detached positions).  The expansion is
global and smooth: no self-interaction, no softening (``softening`` is
accepted and ignored).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .._device import resolve_device
from ..constants import G_DEFAULT
from ..potentials.fit import _symmetry_labels
from ..potentials.multipole import HarmonicBasis

__all__ = ["SCFGravity", "CompositeSCFGravity", "scf_coefficients",
           "scf_potential", "scf_accel"]


# ---------------------------------------------------------------------------
# Host-side setup: radial norms K_nl and label bookkeeping
# ---------------------------------------------------------------------------

def _gegenbauer_np(xi, alpha, nmax):
    """C_n^alpha(xi) for n = 0..nmax, NumPy, shape (nmax+1, ...)."""
    out = [np.ones_like(xi)]
    if nmax >= 1:
        out.append(2.0 * alpha * xi)
    for n in range(2, nmax + 1):
        out.append((2.0 * (n + alpha - 1.0) * xi * out[n - 1]
                    - (n + 2.0 * alpha - 2.0) * out[n - 2]) / n)
    return np.stack(out)


def _radial_norms(nmax, lmax, n_quad=512):
    """K_nl, shape (nmax+1, lmax+1), by Gauss-Legendre in xi (K_00 =
    1/3)."""
    xi, w = np.polynomial.legendre.leggauss(n_quad)
    s = (1.0 + xi) / (1.0 - xi)
    ds = 2.0 / (1.0 - xi) ** 2
    K = np.empty((nmax + 1, lmax + 1))
    for l in range(lmax + 1):
        alpha = 2.0 * l + 1.5
        c = _gegenbauer_np(xi, alpha, nmax)
        # dC_n^a/dxi = 2a C_{n-1}^{a+1}
        dc = np.zeros_like(c)
        if nmax >= 1:
            dc[1:] = 2.0 * alpha * _gegenbauer_np(xi, alpha + 1.0, nmax - 1)
        base = s**l / (1.0 + s) ** (2 * l + 1)
        dbase = base * (l / np.maximum(s, 1e-300)
                        - (2 * l + 1) / (1.0 + s))
        dxi_ds = 2.0 / (1.0 + s) ** 2
        phi = -base * c
        dphi = -(dbase * c + base * dc * dxi_ds)
        integrand = (dphi**2 + l * (l + 1) * (phi / s) ** 2) * s**2
        K[:, l] = (integrand * (w * ds)).sum(axis=1)
    return K


def _l_mask(nmax, lmax, labels):
    """(P, Q) 0/1 mask of the matching-l (radial, angular) pairs."""
    P = (nmax + 1) * (lmax + 1)
    mask = np.zeros((P, len(labels)), np.float32)
    for p in range(P):
        l_p = p // (nmax + 1)
        for q, (l, _) in enumerate(labels):
            if l == l_p:
                mask[p, q] = 1.0
    return mask


@contextlib.contextmanager
def _ieee_fp32():
    """Matmuls in IEEE fp32 inside the block, whatever TF32 setting the
    caller chose; the caller's settings come back on exit.  Both of
    torch's switches are set, and kept consistent (torch refuses a matmul
    under a mix of the legacy and the new setting): the legacy
    ``float32_matmul_precision`` (which ``allow_tf32`` sets) and, where
    torch has it, ``backends.cuda.matmul.fp32_precision``."""
    mm = torch.backends.cuda.matmul
    new = getattr(mm, "fp32_precision", None) is not None
    saved = mm.fp32_precision if new else None
    try:
        prec = torch.get_float32_matmul_precision()
    except RuntimeError:   # the caller set only the new switch
        prec = None
    if prec is not None:
        torch.set_float32_matmul_precision("highest")
    if new:
        mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        if prec is not None:
            torch.set_float32_matmul_precision(prec)
        if new:
            mm.fp32_precision = saved


# ---------------------------------------------------------------------------
# Basis evaluation
# ---------------------------------------------------------------------------

def _gegenbauer(xi, alpha, nmax):
    """C_n^alpha(xi) for n = 0..nmax as a list of tensors."""
    out = [torch.ones_like(xi)]
    if nmax >= 1:
        out.append(2.0 * alpha * xi)
    for n in range(2, nmax + 1):
        out.append((2.0 * (n + alpha - 1.0) * xi * out[n - 1]
                    - (n + 2.0 * alpha - 2.0) * out[n - 2]) / n)
    return out


def _basis_rows(pos, a, nmax, lmax, labels, harm=None):
    """R (N, P) radial factors phi_nl, (n, l) row-major over l, and B
    (N, Q) angular factors B_lm in ``labels`` order.  The tiny floors keep
    r = 0 and the z-axis finite and differentiable (they move the point by
    ~1e-6 a).  ``harm``: a prebuilt ``HarmonicBasis(labels)`` on the
    positions' device."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    tiny = 1e-12 * a * a
    rc2 = x * x + y * y + tiny
    r = torch.sqrt(rc2 + z * z)
    rc = torch.sqrt(rc2)
    if harm is None:
        harm = HarmonicBasis(list(labels)).to(pos.device)
    B = harm(z / r, rc / r, x / rc, y / rc)

    s = r / a
    xi = (s - 1.0) / (s + 1.0)
    inv = 1.0 / (1.0 + s)
    shell = inv                                    # s^l/(1+s)^(2l+1)
    inv2 = inv * inv
    r_cols = []
    for l in range(lmax + 1):
        if l > 0:
            shell = shell * s * inv2
        c = _gegenbauer(xi, 2.0 * l + 1.5, nmax)
        for n in range(nmax + 1):
            r_cols.append(-shell * c[n])
    return torch.stack(r_cols, -1), B


def scf_coefficients(pos, mass, a, nmax, lmax, labels, K_flat, mask,
                     harm=None):
    """A (P, Q) expansion coefficients of the particle set (masked to
    matching l, divided by the radial norms)."""
    with _ieee_fp32():
        R, B = _basis_rows(pos, a, nmax, lmax, labels, harm)
        M = torch.matmul((mass[:, None] * R).T, B)
    return -(M / K_flat[:, None]) * mask


def _phi_of(pos, A, a, G, nmax, lmax, labels, harm=None):
    R, B = _basis_rows(pos, a, nmax, lmax, labels, harm)
    return (G / a) * (torch.matmul(R, A) * B).sum(-1)


def scf_potential(pos_eval, A, a, G, nmax, lmax, labels, harm=None):
    """Phi at pos_eval from coefficients A."""
    with _ieee_fp32(), torch.no_grad():
        return _phi_of(pos_eval, A, a, G, nmax, lmax, labels, harm)


def scf_accel(pos_eval, A, a, G, nmax, lmax, labels, harm=None):
    """-grad Phi at pos_eval with A held fixed (autograd through the
    basis: the exact derivative of the truncated field)."""
    with _ieee_fp32(), torch.enable_grad():
        x = pos_eval.detach().requires_grad_(True)
        phi = _phi_of(x, A.detach(), a, G, nmax, lmax, labels, harm)
        (g,) = torch.autograd.grad(phi.sum(), x)
    return -g


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

class SCFGravity:
    """Self-gravity solver with the run-loop interface of
    :class:`~nbody_streams_tpu_torch.ops.dispatch.DirectGravity`, by the
    Hernquist–Ostriker SCF expansion.

    Parameters
    ----------
    mass : (N,) masses.
    nmax, lmax : radial / angular truncation (the accuracy dials).
    mmax : azimuthal truncation (default lmax).
    a : basis scale radius.  Default: the median particle radius about
        ``center`` in ``phase_space`` (about the mass-weighted centroid
        for ``center='com'``).
    symmetry : 'none' | 'spherical' | 'axisymmetric' | 'triaxial' |
        'bisymmetric' (``potentials.fit._symmetry_labels``).
    center : static (3,) expansion centre, 'com' for the instantaneous
        mass centroid at each evaluation, or None for the origin.
    device : the card unless the caller passes ``device='cpu'`` (without
        a card the default raises).
    """

    def __init__(self, mass, softening=None, *, nmax: int = 8,
                 lmax: int = 4, mmax: int | None = None, a: float | None
                 = None, symmetry: str = "none", center=None,
                 G: float = G_DEFAULT, precision: str = "float32",
                 phase_space=None, device="cuda"):
        if nmax < 0 or lmax < 0:
            raise ValueError("nmax and lmax must be >= 0")
        self.device = resolve_device(device)
        self.impl = "scf"
        self.kernel = "scf"
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        if isinstance(mass, torch.Tensor):
            mass = mass.to(self.device, self.dtype)
        else:
            mass = torch.as_tensor(np.asarray(mass, float), dtype=self.dtype,
                                   device=self.device)
        if mass.ndim == 0:
            raise ValueError("mass must be a per-particle array")
        self.n = int(mass.shape[0])
        self.mass = mass
        self._m_total = mass.sum()
        self.G = float(G)
        self.nmax = int(nmax)
        self.lmax = int(lmax)
        self.labels = tuple(
            _symmetry_labels(self.lmax,
                             self.lmax if mmax is None else int(mmax),
                             symmetry))

        self._follow_com = isinstance(center, str) and center == "com"
        if self._follow_com or center is None:
            center_np = np.zeros(3)
        else:
            center_np = np.asarray(center, float)
        self.center = torch.as_tensor(center_np, dtype=self.dtype,
                                      device=self.device)

        if a is None:
            if phase_space is None:
                raise ValueError(
                    "pass a= (basis scale radius) or phase_space= so "
                    "SCFGravity can pick it from the median radius")
            p = np.asarray(phase_space, float)[:, :3]
            if self._follow_com:
                # about the mass-weighted centroid the expansion follows,
                # not the origin: for an off-centre group the origin's
                # median is its orbital distance (a port deviation; the
                # JAX package's scf.py:306 measures about the origin)
                w = self.mass.detach().cpu().double().numpy()
                p = p - (w[:, None] * p).sum(0) / w.sum()
            else:
                p = p - center_np
            a = float(np.median(np.linalg.norm(p, axis=1)))
            if not np.isfinite(a) or a <= 0:
                raise ValueError(
                    f"auto-picked basis scale a = {a!r} from the particle "
                    "median radius is not usable; pass a= explicitly")
        self.a = float(a)

        K = _radial_norms(self.nmax, self.lmax)
        # flat (P,) in the (l, n) row-major order of _basis_rows
        self._K_flat = torch.as_tensor(K.T.reshape(-1), dtype=self.dtype,
                                       device=self.device)
        self._mask = torch.as_tensor(
            _l_mask(self.nmax, self.lmax, self.labels), dtype=self.dtype,
            device=self.device)
        self._harm = HarmonicBasis(list(self.labels)).to(self.device)
        # terms per particle per pass
        self.terms = (self.nmax + 1) * len(self.labels)

    # -- run-loop interface -------------------------------------------------
    def _offset(self, pos):
        """The frame's origin: the static centre, or the mass centroid of
        ``pos`` (detached: outside the gradient)."""
        if self._follow_com:
            p = pos.detach().to(self.dtype)
            return (self.mass[:, None] * p).sum(0) / self._m_total
        return self.center

    def _frame(self, pos):
        return pos.detach().to(self.dtype) - self._offset(pos)

    def _coefs(self, p):
        return scf_coefficients(p, self.mass, self.a, self.nmax, self.lmax,
                                self.labels, self._K_flat, self._mask,
                                self._harm)

    def accel(self, pos):
        """(N, 3) accelerations of the particles on themselves."""
        p = self._frame(pos)
        return scf_accel(p, self._coefs(p), self.a, self.G, self.nmax,
                         self.lmax, self.labels, self._harm)

    def potential(self, pos):
        """(N,) potential of the particles at the particles."""
        p = self._frame(pos)
        return scf_potential(p, self._coefs(p), self.a, self.G, self.nmax,
                             self.lmax, self.labels, self._harm)

    # -- field evaluation at arbitrary points -------------------------------
    def field(self, pos_src, pos_eval):
        """(phi, acc) of the particle set at arbitrary points."""
        pos_src = self._tensor(pos_src)
        pos_eval = self._tensor(pos_eval)
        off = self._offset(pos_src)
        ps = pos_src - off
        pe = pos_eval - off
        A = self._coefs(ps)
        phi = scf_potential(pe, A, self.a, self.G, self.nmax, self.lmax,
                            self.labels, self._harm)
        acc = scf_accel(pe, A, self.a, self.G, self.nmax, self.lmax,
                        self.labels, self._harm)
        return phi, acc

    def _tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(self.device, self.dtype)
        return torch.as_tensor(np.asarray(x, float), dtype=self.dtype,
                               device=self.device)


class CompositeSCFGravity:
    """Multi-centre SCF: one expansion per particle group, fields summed.

    A single-centre basis converges slowly on clustered geometry (a
    satellite far from the origin needs l ~ r_centre/dr terms); one
    expansion per mass concentration, each with its own centre (typically
    ``center='com'``), scale and truncation, restores the accuracy.

    ``groups``: list of ``(sl, opts)`` where ``sl`` is a slice into the
    particle array and ``opts`` are per-group ``SCFGravity`` keywords;
    the groups must partition the particles.  ``device`` as
    :class:`SCFGravity`.
    """

    def __init__(self, mass, softening=None, *, groups, G: float = G_DEFAULT,
                 precision: str = "float32", phase_space=None,
                 device="cuda", **shared):
        self.device = resolve_device(device)
        self.impl = "scf"
        self.kernel = "scf-composite"
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        mass = torch.as_tensor(np.asarray(mass, float), dtype=self.dtype,
                               device=self.device)
        if mass.ndim == 0:
            raise ValueError("mass must be a per-particle array")
        self.n = int(mass.shape[0])
        self.mass = mass
        self.G = float(G)
        if not groups:
            raise ValueError("groups must be a non-empty list of "
                             "(slice, opts) pairs")
        covered = np.zeros(self.n, bool)
        self._slices = []
        self.solvers = []
        for item in groups:
            sl, opts = item if isinstance(item, tuple) else (item, {})
            idx = np.arange(self.n)[sl]
            if idx.size == 0:
                raise ValueError(f"group slice {sl} selects no particles")
            if covered[idx].any():
                raise ValueError(f"group slice {sl} overlaps another group")
            covered[idx] = True
            merged = dict(shared)
            merged.update(opts)
            ps_g = (None if phase_space is None
                    else np.asarray(phase_space)[sl])
            self._slices.append(sl)
            self.solvers.append(SCFGravity(
                mass[sl], G=G, precision=precision, phase_space=ps_g,
                device=self.device, **merged))
        if not covered.all():
            missing = int((~covered).sum())
            raise ValueError(
                f"{missing} particles belong to no group; groups must "
                "partition the particle array")
        self.terms = sum(s.terms for s in self.solvers)

    def _sum_fields(self, pos, want):
        """Sum each group's truncated field over ALL positions: each
        group's coefficients from its own particles in its frame, and the
        evaluation points moved by the same (detached) offset."""
        pos = pos.detach().to(self.dtype)
        out = None
        for sl, s in zip(self._slices, self.solvers):
            off = s._offset(pos[sl])
            A = s._coefs(pos[sl] - off)
            pe = pos - off
            fn = scf_accel if want == "acc" else scf_potential
            part = fn(pe, A, s.a, s.G, s.nmax, s.lmax, s.labels, s._harm)
            out = part if out is None else out + part
        return out

    def accel(self, pos):
        """(N, 3) accelerations: sum of every group's field at pos."""
        return self._sum_fields(pos, "acc")

    def potential(self, pos):
        """(N,) potential: sum of every group's field at pos."""
        return self._sum_fields(pos, "pot")
