"""Softening-kernel mathematics as branchless torch functions.

Counterpart of ``nbody_streams_tpu/ops/kernels.py``.  Each *force* kernel
returns the scalar factor ``w(r^2, h)`` such that the acceleration
contribution of source ``j`` on target ``i`` is::

    a_i += G * m_j * w(r_ij^2, h_eff) * (x_j - x_i)

i.e. ``w = 1/r^3`` in the Newtonian far field.  Each *potential* kernel
returns ``u(r^2, h)`` such that ``phi_i += G * m_j * u`` with
``u = -1/r`` in the far field.

====  ===========  ==========================================================
id    name         description
====  ===========  ==========================================================
0     newtonian    unsoftened 1/r^2
1     plummer      (r^2 + h^2)^(-3/2)
2     dehnen_k1    Dehnen (2001) K1 compensated kernel
3     dehnen_k2    Dehnen (2001) K2 kernel
4     spline       Monaghan (1992) cubic spline, compact support (exactly
                   Newtonian for r >= h)
====  ===========  ==========================================================

The functions are dtype-polymorphic (the fp64 oracle and the fp32 plain
versions of the CUDA kernels both use them) and branch-free: ``torch.where``
ladders with denominators guarded before division.
"""
from __future__ import annotations

import torch

from ..constants import KERNEL_IDS, validate_kernel

__all__ = ["force_factor", "potential_factor", "KERNEL_IDS"]


# ---------------------------------------------------------------------------
# Force factors  w(r2, h):  a_i += G m_j w (x_j - x_i)
# ---------------------------------------------------------------------------

def _force_newtonian(r2, h):
    inv_r = torch.rsqrt(r2)
    return inv_r * inv_r * inv_r


def _force_plummer(r2, h):
    inv = torch.rsqrt(r2 + h * h)
    return inv * inv * inv


def _force_dehnen_k1(r2, h):
    h2 = h * h
    inv = torch.rsqrt(r2 + h2)
    inv_d = inv * inv
    inv_d32 = inv_d * inv
    inv_d52 = inv_d32 * inv_d
    return inv_d32 + 1.5 * h2 * inv_d52


def _force_dehnen_k2(r2, h):
    h2 = h * h
    h4 = h2 * h2
    inv = torch.rsqrt(r2 + h2)
    inv_d = inv * inv
    inv_d32 = inv_d * inv
    inv_d52 = inv_d32 * inv_d
    inv_d72 = inv_d52 * inv_d
    return inv_d32 + 1.5 * h2 * inv_d52 + 3.75 * h4 * inv_d72


def _force_spline(r2, h):
    # Monaghan-1992 cubic spline with compact support: Newtonian for r >= h.
    # Division-free: q = r * hinv, and the outer branch's 1/q^3 term folds
    # into the Newtonian factor inv_r^3.
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    newton = inv_r * inv_r * inv_r

    # h == 0 (pure Newtonian particles): hinv is only used when r < h,
    # which cannot happen, so any finite placeholder works
    h_safe = torch.where(h > 0, h, torch.ones_like(h))
    hinv = torch.rsqrt(h_safe * h_safe)
    h3inv = hinv * hinv * hinv
    q = r * hinv
    q2 = q * q

    inner = h3inv * (q2 * (32.0 * q - 38.4) + 10.666666666666666)
    outer = h3inv * (
        21.333333333333333
        + q * (-48.0 + q * (38.4 - 10.666666666666667 * q))
    ) - 0.0666666666666667 * newton
    center = h3inv * 10.666666666666666

    soft = torch.where(q <= 0.5, inner, outer)
    soft = torch.where(q < 1e-8, center, soft)
    return torch.where(r >= h, newton, soft)


_FORCE_FUNCS = {
    "newtonian": _force_newtonian,
    "plummer": _force_plummer,
    "dehnen_k1": _force_dehnen_k1,
    "dehnen_k2": _force_dehnen_k2,
    "spline": _force_spline,
}


def force_factor(kind: str, r2, h):
    """Force softening factor ``w(r2, h)`` for a kernel ``kind``."""
    validate_kernel(kind)
    return _FORCE_FUNCS[kind](r2, h)


# ---------------------------------------------------------------------------
# Potential factors  u(r2, h):  phi_i += G m_j u
# ---------------------------------------------------------------------------

def _guarded_inv_r(r2):
    """1/r with r2 == 0 guarded (the caller selects 0 there)."""
    return torch.rsqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))


def _pot_newtonian(r2, h):
    return torch.where(r2 > 0, -_guarded_inv_r(r2), torch.zeros_like(r2))


def _pot_plummer(r2, h):
    return -torch.rsqrt(r2 + h * h)


def _pot_dehnen_k1(r2, h):
    h2 = h * h
    inv = torch.rsqrt(r2 + h2)
    inv_d32 = inv * inv * inv
    return -inv - 0.5 * h2 * inv_d32


def _pot_dehnen_k2(r2, h):
    h2 = h * h
    h4 = h2 * h2
    inv = torch.rsqrt(r2 + h2)
    inv_d32 = inv * inv * inv
    inv_d52 = inv_d32 * inv * inv
    return -inv - 0.5 * h2 * inv_d32 - 0.375 * h4 * inv_d52


def _pot_spline(r2, h):
    # Division-free: the outer branch's (1/q) * hinv term is inv_r.
    inv_r = _guarded_inv_r(r2)
    r = r2 * inv_r
    newton = torch.where(r > 0, -inv_r, torch.zeros_like(r2))

    h_safe = torch.where(h > 0, h, torch.ones_like(h))
    hinv = torch.rsqrt(h_safe * h_safe)
    q = r * hinv
    q2 = q * q

    # Gadget/Monaghan W2 inner branch with the q^2 (not the CUDA
    # reference's q^4) nesting: -2.8 + q^2 (16/3 + q^2 (6.4 q - 9.6)) is
    # the true antiderivative of the force kernel and continuous at
    # q = 0.5 (docs/reference_deviations.md)
    inner = (-2.8 + q2 * (5.333333333333333 + q2 * (6.4 * q - 9.6))) * hinv
    outer = (
        -3.2
        + q2 * (10.666666666666666
                + q * (-16.0 + q * (9.6 - 2.1333333333333333 * q)))
    ) * hinv + 0.06666666666666667 * inv_r
    center = -2.8 * hinv

    soft = torch.where(q <= 0.5, inner, outer)
    soft = torch.where(q < 1e-8, center, soft)
    return torch.where((h <= 0) | (r >= h), newton, soft)


_POT_FUNCS = {
    "newtonian": _pot_newtonian,
    "plummer": _pot_plummer,
    "dehnen_k1": _pot_dehnen_k1,
    "dehnen_k2": _pot_dehnen_k2,
    "spline": _pot_spline,
}


def potential_factor(kind: str, r2, h):
    """Potential softening factor ``u(r2, h)`` for a kernel ``kind``."""
    validate_kernel(kind)
    return _POT_FUNCS[kind](r2, h)
