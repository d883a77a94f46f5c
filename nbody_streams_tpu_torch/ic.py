"""Initial-condition generators.

Equivalent surface to the reference's IC helpers (reference:
run.py:1225-1368): Plummer spheres in virial equilibrium and orbit
placement.  Sampling is fully vectorised NumPy (host-side, one-off cost) —
no per-particle Python loops.
"""
from __future__ import annotations

import numpy as np

from .constants import G_DEFAULT

__all__ = ["make_plummer_sphere", "place_on_orbit", "sample_isotropic"]


def sample_isotropic(rng, n: int) -> np.ndarray:
    """n isotropic unit vectors, shape (n, 3)."""
    cos_t = rng.uniform(-1.0, 1.0, n)
    sin_t = np.sqrt(1.0 - cos_t**2)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    return np.column_stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t])


def _sample_plummer_speed_fraction(rng, n: int) -> np.ndarray:
    """Sample q = v/v_esc from the Plummer DF, f(q) ∝ q^2 (1-q^2)^{7/2}.

    Vectorised rejection sampling (Aarseth, Henon & Wielen 1974 envelope,
    h_max = 0.09375 >= max q^2 (1-q^2)^{7/2}); ~46% acceptance per round.
    """
    h_max = 0.09375
    out = np.empty(n)
    remaining = np.arange(n)
    while remaining.size:
        q = rng.uniform(0.0, 1.0, remaining.size)
        g = rng.uniform(0.0, h_max, remaining.size)
        ok = g <= q**2 * (1.0 - q**2) ** 3.5
        out[remaining[ok]] = q[ok]
        remaining = remaining[~ok]
    return out


def make_plummer_sphere(
    N: int,
    M_total: float = 10_000.0,
    a: float = 0.01,
    seed: int = 42069,
    G: float = G_DEFAULT,
):
    """Equal-mass Plummer sphere in virial equilibrium.

    Radii by inverse-CDF of M(<r) = M r^3/(r^2+a^2)^{3/2}; speeds by
    vectorised rejection sampling of the isotropic Plummer DF; net
    momentum and centre of mass removed.

    Returns
    -------
    phase_space : (N, 6) float64 ndarray  [x, y, z, vx, vy, vz]
    masses : (N,) float64 ndarray (all equal to M_total/N)
    """
    rng = np.random.default_rng(seed)

    u = rng.uniform(0.0, 1.0, N)
    r = a / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * sample_isotropic(rng, N)

    v_esc = np.sqrt(2.0 * G * M_total / np.sqrt(r**2 + a**2))
    v_mag = _sample_plummer_speed_fraction(rng, N) * v_esc
    vel = v_mag[:, None] * sample_isotropic(rng, N)

    pos -= pos.mean(axis=0)
    vel -= vel.mean(axis=0)

    phase_space = np.concatenate([pos, vel], axis=1)
    masses = np.full(N, M_total / N, dtype=np.float64)
    return phase_space, masses


def place_on_orbit(phase_space, r_peri: float, r_apo: float, potential):
    """Shift a self-bound system onto an (r_peri, r_apo) orbit.

    Starts at apocentre on the +x axis with tangential velocity in +y
    (reference convention, run.py:1328-1368).  The apocentre speed is
    the EXACT energy/angular-momentum match in the supplied potential:

        v_apo^2 = 2 (Phi(r_peri) - Phi(r_apo)) / (1 - (r_apo/r_peri)^2)

    The reference instead approximates through the circular speed at
    the geometric-mean radius, ``v_circ sqrt(2 r_circ/r_apo - 1)``,
    whose argument goes NEGATIVE for r_peri < r_apo/4 — NaN velocities
    for the common eccentric-progenitor case (e.g. Sgr-like 15/90).

    ``potential`` must expose ``potential(pos) -> (N,)`` (falls back to
    the reference's circular-speed approximation, clipped at 0, when
    only ``force`` is available).
    """
    if not 0.0 < r_peri <= r_apo:
        raise ValueError(
            f"need 0 < r_peri <= r_apo, got ({r_peri}, {r_apo})")
    if r_peri == r_apo:          # circular orbit
        f = np.asarray(potential.force(np.array([[r_apo, 0.0, 0.0]])))
        v_tang = float(np.sqrt(-r_apo * f[0, 0]))
    elif hasattr(potential, "potential"):
        pts = np.array([[r_peri, 0.0, 0.0], [r_apo, 0.0, 0.0]])
        phi_p, phi_a = np.asarray(potential.potential(pts), float)
        v_tang = float(np.sqrt(2.0 * (phi_p - phi_a)
                               / (1.0 - (r_apo / r_peri) ** 2)))
    else:  # pragma: no cover - force-only objects
        r_circ = float(np.sqrt(r_peri * r_apo))
        f = np.asarray(potential.force(np.array([[r_circ, 0.0, 0.0]])))
        v_circ = float(np.sqrt(-r_circ * f[0, 0]))
        v_tang = v_circ * np.sqrt(
            max(2.0 * r_circ / r_apo - 1.0, 0.0))

    out = np.array(phase_space, dtype=np.float64, copy=True)
    out[:, 0] += r_apo
    out[:, 4] += v_tang
    return out
