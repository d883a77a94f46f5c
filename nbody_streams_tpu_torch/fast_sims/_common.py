"""Shared fast-sims machinery.

Counterpart of ``nbody_streams_tpu/fast_sims/_common.py``: progenitor
potential builders (King / Plummer / truncated Plummer), moving-progenitor
and perturber potentials, DF acceleration on the progenitor orbit, and a
spherical potential refit from bound particles, on the port's potential
modules.  The builders take ``device=`` and build on the card unless the
caller passes ``device='cpu'``; the wrappers (``moving_potential``,
``dissolving_schedule``) put their tables where the wrapped potential
lives.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..constants import G_DEFAULT
from ..friction import _np, chandrasekhar_accel, compute_sigma_r
from ..potentials import (
    MultipoleCoefs,
    MultipolePotential,
    NFWPotential,
    PlummerPotential,
    ScaledPotential,
    ShiftedPotential,
)
from .orbits import field_on

__all__ = [
    "make_progenitor_potential",
    "sample_progenitor",
    "moving_potential",
    "dissolving_schedule",
    "make_perturber_potential",
    "make_df_accel",
    "spherical_potential_from_particles",
]


def _beside(wrapper, pot):
    """``wrapper`` moved to the device of the potential it wraps."""
    buf = next(pot.buffers(), None) if isinstance(pot, torch.nn.Module) \
        else None
    return wrapper if buf is None else wrapper.to(buf.device)


def make_progenitor_potential(kind: str, mass: float, scaleradius: float,
                              G: float = G_DEFAULT, device="cuda",
                              **kwargs):
    """Progenitor potential by profile kind (reference: _common.py:222),
    on ``device``."""
    device = resolve_device(device)
    key = kind.lower()
    if key == "king":
        from .king import make_king_potential

        return make_king_potential(mass, scaleradius,
                                   W0=kwargs.get("W0", 3.0), G=G,
                                   device=device)
    if key == "plummer":
        return PlummerPotential(mass=mass, scaleRadius=scaleradius,
                                G=G).to(device)
    if key == "plummer_withrcut":
        # truncated Plummer: keep the Plummer interior, Keplerian beyond
        # trunc * scaleradius, built as a spherical Multipole table
        trunc = kwargs.get("trunc", 10.0)
        r_cut = trunc * scaleradius
        pl = PlummerPotential(mass=mass, scaleRadius=scaleradius, G=G)
        r = np.geomspace(scaleradius * 1e-3, r_cut, 80)
        pts = np.column_stack([r, 0 * r, 0 * r])
        phi = _np(pl.potential(pts))
        dphi = -_np(pl.force(pts))[:, 0]
        coefs = MultipoleCoefs(R_grid=r, lm_labels=[(0, 0)],
                               phi=phi[:, None], dphi_dr=dphi[:, None])
        return MultipolePotential(coefs).to(device)
    raise ValueError(
        f"Unknown progenitor kind {kind!r}; expected 'King', 'Plummer' "
        "or 'Plummer_withRcut'"
    )


def sample_progenitor(kind: str, n: int, mass: float, scaleradius: float,
                      seed: int = 0, G: float = G_DEFAULT, **kwargs):
    """(xv (n,6), masses (n,)) sampled from the progenitor profile (numpy,
    the JAX package's random streams)."""
    key = kind.lower()
    if key == "king":
        from .king import sample_king

        return sample_king(n, mass, scaleradius,
                           W0=kwargs.get("W0", 3.0), seed=seed, G=G)
    from ..ic import make_plummer_sphere

    return make_plummer_sphere(n, M_total=mass, a=scaleradius, seed=seed,
                               G=G)


def moving_potential(pot, times, traj):
    """Potential carried along a trajectory (Hermite (T,7) center)."""
    times = np.asarray(times, float)
    traj = np.asarray(traj, float)
    center = np.column_stack([times, traj[:, :3], traj[:, 3:6]])
    return _beside(ShiftedPotential(pot, center), pot)


def dissolving_schedule(pot, t0: float, t1: float, n: int = 32):
    """Linearly dissolve the potential amplitude from 1 at t0 to 0 at t1
    (reference 'dissolving progenitor' scale modifier, spray.py:494)."""
    t = np.linspace(t0, t1, n)
    ampl = np.clip(1.0 - (t - t0) / (t1 - t0), 0.0, 1.0)
    table = np.column_stack([t, ampl, np.ones(n)])
    return _beside(ScaledPotential(pot, table), pot)


def make_perturber_potential(perturber: dict, pot_host, t0: float,
                             t1: float, n_steps: int = 2048,
                             G: float = G_DEFAULT, device="cuda",
                             dtype=None):
    """Moving (optionally time-windowed) subhalo perturber on ``device``;
    its orbit through ``pot_host`` is integrated there in ``dtype``.

    perturber keys: mass, scaleRadius, w_subhalo_impact (6,),
    time_impact; optional time_window (mass-on window centred on
    impact), trunc_nfw (ignored: plain NFW profile used).
    Reference: fast_sims/_common.py:335.
    """
    from .orbits import integrate_orbit

    device = resolve_device(device)
    mass = float(perturber["mass"])
    rs = float(perturber["scaleRadius"])
    w_imp = np.asarray(perturber["w_subhalo_impact"], float)
    t_imp = float(perturber["time_impact"])

    sub = NFWPotential(mass=mass, scaleRadius=rs, G=G).to(device)
    orbit = dict(n_steps=n_steps, dtype=dtype, device=device)

    # trace the subhalo orbit through the host over the full window.
    # t_imp may fall OUTSIDE [t0, t1] (an impact before the run, with
    # the mass window already closed): the two-leg split only applies
    # when it is interior — otherwise one leg covers everything and the
    # naive concatenation would build a non-monotonic time table
    if t_imp <= t0:
        times, traj = integrate_orbit(pot_host, w_imp, t_imp, t1, **orbit)
    elif t_imp >= t1:
        times_b, traj_b = integrate_orbit(pot_host, w_imp, t_imp, t0,
                                          **orbit)
        times = times_b[::-1]
        traj = traj_b[::-1]
    else:
        times_b, traj_b = integrate_orbit(pot_host, w_imp, t_imp, t0,
                                          **orbit)
        times_f, traj_f = integrate_orbit(pot_host, w_imp, t_imp, t1,
                                          **orbit)
        times = np.concatenate([times_b[::-1][:-1], times_f])
        traj = np.concatenate([traj_b[::-1][:-1], traj_f])
    moving = moving_potential(sub, times, traj)

    window = perturber.get("time_window")
    if window is None:
        return moving
    half = 0.5 * float(window)
    ramp = max(1e-3 * window, 1e-6)
    on0, on1 = t_imp - half, t_imp + half
    # the leading row carries the window STATE at the table start: a
    # window that already closed before the run must start (and stay)
    # at 0 even though its turn-off points fall before t0 - 1 and are
    # dropped by the monotonicity guard below
    ts = [t0 - 1.0]
    amps = [1.0 if on0 <= t0 - 1.0 <= on1 else 0.0]
    pts = [(on0 - ramp, 0.0), (on0, 1.0)]
    if on1 < t1:           # turns off inside the run
        pts += [(on1, 1.0), (on1 + ramp, 0.0)]
    # else: mass stays on through the end — no turn-off points at all
    for tt, aa in pts:
        if ts[-1] < tt:
            ts.append(tt)
            amps.append(aa)
    ts.append(max(t1, ts[-1]) + 1.0)
    amps.append(amps[-1])
    table = np.column_stack([ts, amps, np.ones(len(ts))])
    return _beside(ScaledPotential(moving, table), moving)


def make_df_accel(pot_host, mass_sat: float, pot_for_sigma=None,
                  G: float = G_DEFAULT, **df_kwargs):
    """Extra-acceleration callable ``accel(xv, t)`` applying Chandrasekhar
    friction to a single orbiting body (for ``integrate_orbit``'s
    ``extra_accel``), on the device and in the dtype of ``xv``: the host's
    density and the tabulated sigma(r) are moved there at the first call
    (the caller's objects are left as they are)."""
    sigma = compute_sigma_r(pot_host if pot_for_sigma is None
                            else pot_for_sigma, method="jeans")
    placed = {}

    def accel(xv, t):
        key = (xv.device, xv.dtype)
        if key not in placed:
            placed[key] = (field_on(pot_host, xv.device, xv.dtype),
                           sigma.to(xv.device))
        host, sig_fn = placed[key]
        r_com = xv[..., :3]
        v_com = xv[..., 3:]
        r = torch.linalg.norm(r_com, dim=-1)
        rho = host.density(r_com, t=t)
        sig = sig_fn(r)
        return chandrasekhar_accel(r_com, v_com, mass_sat, rho, sig, t,
                                   G=G, **df_kwargs)

    return accel


def spherical_potential_from_particles(pos, mass, center=None,
                                       n_grid: int = 48,
                                       G: float = G_DEFAULT,
                                       device="cuda"):
    """Spherical (l=0) potential refit from particles, on ``device``.

    Shell approximation: Phi(r) = -G [ M(<r)/r + sum_{r_i > r} m_i/r_i ]
    — exact for a spherically-symmetric distribution, O(N log N), in
    numpy on the host; the table becomes a ``MultipolePotential``.
    Used to rebuild the progenitor potential from its bound particles
    (reference refits an Agama Multipole, fast_sims/_common.py:278).
    """
    device = resolve_device(device)
    pos = np.asarray(pos, float)
    mass = np.broadcast_to(np.asarray(mass, float), (pos.shape[0],))
    if center is None:
        center = (pos * mass[:, None]).sum(0) / mass.sum()
    r = np.linalg.norm(pos - center, axis=1)
    order = np.argsort(r)
    r_s = np.maximum(r[order], 1e-12)
    m_s = mass[order]
    m_enc = np.cumsum(m_s)
    # outer term: sum_{j>i} m_j / r_j
    inv_term = np.cumsum((m_s / r_s)[::-1])[::-1]
    outer = np.concatenate([inv_term[1:], [0.0]])

    r_grid = np.geomspace(max(r_s[0], 1e-4 * r_s[-1]), r_s[-1], n_grid)
    idx = np.searchsorted(r_s, r_grid, side="right") - 1
    idx = np.clip(idx, 0, len(r_s) - 1)
    phi = -G * (m_enc[idx] / r_grid + outer[idx])
    dphi = G * m_enc[idx] / r_grid**2
    coefs = MultipoleCoefs(R_grid=r_grid, lm_labels=[(0, 0)],
                           phi=phi[:, None], dphi_dr=dphi[:, None])
    return MultipolePotential(coefs).to(device)
