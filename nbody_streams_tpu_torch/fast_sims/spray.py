"""Particle-spray stellar-stream generation.

Counterpart of ``nbody_streams_tpu/fast_sims/spray.py`` (the reference's
fast_sims/spray.py without Agama).  Pipeline, with every orbit
integration on the card (``device``) in the working dtype:

1. rewind the progenitor from its present-day phase space (DP5(4)),
2. attach a moving (optionally dissolving) progenitor potential to the
   rewound trajectory,
3. release particle pairs (leading/trailing Lagrange points) at the
   tidal radius along the orbit — Chen+2025 correlated 6-D offsets or
   Fardal+2015 offsets, from the JAX package's numpy random streams,
4. propagate the whole ensemble in one masked loop with per-particle
   release times.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .._device import resolve_device
from ..constants import G_DEFAULT
from ..friction import _np
from ._common import (
    dissolving_schedule,
    make_perturber_potential,
    make_progenitor_potential,
    moving_potential,
)
from .orbits import (
    field_on,
    integrate_orbit_adaptive,
    integrate_orbits_released,
)

__all__ = [
    "create_particle_spray_stream",
    "create_ic_particle_spray_chen2025",
    "create_ic_particle_spray_fardal2015",
    "get_jacobi_radius",
]


def _neg_hessian(pot_host, pos, t, dtype):
    """-Hessian (Agama's 6-vector, forceDeriv's convention) of
    ``pot_host`` at ``pos`` (numpy (n, 3)) at time ``t`` (scalar, or one
    per row), evaluated where the potential lives in ``dtype``.

    Per-row times are grouped by value, one batched ``forceDeriv`` a
    group; a field that does not depend on time (``time_dependent`` False)
    takes one batched call, which is exact there."""
    buf = (next(pot_host.buffers(), None)
           if isinstance(pot_host, torch.nn.Module) else None)

    def der2(rows, tt):
        p = pos[rows]
        if buf is not None:
            p = torch.as_tensor(p, dtype=dtype, device=buf.device)
        return _np(pot_host.forceDeriv(p, t=float(tt))[1])

    every = slice(None)
    if np.ndim(t) == 0:
        return der2(every, t)
    t = np.asarray(t, float)
    if not getattr(pot_host, "time_dependent", True):
        return der2(every, t[0])
    out = np.empty((len(pos), 6))
    for tt in np.unique(t):
        rows = t == tt
        out[rows] = der2(rows, tt)
    return out


def get_jacobi_radius(pot_host, orbit_sat, mass_sat, G: float = G_DEFAULT,
                      t=0.0, eigenvalue_method: bool = True, dtype=None):
    """(r_jacobi, v_jacobi, R rotation matrices) along a satellite orbit.

    Tidal-tensor eigenvalue method (reference: spray.py:38-125):
    r_J = (G M / (lambda_max + Omega^2))^{1/3}; rotation rows are the
    radial / azimuthal / angular-momentum unit vectors.  ``t`` is a
    scalar or one time per orbit point (an evolving host); the Hessians
    are evaluated where ``pot_host`` lives, in ``dtype`` (default
    ``torch.get_default_dtype()``), and the rest in float64 numpy.
    """
    orbit_sat = np.asarray(orbit_sat, float)
    pos, vel = orbit_sat[:, :3], orbit_sat[:, 3:6]
    n = len(orbit_sat)

    r = np.linalg.norm(pos, axis=1)
    ang = np.cross(pos, vel)
    ang_mag = np.linalg.norm(ang, axis=1)
    omega_sq = (ang_mag / (r**2 + 1e-50)) ** 2

    der2 = _neg_hessian(pot_host, pos, t,
                        dtype or torch.get_default_dtype())

    if eigenvalue_method:
        tt = np.zeros((n, 3, 3))
        tt[:, 0, 0] = der2[:, 0]
        tt[:, 1, 1] = der2[:, 1]
        tt[:, 2, 2] = der2[:, 2]
        tt[:, 0, 1] = tt[:, 1, 0] = der2[:, 3]
        tt[:, 1, 2] = tt[:, 2, 1] = der2[:, 4]
        tt[:, 0, 2] = tt[:, 2, 0] = der2[:, 5]
        lam = np.linalg.eigvalsh(tt)[:, -1]
        denom = lam + omega_sq
    else:
        x, y, z = pos.T
        d2 = -(x**2 * der2[:, 0] + y**2 * der2[:, 1] + z**2 * der2[:, 2]
               + 2 * x * y * der2[:, 3] + 2 * y * z * der2[:, 4]
               + 2 * z * x * der2[:, 5]) / (r**2 + 1e-50)
        denom = omega_sq - d2

    r_j = (G * mass_sat / np.abs(denom)) ** (1.0 / 3.0)
    v_j = np.sqrt(omega_sq) * r_j

    rot = np.zeros((n, 3, 3))
    e_r = pos / (r[:, None] + 1e-50)
    e_l = ang / (ang_mag[:, None] + 1e-50)
    e_p = np.cross(e_l, e_r)
    e_p /= np.linalg.norm(e_p, axis=1, keepdims=True) + 1e-50
    rot[:, 0] = e_r
    rot[:, 1] = e_p
    rot[:, 2] = e_l
    return r_j, v_j, rot


# ---------------------------------------------------------------------------
# IC generators: per release event, a leading/trailing particle pair
# ---------------------------------------------------------------------------

# Chen et al. (2025) calibration: mean/covariance of the 6-D offsets
# [Dr/r_t, phi(deg), theta(deg), Dv/v_esc, alpha(deg), beta(deg)]
_CHEN_MEAN = np.array([1.6, -30.0, 0.0, 1.0, 20.0, 0.0])
_CHEN_COV = np.array([
    [0.1225, 0, 0, 0, -4.9, 0],
    [0, 529.0, 0, 0, 0, 0],
    [0, 0, 144.0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0],
    [-4.9, 0, 0, 0, 400.0, 0],
    [0, 0, 0, 0, 0, 484.0],
])


def create_ic_particle_spray_chen2025(orbit_sat, mass_sat, rj, rot=None,
                                      G: float = G_DEFAULT, seed: int = 0,
                                      *, R=None):
    """Chen+2025 correlated phase-space spray ICs: (2N, 6).

    ``R=`` is the reference keyword name for the per-step rotation
    matrices (reference fast_sims/spray.py:130); ``G=None`` selects the
    default constant as in the reference."""
    if R is not None:
        if rot is not None:
            raise TypeError("pass either rot or R, not both")
        rot = R
    if rot is None:
        raise TypeError("missing rotation matrices (rot= / R=)")
    if G is None:
        G = G_DEFAULT
    orbit_sat = np.asarray(orbit_sat, float)
    n = len(orbit_sat)
    rng = np.random.default_rng(seed)
    draw = rng.multivariate_normal(_CHEN_MEAN, _CHEN_COV, size=2 * n,
                                   method="svd")
    r_t = np.repeat(rj, 2)

    dr = draw[:, 0] * r_t
    phi = np.deg2rad(draw[:, 1])
    theta = np.deg2rad(draw[:, 2])
    v_esc = np.sqrt(2.0 * G * mass_sat / np.abs(dr))
    dv = draw[:, 3] * v_esc
    alpha = np.deg2rad(draw[:, 4])
    beta = np.deg2rad(draw[:, 5])

    dpos = np.column_stack([dr * np.cos(theta) * np.cos(phi),
                            dr * np.cos(theta) * np.sin(phi),
                            dr * np.sin(theta)])
    dvel = np.column_stack([dv * np.cos(beta) * np.cos(alpha),
                            dv * np.cos(beta) * np.sin(alpha),
                            dv * np.sin(beta)])

    ics = np.repeat(orbit_sat, 2, axis=0)
    rot2 = np.repeat(rot, 2, axis=0)
    sign = np.tile([1.0, -1.0], n)[:, None]    # trailing / leading arm
    ics[:, :3] += np.einsum("ni,nij->nj", sign * dpos, rot2)
    ics[:, 3:] += np.einsum("ni,nij->nj", sign * dvel, rot2)
    return ics


def create_ic_particle_spray_fardal2015(orbit_sat, rj, vj, rot=None,
                                        gala_modified: bool = True,
                                        seed: int = 0, *, R=None):
    """Fardal+2015 spray ICs (optionally Gala-modified dispersions).

    ``R=`` is the reference keyword name for the per-step rotation
    matrices (reference fast_sims/spray.py:227)."""
    if R is not None:
        if rot is not None:
            raise TypeError("pass either rot or R, not both")
        rot = R
    if rot is None:
        raise TypeError("missing rotation matrices (rot= / R=)")
    orbit_sat = np.asarray(orbit_sat, float)
    n = len(orbit_sat)
    rng = np.random.default_rng(seed)
    signs = np.tile([1.0, -1.0], n)
    rj2 = np.repeat(rj, 2) * signs
    vj2 = np.repeat(vj, 2) * signs
    rot2 = np.repeat(rot, 2, axis=0)

    disp_x = 0.5 if gala_modified else 0.4
    disp_vy = 0.5 if gala_modified else 0.4
    rx = rng.normal(2.0, disp_x, 2 * n)
    rz = rng.normal(0.0, 0.5, 2 * n) * rj2
    rvy = rng.normal(0.3, disp_vy, 2 * n) * vj2 \
        * (rx if gala_modified else 1.0)
    rvz = rng.normal(0.0, 0.5, 2 * n) * vj2
    rx = rx * rj2

    dpos = np.column_stack([rx, np.zeros(2 * n), rz])
    dvel = np.column_stack([np.zeros(2 * n), rvy, rvz])
    ics = np.repeat(orbit_sat, 2, axis=0)
    ics[:, :3] += np.einsum("ni,nij->nj", dpos, rot2)
    ics[:, 3:] += np.einsum("ni,nij->nj", dvel, rot2)
    return ics


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def create_particle_spray_stream(
    pot_host,
    initmass: float,
    sat_cen_present,
    scaleradius: float,
    num_particles: int = 10_000,
    prog_pot_kind: str = "King",
    dissolve_progenitor: bool = False,
    time_total: float = 3.0,
    time_end: float = 13.78,
    time_stripping=None,
    save_rate: int = 1,
    gala_modified: bool = True,
    add_perturber: dict | None = None,
    create_ic_method=create_ic_particle_spray_chen2025,
    verbose: bool = False,
    n_steps: int = 2048,
    eigenvalue_method: bool = True,
    seed: int = 0,
    G: float = G_DEFAULT,
    dtype=None,
    device="cuda",
    **prog_kwargs,
):
    """Generate a stellar stream by particle spray.

    Reference-equivalent surface (reference: spray.py:301-650); returns
    {'times', 'prog_xv', 'part_xv'} (numpy) with part_xv shape (N, 6) for
    save_rate == 1 or (N, n_saves, 6) with NaN before release.  The orbit
    integrations and the tidal tensors run on ``device`` (the card unless
    the caller passes ``device='cpu'``) in ``dtype`` (default
    ``torch.get_default_dtype()``).
    """
    if initmass <= 0 or scaleradius <= 0 or num_particles <= 0:
        raise ValueError("initmass, scaleradius, num_particles must be > 0")
    if time_total < 0:
        raise ValueError("time_total must be >= 0")

    sat_now = np.asarray(sat_cen_present, float).reshape(6)
    t_start = time_end - time_total
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    run = dict(dtype=dtype, device=device)

    # perturber folds into the rewinding potential (reference behaviour)
    pot_rewind = pot_host
    if add_perturber is not None:
        pert = make_perturber_potential(add_perturber, pot_host,
                                        t_start, time_end, G=G, **run)
        pot_rewind = pot_host + pert

    # 1) rewind, then flip to a forward trajectory.  The rewind uses the
    # error-controlled DP5(4) integrator (the reference uses
    # agama.orbit's DOP853 here, spray.py:478): fixed-step RK4 has a
    # documented blow-up mode on cusp-plunging progenitor orbits.
    # The tolerance follows the working dtype: 1e-10 is unattainable at
    # float32 (error-estimate rounding floor ~1e-7) — the controller
    # would shrink h until acceptance is noise, burning substeps and
    # risking max_substeps NaN-poisoning on eccentric orbits
    tol = 1e-10 if dtype == torch.float64 else 3e-7
    pot_rewind = field_on(pot_rewind, device, dtype)
    _, traj_back = integrate_orbit_adaptive(pot_rewind, sat_now,
                                            time_end, t_start,
                                            n_out=n_steps, rtol=tol,
                                            atol=tol, **run)
    traj_fwd = np.asarray(traj_back, float)[::-1]
    times_fwd = np.linspace(t_start, time_end, n_steps + 1)
    if verbose:
        print(f"rewound progenitor by {time_total} to t={t_start}")

    # 2) moving (optionally dissolving) progenitor potential
    prog_pot = make_progenitor_potential(prog_pot_kind, initmass,
                                         scaleradius, G=G, device=device,
                                         **prog_kwargs)
    if dissolve_progenitor:
        prog_pot = dissolving_schedule(prog_pot, t_start, time_end)
    prog_moving = moving_potential(prog_pot, times_fwd, traj_fwd)
    pot_total = pot_rewind + field_on(prog_moving, device, dtype)

    # 3) release schedule (pairs: one leading + one trailing particle
    # per release)
    if num_particles < 2:
        raise ValueError("num_particles must be >= 2 (particles are "
                         "released in leading/trailing pairs)")
    if num_particles % 2:
        warnings.warn(
            f"num_particles={num_particles} is odd; releasing "
            f"{num_particles - 1} (leading/trailing pairs)",
            stacklevel=2)
    n_rel = num_particles // 2
    if time_stripping is None:
        rel_idx = np.linspace(0, n_steps, n_rel).round().astype(int)
    else:
        ts = np.asarray(time_stripping, float)
        if ts.ndim != 1 or len(ts) not in (n_rel, n_rel + 1):
            raise ValueError(
                f"time_stripping must have ~num_particles//2 entries, "
                f"got {ts.shape}"
            )
        if np.any(np.diff(ts) < 0):
            raise ValueError("time_stripping must be non-decreasing")
        if ts.min() < t_start - 1e-9 or ts.max() > time_end + 1e-9:
            raise ValueError(
                "time_stripping values must lie in "
                f"[{t_start}, {time_end}]"
            )
        rel_idx = np.searchsorted(times_fwd, ts[:n_rel]).clip(0, n_steps)
    rel_states = traj_fwd[rel_idx]
    rel_times = times_fwd[rel_idx]

    # 4) tidal radii and ICs at the release points (evaluated at the
    # release times — the host may be evolving).  pot_rewind = host +
    # perturber: the perturber's tidal field matters exactly during
    # close passages (reference uses pot_host_eff here, spray.py:573)
    mass_for_rj = initmass
    r_j, v_j, rot = get_jacobi_radius(pot_rewind, rel_states, mass_for_rj,
                                      G=G, t=rel_times,
                                      eigenvalue_method=eigenvalue_method,
                                      dtype=dtype)
    if create_ic_method is create_ic_particle_spray_chen2025:
        ics = create_ic_method(rel_states, mass_for_rj, r_j, rot, G=G,
                               seed=seed)
    elif create_ic_method is create_ic_particle_spray_fardal2015:
        ics = create_ic_method(rel_states, r_j, v_j, rot,
                               gala_modified=gala_modified, seed=seed)
    else:
        ics = create_ic_method(rel_states, mass_for_rj, r_j, rot)
    t_release = np.repeat(rel_times, 2)

    # 5) propagate with per-particle release
    save_every = 0 if save_rate <= 1 else max(1, n_steps // save_rate)
    times_out, part = integrate_orbits_released(
        pot_total, ics, t_release, t_start, time_end, n_steps,
        save_every=save_every, **run,
    )
    part = np.asarray(part, float)

    if save_rate <= 1:
        prog_xv = traj_fwd[-1]
        result_part = part
        out_times = np.array([time_end])
    else:
        # mask pre-release states to NaN (reference convention)
        mask = times_out[:, None] < np.asarray(t_release)[None, :]
        part = np.where(mask[:, :, None], np.nan, part)
        result_part = np.transpose(part, (1, 0, 2))  # (N, T, 6)
        sel = np.searchsorted(times_fwd, times_out).clip(0, n_steps)
        prog_xv = traj_fwd[sel]
        out_times = times_out

    if verbose:
        print(f"spray complete: {len(ics)} particles, "
              f"{len(np.atleast_1d(out_times))} snapshots")
    return {"times": out_times, "prog_xv": prog_xv, "part_xv": result_part}
