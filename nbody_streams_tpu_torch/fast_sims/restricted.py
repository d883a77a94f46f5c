"""Restricted N-body: test particles in host + evolving progenitor
potential.

Counterpart of ``nbody_streams_tpu/fast_sims/restricted.py`` (the
reference's fast_sims/restricted.py:39-372).  The satellite's stars are
massless tracers moving in the combined host + progenitor field; every
``step_size`` integration steps the progenitor potential is rebuilt from
the currently-bound particles (spherical refit), tracking tidal
stripping self-consistently.  Orbit chunks run on ``device`` (the card
unless the caller passes ``device='cpu'``) in the working dtype; the
refit (data-dependent) runs on the host between chunks.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..constants import G_DEFAULT
from ..friction import _np
from ._common import (
    make_df_accel,
    make_perturber_potential,
    make_progenitor_potential,
    moving_potential,
    sample_progenitor,
    spherical_potential_from_particles,
)
from .orbits import field_on, integrate_orbit

__all__ = ["run_restricted_nbody"]


def run_restricted_nbody(
    pot_host,
    initmass: float,
    sat_cen_present,
    scaleradius: float | None = None,
    num_particles: int = 10_000,
    prog_pot_kind: str = "King",
    xv_init=None,
    dynFric: bool = False,
    pot_for_dynFric_sigma=None,
    time_total: float = 3.0,
    time_end: float = 0.0,
    step_size: int = 10,
    save_rate: int = 300,
    n_steps: int = 2000,
    add_perturber: dict | None = None,
    verbose: bool = False,
    seed: int = 0,
    G: float = G_DEFAULT,
    dtype=None,
    device="cuda",
    **prog_kwargs,
):
    """Returns {'times', 'prog_xv', 'part_xv', 'bound_mass'} (numpy).

    part_xv: (n_saves, N, 6); prog_xv: (n_saves, 6).

    When ``xv_init`` is given, particles are integrated forward directly
    from ``time_end - time_total`` with NO rewinding, and
    ``sat_cen_present`` is taken as the progenitor COM at that start
    time (reference semantics, restricted.py:68-80).

    ``dtype`` defaults to ``torch.get_default_dtype()``; the bound-energy
    potential is evaluated in it too.
    """
    if initmass <= 0:
        raise ValueError("initmass must be > 0")
    if scaleradius is not None and scaleradius <= 0:
        raise ValueError("scaleradius must be > 0 when given "
                         f"(got {scaleradius})")
    sat_now = np.asarray(sat_cen_present, float).reshape(6)
    t_start = time_end - time_total
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    run = dict(dtype=dtype, device=device)

    pot_env = pot_host
    if add_perturber is not None:
        pot_env = pot_host + make_perturber_potential(
            add_perturber, pot_host, t_start, time_end, G=G, **run)
    pot_env = field_on(pot_env, device, dtype)

    df_accel = None
    if dynFric:
        df_accel = make_df_accel(pot_host, initmass,
                                 pot_for_sigma=pot_for_dynFric_sigma, G=G)

    # --- initial particle set ------------------------------------------
    if xv_init is not None:
        particles = np.asarray(xv_init, float).copy()
        prog_now = sat_now.copy()
        t0 = t_start
    else:
        if scaleradius is None:
            raise ValueError("scaleradius required when xv_init is None")
        _, back = integrate_orbit(pot_env, sat_now, time_end, t_start,
                                  n_steps=n_steps, extra_accel=df_accel,
                                  **run)
        prog_now = np.asarray(back[-1], float)
        xv_local, _ = sample_progenitor(prog_pot_kind, num_particles,
                                        initmass, scaleradius, seed=seed,
                                        G=G, **prog_kwargs)
        particles = xv_local + prog_now[None, :]
        t0 = t_start

    mass_bound = float(initmass)
    prog_pot_local = (
        make_progenitor_potential(prog_pot_kind, initmass,
                                  scaleradius, G=G, device=device,
                                  **prog_kwargs)
        if scaleradius is not None else
        spherical_potential_from_particles(
            particles[:, :3], initmass / len(particles),
            center=prog_now[:3], G=G, device=device)
    )

    n_outer = max(1, n_steps // step_size)
    save_every_outer = max(1, n_outer // max(save_rate, 1))
    dt_chunk = (time_end - t0) / n_outer

    times_out, prog_out, part_out, mbound_out = [], [], [], []
    t = t0
    for k in range(n_outer):
        t_next = t0 + (k + 1) * dt_chunk
        # progenitor orbit over the chunk (with DF if requested)
        times_c, prog_traj = integrate_orbit(
            pot_env, prog_now, t, t_next, n_steps=step_size,
            extra_accel=df_accel, **run)
        prog_traj = np.asarray(prog_traj, float)
        moving_prog = moving_potential(prog_pot_local, times_c, prog_traj)
        # particles through host + moving progenitor
        moving_prog = field_on(moving_prog, device, dtype)
        _, ptraj = integrate_orbit(pot_env + moving_prog, particles, t,
                                   t_next, n_steps=step_size, **run)
        particles = np.asarray(ptraj[-1], float)
        prog_now = prog_traj[-1]
        t = t_next

        # --- bound-mass refit -------------------------------------------
        rel_p = particles[:, :3] - prog_now[:3]
        rel_v = particles[:, 3:] - prog_now[3:]
        phi_p = _np(prog_pot_local.potential(
            torch.as_tensor(rel_p, dtype=dtype, device=device)))
        energy = phi_p + 0.5 * (rel_v**2).sum(1)
        bound = energy < 0.0
        n_bound = int(bound.sum())
        mass_bound = initmass * n_bound / len(particles)
        if n_bound > 10:
            prog_pot_local = spherical_potential_from_particles(
                particles[bound, :3],
                np.full(n_bound, initmass / len(particles)),
                center=prog_now[:3], G=G, device=device)
        if verbose and (k % max(1, n_outer // 10) == 0):
            print(f"  chunk {k + 1}/{n_outer} t={t:.3f} "
                  f"bound={n_bound}/{len(particles)}")

        if k % save_every_outer == 0 or k == n_outer - 1:
            times_out.append(t)
            prog_out.append(prog_now.copy())
            part_out.append(particles.copy())
            mbound_out.append(mass_bound)

    return {
        "times": np.array(times_out),
        "prog_xv": np.array(prog_out),
        "part_xv": np.array(part_out),
        "bound_mass": np.array(mbound_out),
    }
