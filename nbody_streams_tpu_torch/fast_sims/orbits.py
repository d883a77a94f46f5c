"""Orbit integration in external potentials.

Counterpart of ``nbody_streams_tpu/fast_sims/orbits.py``, which replaces
the reference's ``agama.orbit`` for orbit rewinding and test-particle
propagation.  Fixed-step RK4 in a Python loop over steps on the device
(the JAX package's ``lax.scan``), vectorised over orbits, forward or
backward (t1 < t0), with per-particle release times (particles frozen
until released — the particle-spray pattern) and an optional extra
acceleration term (dynamical friction on the progenitor orbit); and an
error-controlled Dormand-Prince 5(4) on a fixed output grid.

The integrators take and return numpy.  They run on ``device`` (the card
unless the caller passes ``device='cpu'``; without a card the default
raises) in ``dtype``, which follows ``torch.get_default_dtype()`` — the
analogue of the JAX package's ``jax_enable_x64`` switch.  A torch-module
field is evaluated as a copy moved to that device and dtype (the caller's
object is left as it is); its ``force(pos, t)`` gets the step's time as a
Python float, so a time-dependent field picks its table interval on the
host and no step reads a device value back.  The adaptive integrator's
step control reads one number per substep, its error norm.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

from .._device import resolve_device

__all__ = ["integrate_orbit", "integrate_orbit_adaptive",
           "integrate_orbits_released"]


def _working(device, dtype):
    """The (device, dtype) an integration runs in."""
    return resolve_device(device), dtype or torch.get_default_dtype()


def field_on(pot, device, dtype):
    """``pot`` as an integration evaluates it: a torch module whose
    buffers are elsewhere or in another floating dtype as a copy moved to
    ``device`` and ``dtype``; anything else as it is."""
    if isinstance(pot, nn.Module) and any(
            b.device != device or (b.is_floating_point() and b.dtype != dtype)
            for b in pot.buffers()):
        pot = copy.deepcopy(pot).to(device=device, dtype=dtype)
    return pot


def _state(x, device, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, float), dtype=dtype, device=device)


def _accel_fn(pot, extra_accel=None):
    def acc(xv, t):
        a = pot.force(xv[..., :3], t=t)
        if extra_accel is not None:
            a = a + extra_accel(xv, t)
        return a

    return acc


def _deriv_fn(acc):
    def deriv(state, t):
        return torch.cat([state[..., 3:], acc(state, t)], dim=-1)

    return deriv


def _rk4_step(deriv, xv, t, dt):
    k1 = deriv(xv, t)
    k2 = deriv(xv + 0.5 * dt * k1, t + 0.5 * dt)
    k3 = deriv(xv + 0.5 * dt * k2, t + 0.5 * dt)
    k4 = deriv(xv + dt * k3, t + dt)
    return xv + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def integrate_orbit(pot, xv0, t0: float, t1: float, n_steps: int = 2048,
                    extra_accel=None, dtype=None, device="cuda"):
    """Integrate orbit(s) from t0 to t1 (either direction).

    xv0: (6,) or (N, 6).  Returns (times (n_steps+1,),
    trajectory (n_steps+1, ..., 6)) — every step stored, so the caller
    can spline/subsample (the agama.orbit ``trajsize`` analogue).
    ``extra_accel(xv, t)`` takes and returns tensors.
    """
    device, dtype = _working(device, dtype)
    pot = field_on(pot, device, dtype)
    xv = _state(xv0, device, dtype)
    dt = (t1 - t0) / n_steps
    deriv = _deriv_fn(_accel_fn(pot, extra_accel))
    traj = torch.empty((n_steps + 1,) + tuple(xv.shape), dtype=dtype,
                       device=device)
    traj[0] = xv
    t = t0
    for i in range(n_steps):
        xv = _rk4_step(deriv, xv, t, dt)
        traj[i + 1] = xv
        t = t0 + (i + 1) * dt
    times = t0 + dt * np.arange(n_steps + 1)
    return times, traj.cpu().numpy()


def integrate_orbits_released(pot, xv_release, t_release, t0: float,
                              t1: float, n_steps: int,
                              extra_accel=None, save_every: int = 0,
                              dtype=None, device="cuda"):
    """Propagate an ensemble with per-particle release times.

    Each particle i holds its release state ``xv_release[i]`` until the
    integration time passes ``t_release[i]``, then evolves in ``pot`` (the
    particle-spray propagation pattern; one masked loop).

    Returns (times, final (N,6)) when save_every == 0, else
    (save_times, trajectory (n_saves, N, 6)).
    """
    device, dtype = _working(device, dtype)
    pot = field_on(pot, device, dtype)
    xv_release = _state(xv_release, device, dtype)
    t_release = _state(t_release, device, dtype)
    dt = (t1 - t0) / n_steps
    deriv = _deriv_fn(_accel_fn(pot, extra_accel))

    # release comparison must follow the integration DIRECTION: in a
    # backward run (t1 < t0, dt < 0) a particle is live once the clock
    # has passed BELOW its release time
    sgn = 1.0 if dt >= 0 else -1.0
    s_release = sgn * t_release

    times = t0 + dt * np.arange(n_steps + 1)
    k = int(save_every)
    saves = [xv_release]
    xv, t = xv_release, t0
    for i in range(n_steps):
        stepped = _rk4_step(deriv, xv, t, dt)
        live = (s_release <= sgn * t + 0.5 * abs(dt))[:, None]
        xv = torch.where(live, stepped, xv_release)
        t = t0 + (i + 1) * dt
        # decimate INSIDE the loop: keeping every step would hold
        # (n_steps, N, 6) on the device
        if k and (i + 1) % k == 0:
            saves.append(xv)
    if not k:
        return times, xv.cpu().numpy()
    sel = np.arange(0, (n_steps // k) * k + 1, k)
    if n_steps % k:
        saves.append(xv)
        sel = np.append(sel, n_steps)
    return times[sel], torch.stack(saves).cpu().numpy()


# ---------------------------------------------------------------------------
# Error-controlled integration: embedded Dormand-Prince 5(4)
# ---------------------------------------------------------------------------
# Butcher tableau (Dormand & Prince 1980).  Fixed OUTPUT grid + adaptive
# substepping inside each output interval; the step size is shared across
# the batch and carried from interval to interval.
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = np.zeros((7, 7))
_DP_A[1, 0] = 1 / 5
_DP_A[2, :2] = (3 / 40, 9 / 40)
_DP_A[3, :3] = (44 / 45, -56 / 15, 32 / 9)
_DP_A[4, :4] = (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729)
_DP_A[5, :5] = (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176,
                -5103 / 18656)
_DP_A[6, :6] = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                11 / 84)
_DP_B5 = _DP_A[6, :7].copy()                       # 5th-order weights
_DP_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                   -92097 / 339200, 187 / 2100, 1 / 40])


def _dp45_step(deriv, xv, t, h, k1):
    """One embedded DP5(4) step from (xv, t) with step h: returns (xv5,
    err_estimate, k7).  ``k1`` is deriv(xv, t) (FSAL: row A[6] equals the
    5th-order weights, so the previous accepted step's k7 IS this step's
    k1).  Zero tableau entries are kept, so a NaN stage poisons the step
    as it does in the JAX package."""
    ks = [k1]
    for i in range(1, 7):
        acc = xv
        for j in range(i):
            acc = torch.add(acc, ks[j], alpha=h * _DP_A[i, j])
        ks.append(deriv(acc, t + _DP_C[i] * h))
    xv5 = xv
    err = torch.zeros_like(xv)
    for i in range(7):
        xv5 = torch.add(xv5, ks[i], alpha=h * _DP_B5[i])
        err = torch.add(err, ks[i], alpha=h * (_DP_B5[i] - _DP_B4[i]))
    return xv5, err, ks[6]


def integrate_orbit_adaptive(pot, xv0, t0: float, t1: float,
                             n_out: int = 256, rtol: float = 1e-9,
                             atol: float = 1e-12, extra_accel=None,
                             max_substeps: int = 100_000,
                             dtype=None, device="cuda"):
    """Error-controlled orbit integration on a fixed output grid.

    Adaptive Dormand-Prince 5(4) with a PI step controller replaces the
    fixed-step RK4 where accuracy matters (central cusps, highly
    eccentric orbits — the documented RK4 post-pericentre blow-up mode).
    The step size is shared across the batch (max error norm), so the
    output has the same (n_out+1, ..., 6) shape contract as
    ``integrate_orbit``.  Forward or backward (t1 < t0).

    ``max_substeps`` bounds the substeps per output interval; if an
    interval exhausts it before reaching its end time, that interval's
    output (and the rest of the trajectory) is NaN-poisoned so the
    failure is visible rather than a silently-truncated integration.
    Each substep reads its error norm back to the host (the JAX
    package's while-loop test).
    """
    device, dtype = _working(device, dtype)
    pot = field_on(pot, device, dtype)
    xv = _state(xv0, device, dtype)
    deriv = _deriv_fn(_accel_fn(pot, extra_accel))

    h_out = (t1 - t0) / n_out
    sign = 1.0 if t1 >= t0 else -1.0

    def err_norm(err, xv_a, xv_b):
        # RMS over the 6 phase-space components of each orbit, then MAX
        # over the batch: the shared step must satisfy the WORST orbit
        scale = atol + rtol * torch.maximum(xv_a.abs(), xv_b.abs())
        per_orbit = torch.sqrt(torch.mean((err / scale) ** 2, dim=-1))
        return per_orbit.max()

    traj = torch.empty((n_out + 1,) + tuple(xv.shape), dtype=dtype,
                       device=device)
    traj[0] = xv
    h = h_out / 16.0
    for i in range(n_out):
        t_start = t0 + i * h_out
        t_end = t0 + (i + 1) * h_out
        # an already-NaN carry (a previous interval failed) would burn
        # max_substeps rejected evaluations per remaining interval —
        # start with the budget spent so the loop never runs
        n = 0 if bool(torch.isfinite(xv).all()) else max_substeps
        k1 = deriv(xv, t_start)
        t = t_start
        while (t - t_end) * sign < 0 and n < max_substeps:
            # clip the trial step to the interval end
            clip = (t + h - t_end) * sign > 0
            h_try = t_end - t if clip else h
            xv_new, err, k7 = _dp45_step(deriv, xv, t, h_try, k1)
            e = err_norm(err, xv, xv_new).item()
            # a NaN error estimate (singular force eval) must count as
            # "infinitely wrong": reject and shrink, never grow
            if not math.isfinite(e):
                e = math.inf
            accept = e <= 1.0
            # PI controller, safety 0.9, order 5
            fac = 5.0 if e == 0.0 else min(max(0.9 * e ** -0.2, 0.2), 5.0)
            h_next = h_try * fac if abs(h_try * fac) < abs(h * 5.0) \
                else h * 5.0
            # an accepted step that was clipped to the interval boundary
            # must not collapse the carried cruise step to the sliver
            if clip and accept:
                h_next = h
            if accept:
                # FSAL: k7 = deriv(xv_new, t + h) is the next k1; on
                # reject (xv, t) are unchanged so k1 stays valid
                xv, t, k1 = xv_new, t + h_try, k7
            h = h_next
            n += 1
        # if the substep budget ran out before t_end, poison the output
        # instead of returning a silently-truncated trajectory
        if not (n < max_substeps or (t - t_end) * sign >= 0):
            xv = torch.full_like(xv, math.nan)
        traj[i + 1] = xv
    times = t0 + h_out * np.arange(n_out + 1)
    return times, traj.cpu().numpy()
