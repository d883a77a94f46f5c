"""KDK leapfrog integration: a Python loop of steps over device tensors.

Counterpart of ``nbody_streams_tpu/integrate.py``, where a chunk of steps
is one compiled ``lax.scan``.  Here a chunk is a Python loop; the state
stays on the device and the host sees it only at chunk boundaries.

Precision model: fp32 state with compensated (Kahan two-sum) position and
velocity accumulation (``compensated=True``), each state array carrying a
correction array; float64 state for validation.  Updates are out of place:
at the sizes this runs (N <= a few million) the state is tens of MB, and a
new state per step keeps earlier states valid for callers that hold them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .ops.cuda_direct import slab_sort_key
from .ops.pairwise import _as_tensor

__all__ = ["IntegratorState", "ForceExtra", "make_accel_fn",
           "make_kdk_step", "run_chunk", "init_state", "system_energy",
           "from_jax_state", "to_numpy_state"]


@dataclasses.dataclass
class IntegratorState:
    """Device-resident integration state."""

    pos: torch.Tensor       # (N, 3)
    vel: torch.Tensor       # (N, 3)
    pos_c: torch.Tensor     # compensation for pos (zeros when not used)
    vel_c: torch.Tensor     # compensation for vel
    acc: torch.Tensor       # (N, 3) total acceleration at current state
    ext_acc: torch.Tensor   # cached external-potential acceleration
    extra_state: Any        # ForceExtra state (anything, or ())
    step: int               # global step counter (host int: no device sync)
    # (N,) slab order for the sorted CUDA path, refreshed by run_chunk
    # (presort / presort_every); None when unused.  A stale order is exact
    # by construction (see ops/cuda_direct.py).
    sort_order: torch.Tensor | None = None


class ForceExtra:
    """Protocol for extra-force terms (e.g. dynamical friction).

    * ``init_state(pos, vel, mass, t)`` -> state
    * ``__call__(state, pos, vel, mass, t, phi=None, step=0)``
      -> (acc, new_state)

    Set ``needs_phi = True`` to receive the self-gravity potential."""

    def init_state(self, pos, vel, mass, t):
        return ()

    def __call__(self, state, pos, vel, mass, t, phi=None, step=0):
        raise NotImplementedError


def _comp_add(x, c, delta):
    """Kahan two-sum accumulate: (x, c) += delta with compensation c."""
    y = delta - c
    t = x + y
    c = (t - x) - y
    return t, c


def make_accel_fn(
    solver,
    mass,
    external_potential=None,
    external_update_interval: int = 1,
    force_extra: ForceExtra | None = None,
):
    """Total acceleration = self gravity + cached external + extra term.

    Returns ``accel(pos, vel, t, step, ext_acc, extra_state,
    refresh_ext=False, order=None) -> (acc, ext_acc, extra_state)``.
    ``external_potential`` is duck-typed: ``force(pos, t)`` returning an
    (N, 3) tensor or array.  It is re-evaluated when
    ``step % external_update_interval == 0`` (or ``refresh_ext``)."""
    k = int(external_update_interval)

    def accel(pos, vel, t, step, ext_acc, extra_state, refresh_ext=False,
              order=None):
        acc = solver.accel(pos, order=order)
        if external_potential is not None:
            if refresh_ext or k <= 1 or step % k == 0:
                ext_acc = torch.as_tensor(
                    external_potential.force(pos, t), dtype=acc.dtype,
                    device=acc.device)
            acc = acc + ext_acc
        if force_extra is not None:
            # the carried slab order is reused for phi too
            phi = (solver.potential(pos, order=order)
                   if getattr(force_extra, "needs_phi", False) else None)
            extra, extra_state = force_extra(
                extra_state, pos, vel, mass, t, phi=phi, step=step)
            acc = acc + torch.as_tensor(extra, dtype=acc.dtype,
                                        device=acc.device)
        return acc, ext_acc, extra_state

    return accel


def make_kdk_step(accel_fn, dt: float, t0: float, compensated: bool = True):
    """One symplectic kick-drift-kick step: ``step_fn(state) -> state``.

    ``t`` is reconstructed as ``t0 + step*dt`` from the integer step
    counter (never accumulated in low precision)."""

    def step_fn(state: IntegratorState) -> IntegratorState:
        half = 0.5 * dt
        if compensated:
            vel, vel_c = _comp_add(state.vel, state.vel_c, state.acc * half)
            pos, pos_c = _comp_add(state.pos, state.pos_c, vel * dt)
        else:
            vel, vel_c = state.vel + state.acc * half, state.vel_c
            pos, pos_c = state.pos + vel * dt, state.pos_c
        step = state.step + 1
        t = t0 + step * dt
        acc, ext_acc, extra_state = accel_fn(
            pos, vel, t, step, state.ext_acc, state.extra_state,
            order=state.sort_order)
        if compensated:
            vel, vel_c = _comp_add(vel, vel_c, acc * half)
        else:
            vel = vel + acc * half
        return IntegratorState(pos, vel, pos_c, vel_c, acc, ext_acc,
                               extra_state, step, state.sort_order)

    return step_fn


def run_chunk(step_fn, state: IntegratorState, n_steps: int,
              presort: bool = False, presort_every: int | None = None):
    """Run ``n_steps`` KDK steps.

    ``presort=True`` refreshes the state's slab order from the current
    positions before the first step (one argsort per chunk instead of one
    per force call); ``presort_every=k`` also refreshes it every ``k``
    steps inside the chunk."""
    for i in range(n_steps):
        if (presort and i == 0) or (presort_every and i
                                    and i % presort_every == 0):
            state = dataclasses.replace(state,
                                        sort_order=slab_sort_key(state.pos))
        state = step_fn(state)
    return state


def system_energy(state: IntegratorState, solver, mass):
    """(KE, PE) 0-dim tensors with PE = 0.5 sum m_i phi_i (self-gravity)."""
    phi = solver.potential(state.pos, order=state.sort_order)
    v2 = (state.vel * state.vel).sum(1)
    return 0.5 * (mass * v2).sum(), 0.5 * (mass * phi).sum()


def init_state(
    pos,
    vel,
    accel_fn,
    mass,
    t0: float,
    start_step: int = 0,
    dt: float = 0.0,
    dtype=torch.float32,
    force_extra: ForceExtra | None = None,
    sort_fn=None,
    device=None,
) -> IntegratorState:
    """Build the initial state on ``device``, including the first force
    evaluation (at the resume time ``t0 + start_step*dt``).

    With no ``device`` a tensor ``pos`` keeps its device; anything else
    goes to the card, and without one the default raises (pass
    ``device='cpu'`` for the CPU).  Pass ``sort_fn`` (e.g.
    ``solver.sort_key``) when the chunks will run with ``presort=True`` so
    the first force call already reuses an order."""
    if device is None:
        device = pos.device if isinstance(pos, torch.Tensor) else "cuda"
    device = resolve_device(device)
    pos = _as_tensor(pos, dtype, device)
    vel = _as_tensor(vel, dtype, device)
    zeros = torch.zeros_like(pos)
    sort_order = sort_fn(pos) if sort_fn is not None else None
    t = t0 + start_step * dt
    extra_state = (force_extra.init_state(pos, vel, mass, t)
                   if force_extra is not None else ())
    acc, ext_acc, extra_state = accel_fn(
        pos, vel, t, start_step, zeros, extra_state, refresh_ext=True,
        order=sort_order)
    return IntegratorState(pos, vel, zeros, torch.zeros_like(vel), acc,
                           ext_acc, extra_state, int(start_step), sort_order)


_STATE_ARRAYS = ("pos", "vel", "pos_c", "vel_c", "acc", "ext_acc")


def _extra_from_numpy(extra, device):
    """A ForceExtra state from numpy: a dict's arrays become tensors on
    ``device`` (dtypes kept) and its ``t_prev`` a Python float (the port
    keeps the step's time on the host); a bare array becomes a tensor."""
    if isinstance(extra, dict):
        return {k: (float(np.asarray(v)) if k == "t_prev"
                    else _extra_from_numpy(v, device))
                for k, v in extra.items()}
    if isinstance(extra, (np.ndarray, np.generic)):
        return torch.as_tensor(np.array(extra), device=device)
    return extra


def _extra_to_numpy(extra):
    if isinstance(extra, dict):
        return {k: _extra_to_numpy(v) for k, v in extra.items()}
    if isinstance(extra, torch.Tensor):
        return extra.detach().cpu().numpy()
    if isinstance(extra, float):
        return np.float64(extra)
    return extra


def from_jax_state(arrays: dict, extra_state=None,
                   device=None) -> IntegratorState:
    """The port's state from the JAX package's ``IntegratorState`` fields
    given as numpy arrays (``pos, vel, pos_c, vel_c, acc, ext_acc, step,
    sort_order``; ``sort_order`` may be absent, None or empty for no
    order), on ``device``: the card unless the caller passes
    ``device='cpu'`` (without a card the default raises).  Dtypes are
    kept.

    ``extra_state`` is the JAX state's ``extra_state`` as numpy (e.g. the
    friction's dict ``r_com, v_com, r_sphere, a_df, t_prev`` and, for
    ``bound_phi``, ``m_bound, bound``): its arrays become tensors and
    ``t_prev`` a Python float.  None gives ()."""
    device = resolve_device("cuda" if device is None else device)
    fields = {k: torch.as_tensor(np.array(arrays[k]), device=device)
              for k in _STATE_ARRAYS}
    order = arrays.get("sort_order")
    if order is not None and np.size(order) == 0:
        order = None
    if order is not None:
        order = torch.as_tensor(np.asarray(order, np.int64), device=device)
    extra = (() if extra_state is None
             else _extra_from_numpy(extra_state, device))
    return IntegratorState(extra_state=extra, step=int(arrays["step"]),
                           sort_order=order, **fields)


def to_numpy_state(state: IntegratorState) -> dict:
    """The state's fields as numpy arrays (the keys of ``from_jax_state``;
    ``sort_order`` is None when the state holds no order), and
    ``extra_state`` with its tensors as numpy arrays."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _STATE_ARRAYS}
    out["step"] = np.int32(state.step)
    out["sort_order"] = (None if state.sort_order is None
                         else state.sort_order.cpu().numpy().astype(np.int32))
    out["extra_state"] = _extra_to_numpy(state.extra_state)
    return out
