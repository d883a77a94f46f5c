"""One KDK step of the program, judged at sampled particles.

The configuration's precision, float32_kahan, holds each coordinate as a
float32 value y and a compensation c (the value is y - c) and takes the
forces at the float32 values y.  From the state a = (x_a, v_a) at time
t_a, the kick-drift-kick step of dt gives, for each particle j,

    v_h = v_a + dt/2 acc(y_a)_j,  x_ref = x_a + dt v_h,
    v_ref = v_h + dt/2 acc(y_b)_j,

with acc the self-gravity, the external field and the friction.  The
self-gravity is the configuration's (``gravity``, a callable with the
signature of ``gravity.accel``: its ``reference_gravity``), by default the
softened direct sum of ``gravity.py``.  The reference computes acc at the
sampled targets in float64: at a from every particle of a, and at b from
every particle of the program's state b,
since the positions of b that are not sampled need every acceleration of
a.  So the step is followed from the state it starts from, and the
program's b is read as the points of the second force only; the sampled
targets check the program's b where the sample falls.  The friction
refreshes its centre at a: from a's positions, and from a's velocities or,
where ``a`` carries one (``v_com``), the centre velocity the program took
at its refresh.  Two numbers come out, each the worst sampled particle:

* ``acc_err``: |v_b - v_ref| / (dt max(|acc|, FLOOR median |acc|)), the
  error of the step's mean acceleration acc = (acc_a + acc_b) / 2
  against the particle's own, floored at a tenth of the sample's median
  (where the terms cancel, near the centre or the satellite's saddle
  points, |acc| is near nought);
* ``pos_err``: |x_b - x_ref| / median |x_ref - x_a|, the error of the drift
  against the sample's median displacement.

Targets whose distance from the friction sphere's edge is under
``TIE`` of its radius are left out: float32 and float64 may decide there
differently, which would be rounding, not a fault.
"""
from __future__ import annotations

import torch

from . import gravity as _direct

TIE = 1e-5
FLOOR = 0.1


def _acc(x_t, idx, x_src, mass, soft, G, field, t, fric, fric_state,
         self_gravity):
    acc = self_gravity(x_t, soft[idx], idx, x_src, mass, soft, G)
    keep = torch.ones(idx.numel(), dtype=torch.bool, device=x_t.device)
    if field is not None:
        acc = acc + field.force(x_t, t)
    if fric is not None:
        a_df, edge = fric.on(fric_state, x_t)
        acc = acc + a_df
        keep = edge >= TIE
    return acc, keep


def step(a, b, sample, mass, soft, G, dt, field=None, fric=None,
         gravity=None):
    """``acc_err``, ``pos_err`` and ``excluded`` (targets left out as
    ties) of the program's step from ``a`` to ``b`` (dicts of x, v: (N, 3)
    float64 values, y: the float32 part of x, as float64, on one device,
    t, and in ``a`` optionally the friction's v_com), at the particles
    ``sample``; ``gravity``: the self-gravity (None: ``gravity.accel``),
    which gets every particle of the state as its sources."""
    s = sample
    self_gravity = _direct.accel if gravity is None else gravity
    fa = fb = None
    if fric is not None:
        fa = fric.at_refresh(a["y"], a["v"], mass, a["t"],
                             v_com=a.get("v_com"))
        fb = fric.predicted(fa, b["t"])
    acc_a, keep_a = _acc(a["y"][s], s, a["y"], mass, soft, G, field,
                         a["t"], fric, fa, self_gravity)
    v_h = a["v"][s] + 0.5 * dt * acc_a
    x_ref = a["x"][s] + dt * v_h
    acc_b, keep_b = _acc(b["y"][s], s, b["y"], mass, soft, G, field,
                         b["t"], fric, fb, self_gravity)
    v_ref = v_h + 0.5 * dt * acc_b
    keep = keep_a & keep_b
    acc = torch.linalg.norm(0.5 * (acc_a + acc_b), dim=1)
    acc = torch.clamp_min(acc, FLOOR * acc.median())
    drift = torch.linalg.norm(x_ref - a["x"][s], dim=1)
    dv = (torch.linalg.norm(b["v"][s] - v_ref, dim=1) / (dt * acc))[keep]
    dx = torch.linalg.norm(b["x"][s] - x_ref, dim=1)[keep]
    return {"acc_err": float(dv.max()),
            "pos_err": float(dx.max() / drift.median()),
            "excluded": int((~keep).sum())}
