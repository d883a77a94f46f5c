"""Faults planted in the program's KDK step, for the check's own tests and
for reading what the check gives under each (``control.py --fault``).

The faults a one-chip cell can have, each either in every step or from the
second step of each ``run_simulation`` call on (where the warm-up call's
one step cannot show it, and only the window's own steps can):

* ``unchanged``: a step returns its state unchanged (the step counter
  still advances);
* ``half``: half of the particles are left out of the step;
* ``altered``: one particle's answer is altered where the step makes it;
* ``stale.late``: from the second step on, a step keeps the acceleration
  it was given in place of the one it computed (a buffer not refreshed).

A configuration's module may add faults of its own, such as a contraction
in TF32: ``FAULTS``, a mapping from a name to a factory, called with no
arguments, of a context manager that plants the fault.  The names here
come first.
"""
from __future__ import annotations

import contextlib
import dataclasses


def _unchanged(state, new):
    return dataclasses.replace(state, step=new.step)


def _half(state, new):
    import torch

    h = state.pos.shape[0] // 2
    keep = {k: torch.cat([getattr(new, k)[:h], getattr(state, k)[h:]])
            for k in ("pos", "vel", "pos_c", "vel_c")}
    return dataclasses.replace(new, **keep)


def _altered(state, new):
    vel = new.vel.clone()
    vel[vel.shape[0] // 3, 0] += 0.01
    return dataclasses.replace(new, vel=vel)


def _stale(state, new):
    return dataclasses.replace(new, acc=state.acc)


_BASE = {"unchanged": _unchanged, "half": _half, "altered": _altered}
FAULTS = {**_BASE, **{f"{k}.late": v for k, v in _BASE.items()},
          "stale.late": _stale}


@contextlib.contextmanager
def planted(name, workload=None):
    """Run the program with fault ``name`` (None: none): one of ``FAULTS``
    in its KDK step, or else one of the ``FAULTS`` of the configuration
    module of cell ``workload``."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        from portbench import harness

        w = harness.workload(harness.manifest(), workload)
        with harness.config(w["config"])[1].FAULTS[name]():
            yield
        return
    from nbody_streams_tpu_torch import run as prun

    fault, late = FAULTS[name], name.endswith(".late")
    make = prun.make_kdk_step

    def broken_make(*args, **kwargs):
        step = make(*args, **kwargs)
        done = [0]

        def broken(state):
            new = step(state)
            done[0] += 1
            return new if late and done[0] == 1 else fault(state, new)

        return broken

    prun.make_kdk_step = broken_make
    try:
        yield
    finally:
        prun.make_kdk_step = make
