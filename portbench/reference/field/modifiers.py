# Frozen copy of nbody_streams_tpu_torch/potentials/modifiers.py, trimmed to the
# shift the MW+LMC field needs: the benchmark's float64 reference of the field.  It
# imports nothing of the program, so a later change there does not move it.
"""The Shifted potential modifier (Agama semantics).

Counterpart of ``nbody_streams_tpu/potentials/modifiers.py``.  Time
interpolation is precomputed into piecewise polynomials (``PPoly``) at
build time.  The integrator's ``t`` is a Python float, so the interval of
a trajectory, a schedule or an evolving sequence is selected on the host
(where the JAX package uses ``searchsorted`` or ``lax.switch`` in the
traced step): the device sees only slices of the tables and host scalars,
and nothing reads a device value back.
"""
from __future__ import annotations


import numpy as np
import torch

from .interp import hermite_coeffs, spline_coeffs
from .base import Potential

__all__ = ["ShiftedPotential"]


class ShiftedPotential(Potential):
    """Evaluate ``inner`` at ``xyz - center(t)``.

    center: (3,) static (buffer ``static_center``) | (T, 4) rows [t,x,y,z]
    (cubic spline) | (T, 7) rows [t,x,y,z,vx,vy,vz] (cubic Hermite), as
    the submodule ``traj``.  Clamped outside the time range.
    """

    def __init__(self, inner: Potential, center):
        super().__init__()
        self.inner = inner
        arr = np.asarray(center, dtype=float)
        if arr.ndim == 1 and arr.shape == (3,):
            self.register_buffer("static_center", torch.as_tensor(arr))
            self.traj = None
            self.time_dependent = inner.time_dependent
        elif arr.ndim == 2 and arr.shape[1] in (4, 7):
            order = np.argsort(arr[:, 0])
            arr = arr[order]
            if arr.shape[1] >= 7:
                self.traj = hermite_coeffs(arr[:, 0], arr[:, 1:4],
                                           arr[:, 4:7])
            else:
                self.traj = spline_coeffs(arr[:, 0], arr[:, 1:4])
            self.static_center = None
            self.time_dependent = True
        else:
            raise ValueError(
                "center must be (3,), (T,4) [t,xyz] or (T,7) [t,xyz,vxyz]; "
                f"got shape {arr.shape}"
            )

    def center(self, t):
        if self.traj is None:
            return self.static_center
        return self.traj(t)

    def _shift(self, arr, t):
        return arr - self._like(self.center(t), arr)

    def _phi(self, arr, t):
        return self.inner._phi(self._shift(arr, t), t)

    def _force_v(self, arr, t):
        return self.inner._force_v(self._shift(arr, t), t)

    def _hess_v(self, arr, t):
        return self.inner._hess_v(self._shift(arr, t), t)
