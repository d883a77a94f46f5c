# Frozen copy of nbody_streams_tpu_torch/potentials/base.py, trimmed to what the
# MW+LMC field needs: the benchmark's float64 reference of the field.  It
# imports nothing of the program, so a later change there does not move it.
"""Potential base class: autograd-derived forces, Agama-compatible surface.

Counterpart of ``nbody_streams_tpu/potentials/base.py``.  Each potential
is an ``nn.Module`` whose tables are registered buffers, so
``.to(device, dtype)`` moves a whole field (composites and modifiers
included) and ``load_state_dict`` carries the JAX package's arrays across.
A subclass defines one *batched* scalar field ``_phi(arr (N, 3), t) ->
(N,)``; torch autograd supplies forces, Hessians and densities (Laplacian /
4 pi G), consistent with each other by construction.  Evaluations are
independent per point, so the gradient of ``phi.sum()`` is each point's
gradient exactly.

Evaluation runs in the dtype of the positions: tables are cast to it where
they differ.  Public surface (Agama conventions, as the JAX package):

* ``potential(xyz, t)``  -> Phi, (km/s)^2
* ``force(xyz, t)``      -> -grad Phi, (km/s)^2/kpc
* ``density(xyz, t)``    -> Laplacian Phi / (4 pi G), Msun/kpc^3
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


from .constants import G_DEFAULT

__all__ = ["Potential", "CompositePotential"]

FOUR_PI_G = 4.0 * math.pi * G_DEFAULT


def _hess6(rows):
    """Hessian rows (3 x (N, 3)) -> (N, 6) [xx, yy, zz, xy, yz, xz]."""
    return torch.stack([rows[0][:, 0], rows[1][:, 1], rows[2][:, 2],
                        rows[0][:, 1], rows[1][:, 2], rows[0][:, 2]], 1)


class Potential(nn.Module):
    """Base class; subclasses implement ``_phi(arr (N, 3), t) -> (N,)``."""

    #: Subclasses flip this when Phi genuinely depends on t (modifiers do).
    time_dependent: bool = False

    def __init__(self):
        super().__init__()
        # ``.to()`` moves this empty buffer too, so a field without tables
        # (the analytic ones) still knows where it was put
        self.register_buffer("_where", torch.empty(0), persistent=False)

    # -- to implement -------------------------------------------------------
    def _phi(self, arr, t):
        raise NotImplementedError

    # -- helpers ------------------------------------------------------------
    def _device(self):
        return self._where.device

    @staticmethod
    def _like(table, arr):
        """``table`` in the dtype of the positions."""
        return table if table.dtype == arr.dtype else table.to(arr.dtype)

    def _prep(self, xyz):
        """Coerce any (..., 3) input to a flat (N, 3) batch.

        Returns (arr (N, 3), lead) where ``lead`` is the original leading
        shape (``None`` for a single (3,) point) — ``_out`` restores it.
        Tensors keep their device; other input goes to the potential's.
        Integer/bool input is promoted to torch's default float."""
        if isinstance(xyz, torch.Tensor):
            arr = xyz.detach()
        else:
            arr = torch.as_tensor(np.asarray(xyz), device=self._device())
        if arr.ndim == 0 or arr.shape[-1] != 3:
            raise ValueError(f"positions must be (..., 3), got "
                             f"{tuple(arr.shape)}")
        if not arr.is_floating_point():
            arr = arr.to(torch.get_default_dtype())
        if arr.ndim == 1:
            return arr[None, :], None
        lead = tuple(arr.shape[:-1])
        return arr.reshape(-1, 3), lead

    @staticmethod
    def _out(val, lead):
        if lead is None:
            return val[0]
        return val.reshape(lead + tuple(val.shape[1:]))

    # -- derived, batched ---------------------------------------------------
    def _force_v(self, arr, t):
        with torch.enable_grad():
            x = arr.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self._phi(x, t).sum(), x)
        return -g

    def _hess_v(self, arr, t):
        with torch.enable_grad():
            x = arr.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self._phi(x, t).sum(), x,
                                       create_graph=True)
            rows = []
            for k in range(3):
                gk = g[:, k].sum()
                h = (torch.autograd.grad(gk, x, retain_graph=True,
                                         allow_unused=True)[0]
                     if gk.requires_grad else None)
                rows.append(torch.zeros_like(x) if h is None else h)
        return _hess6([r.detach() for r in rows])

    # -- public (Agama-compatible) -----------------------------------------
    def potential(self, xyz, t=0.0):
        arr, lead = self._prep(xyz)
        with torch.no_grad():
            return self._out(self._phi(arr, t), lead)

    def force(self, xyz, t=0.0):
        arr, lead = self._prep(xyz)
        return self._out(self._force_v(arr, t), lead)

    def density(self, xyz, t=0.0):
        arr, lead = self._prep(xyz)
        h6 = self._hess_v(arr, t)
        rho = (h6[:, 0] + h6[:, 1] + h6[:, 2]) / FOUR_PI_G
        return self._out(rho, lead)


class CompositePotential(Potential):
    """Sum of member potentials (members in an ``nn.ModuleList``)."""

    def __init__(self, components):
        super().__init__()
        components = list(components)
        if not components:
            raise ValueError("CompositePotential needs >= 1 component")
        self.components = nn.ModuleList(components)
        self.time_dependent = any(c.time_dependent for c in components)

    def _phi(self, arr, t):
        return sum(c._phi(arr, t) for c in self.components)

    # Sum member implementations directly (lets members keep their own
    # fast paths instead of differentiating through the sum).

    def _force_v(self, arr, t):
        return sum(c._force_v(arr, t) for c in self.components)

    def _hess_v(self, arr, t):
        return sum(c._hess_v(arr, t) for c in self.components)
