"""Gravity-solver front-end: one object, interchangeable backends.

Counterpart of ``nbody_streams_tpu/ops/dispatch.py``.  ``DirectGravity``
packages per-particle mass/softening (on the solver's device, in the
precision's dtype) with a choice of implementation:

* ``'torch'`` — blocked plain-torch oracle (ops/pairwise.py), any device
* ``'cuda'``  — the hand-written CUDA kernels (ops/cuda_direct.py); on a
  CPU device it runs their plain torch versions
* ``'auto'``  — ``'cuda'`` on a CUDA device, ``'torch'`` on the CPU

The solver lives on ``device``: the card unless the caller passes
``device='cpu'`` (without a card the default raises).  All backends
share one contract: ``accel(pos) -> (N, 3)`` and ``potential(pos) ->
(N,)``, closed over the particle population.
"""
from __future__ import annotations

import warnings

import torch

from .._device import resolve_device
from ..constants import (
    G_DEFAULT,
    PAIRWISE_EPS2,
    validate_kernel,
    validate_precision,
)
from . import cuda_direct, pairwise

__all__ = ["DirectGravity"]

_TILE_KEYS = {"tm", "tn", "max_sub", "mxu", "fold_mass"}
# tile_config keys of the TPU's sorted Pallas path with no CUDA meaning
_TPU_TILE_KEYS = {
    "max_sub": "sources per TPU grid step (VMEM superblocks)",
    "mxu": "the TPU's matrix-unit moment form",
    "fold_mass": "the mass fold of the matrix-unit moment form",
}

_NOT_PORTED = {
    "xla": "the TPU-only XLA two-pass backend is not ported (ROADMAP.md, "
           "'Do not port')",
    "sharded": "the multi-device ring is not ported yet (ROADMAP.md "
               "Queue 1 item 6)",
}


def _default_impl(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "torch"


class DirectGravity:
    """O(N^2) direct-summation gravity bound to a particle population.

    ``target_drift`` is validated and kept but changes nothing: on the
    TPU it only unfolds the mass from the matrix-unit moment form, which
    the port does not have.

    ``device`` is the card by default; without one it raises, naming
    ``device='cpu'``, the CPU option.

    ``tile_config`` overrides the band geometry of the slab-sorted path:
    ``tm`` (targets per band tile) and ``tn`` (sources per band row),
    positive multiples of 64.  The TPU's other keys (``max_sub``,
    ``mxu``, ``fold_mass``) are accepted and ignored with a
    ``PerformanceWarning``; off the sorted path the overrides are ignored
    with a warning at the force call, as on the TPU."""

    def __init__(
        self,
        mass,
        softening,
        G: float = G_DEFAULT,
        kernel: str = "spline",
        precision: str = "float32_kahan",
        impl: str = "auto",
        block_size: int | None = None,
        device=None,
        eps2: float = PAIRWISE_EPS2,
        target_drift: float | None = None,
        tile_config: dict | None = None,
    ):
        validate_kernel(kernel)
        validate_precision(precision)
        self.kernel = kernel
        self.precision = precision
        self.kahan = precision == "float32_kahan"
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.G = float(G)
        self.eps2 = float(eps2)
        self.device = resolve_device("cuda" if device is None else device)

        mass = pairwise._as_tensor(mass, self.dtype, self.device)
        softening = pairwise._as_tensor(softening, self.dtype, self.device)
        if mass.ndim == 0:
            raise ValueError("mass must be a per-particle array")
        n = mass.shape[0]

        if impl in _NOT_PORTED:
            raise NotImplementedError(f"impl={impl!r}: {_NOT_PORTED[impl]}")
        if impl == "auto":
            impl = _default_impl(self.device)
        if impl not in ("torch", "cuda"):
            raise ValueError(f"Unknown gravity impl {impl!r}")
        if impl == "cuda" and precision == "float64":
            impl = "torch"  # the kernels are fp32-only by design
        self.impl = impl
        if softening.ndim == 0:
            softening = torch.full((n,), float(softening), dtype=self.dtype,
                                   device=self.device)
        self.n = n
        self.mass = mass
        self.softening = softening
        self.block_size = block_size or pairwise._choose_block(n)

        if target_drift is not None:
            target_drift = float(target_drift)
            if not target_drift > 0.0:
                raise ValueError("target_drift must be a positive |dE/E| "
                                 f"bound (got {target_drift!r})")
        self.target_drift = target_drift

        self.tile_config = tile_config
        self._tile = {}
        if tile_config is not None:
            bad = set(tile_config) - _TILE_KEYS
            if bad:
                raise ValueError(f"unknown tile_config keys: {sorted(bad)}")
            self._tile = {k: int(tile_config[k]) for k in ("tm", "tn")
                          if k in tile_config}
            cuda_direct._check_geometry(self._tile.get("tm", cuda_direct.TM),
                                        self._tile.get("tn", cuda_direct.TN))
            ignored = sorted(set(tile_config) & set(_TPU_TILE_KEYS))
            if ignored:
                from ..species import PerformanceWarning

                what = "; ".join(f"{k}: {_TPU_TILE_KEYS[k]}" for k in ignored)
                warnings.warn(
                    f"tile_config keys {ignored} have no meaning for the "
                    f"CUDA kernels and are ignored ({what})",
                    PerformanceWarning, stacklevel=2)

        if precision == "float32_fast":
            from ..species import PerformanceWarning

            warnings.warn(
                "precision='float32_fast' has no fast tier in this package "
                "(the TPU's expanded-r^2 matrix-unit form is not ported); "
                "it runs as plain 'float32'", PerformanceWarning,
                stacklevel=2)

    def _check_pos(self, pos):
        if pos.ndim != 2 or tuple(pos.shape) != (self.n, 3):
            raise ValueError(
                f"pos shape {tuple(pos.shape)} does not match the solver's "
                f"({self.n}, 3) particle population")

    # -- spatial-sort order reuse --------------------------------------------
    @property
    def spatial_sort_active(self) -> bool:
        """True when accel/potential take the slab-sorted two-pass path
        and therefore accept a reusable ``order=`` (the integrator sorts
        once per chunk instead of per force call)."""
        return (self.impl == "cuda"
                and cuda_direct.uses_spatial_sort(self.kernel, self.n))

    def sort_key(self, pos):
        """The slab order accel/potential would compute internally."""
        return cuda_direct.slab_sort_key(pos)

    @property
    def presort_interval(self):
        """In-chunk order refresh cadence for ``run_chunk``: every step on
        the sorted path.  A stale order stays exact (the band windows
        widen until the single-pass fallback takes over), but at the
        N = 65,536 bench case an order ~10 steps old already forces the
        fallback, while a GPU argsort of the positions costs far less
        than the two-pass saving (PERF.md)."""
        return 1 if self.spatial_sort_active else None

    # -- backend dispatch ---------------------------------------------------
    def accel(self, pos, order=None):
        """Softened gravitational acceleration, (N, 3) in solver dtype.

        ``order`` optionally supplies a precomputed (possibly stale) slab
        order for the sorted path; ignored by the oracle."""
        self._check_pos(pos)
        pos = pos.to(self.dtype)
        if self.impl == "cuda":
            return cuda_direct.cuda_accel(
                pos, self.mass, self.softening, self.G, self.kernel,
                self.kahan, self.eps2, order=order, **self._tile)
        return pairwise._pairwise_blocked(
            pos, self.mass, self.softening, self.G, self.kernel, self.kahan,
            self.block_size, "acc", self.eps2)

    def potential(self, pos, order=None):
        """Softened gravitational potential per particle, (N,)."""
        self._check_pos(pos)
        pos = pos.to(self.dtype)
        if self.impl == "cuda":
            return cuda_direct.cuda_potential(
                pos, self.mass, self.softening, self.G, self.kernel,
                self.kahan, self.eps2, order=order, **self._tile)
        return pairwise._pairwise_blocked(
            pos, self.mass, self.softening, self.G, self.kernel, self.kahan,
            self.block_size, "pot", self.eps2)
