"""Gravity-solver front-end: one object, interchangeable backends.

Counterpart of ``nbody_streams_tpu/ops/dispatch.py``.  ``DirectGravity``
packages per-particle mass/softening (on the solver's device, in the
precision's dtype) with a choice of implementation:

* ``'torch'`` — blocked plain-torch oracle (ops/pairwise.py), any device
* ``'cuda'``  — the hand-written CUDA kernels (ops/cuda_direct.py); on a
  CPU device it runs their plain torch versions
* ``'sharded'`` — the ring of source blocks over a list of devices
  (``parallel/sharded.py``); the list may name one device more than once
* ``'auto'``  — ``'cuda'`` on a CUDA device, ``'torch'`` on the CPU;
  ``'sharded'`` when ``devices`` has more than one entry

The solver lives on ``device``: the card unless the caller passes
``device='cpu'`` (without a card the default raises); a sharded solver
lives on the first of its ``devices``.  All backends share one contract:
``accel(pos) -> (N, 3)`` and ``potential(pos) -> (N,)``, closed over the
particle population.  How a backend lays the rows out (the sorted path's
slab order, the ring's padding to whole shards) stays inside it.
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

# target_drift= below this |dE/E| class unfolds G m from the moment form
# (the JAX package's dispatch.py:50-53): on the TPU the folded moments
# drifted ~2.1e-7 over 1000 steps at N = 1M against ~1e-8 unfolded
_FOLD_MASS_DRIFT = 1e-7

_NOT_PORTED = {
    "xla": "the TPU-only XLA two-pass backend is not ported (ROADMAP.md, "
           "'Do not port')",
}


def _default_impl(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "torch"


class DirectGravity:
    """O(N^2) direct-summation gravity bound to a particle population.

    ``precision='float32_fast'`` takes kernel F (r^2 expanded, its cross
    term on the tensor cores) as the base pass of the slab-sorted spline
    path (``impl='cuda'``, N >= 16384); elsewhere it runs as plain
    'float32' and warns.  ``target_drift`` below 1e-7 (``impl='cuda'``,
    not fast) sets ``fold_mass=False`` in ``tile_config`` unless the
    caller set it, as the TPU's does: the moment form, if asked for with
    ``mxu=True``, then keeps G m in the pair factor (kernel M unfolded).
    It does not turn the moment form on: the default VPU form keeps G m
    in the pair factor already, and on the H100 kernel M runs slower than
    it and has shown no drift gain over it (PERF.md).

    ``device`` is the card by default; without one it raises, naming
    ``device='cpu'``, the CPU option.  ``devices`` lists the ring's shards
    (``parallel.make_particle_mesh``; ``['cpu'] * 8`` for eight CPU
    shards): with more than one entry ``impl='auto'`` takes the ring, and
    ``impl='sharded'`` without it spans every visible card.
    ``sharded_opts`` forwards ``ShardedDirect`` keywords
    (``use_kernels``, ``mxu``) and needs the sharded impl.

    ``tile_config`` overrides the slab-sorted path's base pass: ``tm``
    (targets per band tile) and ``tn`` (sources per band row), positive
    multiples of 64; ``mxu`` (True: kernel M, the moment form on the
    tensor cores; the default None is the VPU form here, where the TPU
    defaults to its matrix unit) and ``fold_mass`` (False keeps G m in
    the pair factor).  ``max_sub`` (the TPU's VMEM superblocks) is
    accepted and ignored with a ``PerformanceWarning``.  Off the sorted
    path the overrides are ignored with a warning at the force call, as
    on the TPU."""

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
        devices=None,
        sharded_opts: dict | None = None,
    ):
        validate_kernel(kernel)
        validate_precision(precision)
        self.kernel = kernel
        self.precision = precision
        self.kahan = precision == "float32_kahan"
        self.fast = precision == "float32_fast"
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.G = float(G)
        self.eps2 = float(eps2)
        if impl in _NOT_PORTED:
            raise NotImplementedError(f"impl={impl!r}: {_NOT_PORTED[impl]}")
        if impl == "auto" and devices is not None and len(devices) > 1:
            impl = "sharded"
        self.devices = first = None
        if impl == "sharded":
            from ..parallel.sharded import make_particle_mesh

            self.devices = make_particle_mesh(devices)
            first = self.devices[0]
        elif devices is not None:
            if len(devices) > 1:
                raise ValueError(
                    f"devices= names {len(devices)} devices but "
                    f"impl={impl!r} runs on one; pass impl='sharded' or "
                    "'auto'")
            first = resolve_device(devices[0], indexed=True)
        if first is not None:
            if (device is not None
                    and resolve_device(device, indexed=True) != first):
                raise ValueError(f"device={device!r} is not the first of "
                                 f"devices={devices!r}")
            device = first
        if sharded_opts and impl != "sharded":
            raise ValueError(
                f"sharded_opts given but impl resolved to {impl!r}; pass "
                "impl='sharded' (impl='auto' only selects the sharded "
                "backend when devices= has more than one device)")
        self.device = resolve_device("cuda" if device is None else device)

        mass = pairwise._as_tensor(mass, self.dtype, self.device)
        softening = pairwise._as_tensor(softening, self.dtype, self.device)
        if mass.ndim == 0:
            raise ValueError("mass must be a per-particle array")
        n = mass.shape[0]

        if impl == "auto":
            impl = _default_impl(self.device)
        if impl not in ("torch", "cuda", "sharded"):
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

        if tile_config is not None:
            bad = set(tile_config) - _TILE_KEYS
            if bad:
                raise ValueError(f"unknown tile_config keys: {sorted(bad)}")
        if target_drift is not None:
            target_drift = float(target_drift)
            if not target_drift > 0.0:
                raise ValueError("target_drift must be a positive |dE/E| "
                                 f"bound (got {target_drift!r})")
            if (target_drift < _FOLD_MASS_DRIFT and impl == "cuda"
                    and not self.fast):
                tile_config = dict(tile_config or {})
                # an explicit user choice wins over the automatic one
                tile_config.setdefault("fold_mass", False)
        self.target_drift = target_drift

        self.tile_config = tile_config
        self._tile = {}
        if tile_config is not None:
            self._tile = {k: int(tile_config[k]) for k in ("tm", "tn")
                          if k in tile_config}
            self._tile.update({k: None if tile_config[k] is None
                               else bool(tile_config[k])
                               for k in ("mxu", "fold_mass")
                               if k in tile_config})
            cuda_direct._check_geometry(self._tile.get("tm", cuda_direct.TM),
                                        self._tile.get("tn", cuda_direct.TN))
            if "max_sub" in tile_config:
                from ..species import PerformanceWarning

                warnings.warn(
                    "tile_config key ['max_sub'] has no meaning for the "
                    "CUDA kernels and is ignored (max_sub: sources per TPU "
                    "grid step, VMEM superblocks)", PerformanceWarning,
                    stacklevel=2)

        if self.impl == "sharded":
            from ..parallel.sharded import ShardedDirect

            self._sharded = ShardedDirect(self, **(sharded_opts or {}))

        if self.fast:
            # the fast tier exists only on the slab-sorted spline path;
            # everywhere else it is plain float32: say so (the JAX
            # package's dispatch.py:233-258)
            if (self.impl != "cuda"
                    or not cuda_direct.uses_spatial_sort(kernel, n)):
                from ..species import PerformanceWarning

                why = (f"impl={self.impl!r}" if self.impl != "cuda"
                       else f"kernel={kernel!r}, N={n:,}")
                warnings.warn(
                    "precision='float32_fast' has its tier (kernel F) only "
                    "on the slab-sorted spline path (impl='cuda', "
                    f"kernel='spline', N >= {cuda_direct.SORT_MIN_N}); with "
                    f"{why} it runs as plain 'float32'", PerformanceWarning,
                    stacklevel=2)
            if tile_config is not None and tile_config.get("mxu") is False:
                raise ValueError(
                    "precision='float32_fast' builds r^2 on the moment "
                    "path; tile_config {'mxu': False} conflicts with it")

    def _check_pos(self, pos):
        if pos.ndim != 2 or tuple(pos.shape) != (self.n, 3):
            raise ValueError(
                f"pos shape {tuple(pos.shape)} does not match the solver's "
                f"({self.n}, 3) particle population")

    # -- backend dispatch ---------------------------------------------------
    def accel(self, pos):
        """Softened gravitational acceleration, (N, 3) in solver dtype."""
        self._check_pos(pos)
        pos = pos.to(self.dtype)
        if self.impl == "sharded":
            return self._sharded.accel(pos)
        if self.impl == "cuda":
            return cuda_direct.cuda_accel(
                pos, self.mass, self.softening, self.G, self.kernel,
                self.kahan, self.eps2, fast=self.fast, tile=self._tile)
        return pairwise._pairwise_blocked(
            pos, self.mass, self.softening, self.G, self.kernel, self.kahan,
            self.block_size, "acc", self.eps2)

    def potential(self, pos):
        """Softened gravitational potential per particle, (N,)."""
        self._check_pos(pos)
        pos = pos.to(self.dtype)
        if self.impl == "sharded":
            return self._sharded.potential(pos)
        if self.impl == "cuda":
            return cuda_direct.cuda_potential(
                pos, self.mass, self.softening, self.G, self.kernel,
                self.kahan, self.eps2, fast=self.fast, tile=self._tile)
        return pairwise._pairwise_blocked(
            pos, self.mass, self.softening, self.G, self.kernel, self.kahan,
            self.block_size, "pot", self.eps2)
