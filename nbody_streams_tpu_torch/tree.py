"""Drop-in surface of the reference's ``tree_gpu`` tier.

Counterpart of ``nbody_streams_tpu/tree.py``.  The reference ships a
Barnes-Hut CUDA treecode exposed as ``TreeGPU`` / ``tree_gravity_gpu`` /
``run_nbody_gpu_tree``.  Here, as in the JAX package, the tree tier is the
*exact* direct sum: on one card ``DirectGravity(kernel='plummer',
precision='float32_kahan')``, the hand-written CUDA kernel's single pass.

The tree approximation knobs (``theta``, ``nleaf``, ``ncrit``,
``level_split``) are accepted and ignored — forces are exact, which is
more accurate than any setting of them (warned once per process).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .constants import G_DEFAULT
from .ops.dispatch import DirectGravity

__all__ = ["TreeGPU", "tree_gravity_gpu", "run_nbody_gpu_tree"]

_warned = False


def _note_exact(theta):
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(
            "the tree tier is exact direct summation; theta/nleaf/ncrit/"
            f"level_split are ignored (theta={theta} requested, force "
            "error is 0 instead of the reference tree's 1-5%)",
            stacklevel=3)


class TreeGPU:
    """Reusable solver handle (the reference's ``TreeGPU``).

    The reference pre-allocates device buffers to save their malloc/free
    per step; here the analogue is caching the solver (its mass and
    softening on the card) so repeated calls with the same (mass, eps, G)
    skip rebuilding it.  ``device`` is the card unless the caller passes
    ``device='cpu'``."""

    def __init__(self, n: int, eps: float = 0.05, theta: float = 0.6,
                 device="cuda", **_ignored):
        self.n = int(n)
        self.eps = eps
        self.theta = theta
        self.device = device
        self._solver = None
        self._key = None

    def _get_solver(self, mass, eps, G):
        mass = np.asarray(mass, np.float32)
        eps = np.asarray(eps, np.float32)
        key = (mass.tobytes(), eps.tobytes(), float(G))
        if self._key != key:
            self._solver = DirectGravity(mass, eps, G=G, kernel="plummer",
                                         precision="float32_kahan",
                                         impl="auto", device=self.device)
            self._key = key
        return self._solver


def tree_gravity_gpu(pos, mass, eps=None, G: float = G_DEFAULT,
                     theta: float = 0.6, nleaf: int = 64, ncrit: int = 64,
                     level_split: int = 5, verbose: bool = False,
                     tree: TreeGPU | None = None, device="cuda"):
    """(acc, phi) for all particles (the reference's ``tree_gravity_gpu``),
    computed exactly on ``device`` (a given ``tree`` handle's device).

    Plummer softening with the per-particle ``eps`` max-pair rule (the
    reference tree supports only Plummer).  Returns float32 numpy ``acc``
    (N, 3) and ``phi`` (N,) in input order.
    """
    pos = np.asarray(pos, np.float32)
    n = pos.shape[0]
    if eps is None:                    # fall back to the handle's eps
        eps = tree.eps if tree is not None else 0.05
    eps_arr = np.broadcast_to(np.asarray(eps, np.float32), (n,))
    # scalar (shared) mass is part of the reference surface too
    mass = np.broadcast_to(np.asarray(mass, np.float32), (n,))
    del verbose              # reference CUDA-timing chatter: no analogue
    _note_exact(theta)
    handle = tree if tree is not None else TreeGPU(n, device=device)
    solver = handle._get_solver(mass, eps_arr, G)
    x = torch.as_tensor(pos, device=solver.device)
    acc = solver.accel(x)
    phi = solver.potential(x)
    return acc.cpu().numpy(), phi.cpu().numpy()


def run_nbody_gpu_tree(phase_space, masses, time_start, time_end, dt,
                       softening=0.05, G: float = G_DEFAULT,
                       theta: float = 0.6, nleaf: int = 64, ncrit: int = 64,
                       level_split: int = 5, **kwargs):
    """KDK integration through the tree tier's backend (the reference's
    ``run_nbody_gpu_tree``): ``run_nbody`` with the Plummer kernel by
    default, on the card unless ``architecture='cpu'`` is passed.  All
    ``run_nbody`` keywords (snapshots, restart, ``step_timeout_s``,
    external potentials, ``force_extra``, ``profile_dir`` ...) pass
    through."""
    from .run import run_nbody

    _note_exact(theta)
    kwargs.setdefault("kernel", "plummer")  # the reference tree's kernel
    return run_nbody(phase_space, masses, time_start, time_end, dt,
                     softening=softening, G=G, **kwargs)
