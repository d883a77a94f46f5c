"""Reference O(N^2) pairwise force / potential evaluation in plain torch.

Counterpart of ``nbody_streams_tpu/ops/pairwise.py``.  This is the port's
*oracle*: dtype-polymorphic (fp64 for validation, fp32 as the ``'torch'``
impl), device-agnostic, and the ground truth the CUDA kernels
(``ops/cuda_direct.py``) are tested against.

* The N^2 interaction matrix is never materialised at full size: targets
  and sources are processed in ``block_size`` blocks, so peak memory is
  O(block_size^2) regardless of N.
* r^2 is built from coordinate differences (never ``torch.cdist`` or the
  expanded |x|^2 + |y|^2 - 2 x.y form, which cancels for close pairs).
* Pair convention as the reference: softening ``h_eff = max(h_i, h_j)``,
  additive ``eps2 = 1e-15`` inside r^2, self-exclusion by global index.
* ``precision='float32_kahan'`` keeps within-block sums in fp32 and applies
  compensated (two-sum/Kahan) accumulation across source blocks.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..constants import (
    G_DEFAULT,
    PAIRWISE_EPS2,
    validate_kernel,
    validate_precision,
)
from .kernels import force_factor, potential_factor

__all__ = [
    "compute_forces_direct",
    "compute_potential_direct",
    "accel_tile",
    "potential_tile",
    "kahan_add",
]


def kahan_add(total, comp, delta):
    """One compensated (Kahan) accumulation step: returns (total', comp')."""
    y = delta - comp
    t = total + y
    comp = (t - total) - y
    return t, comp


# ---------------------------------------------------------------------------
# Tile primitives
# ---------------------------------------------------------------------------

def _pair_terms(pos_t, h_t, pos_s, h_s, eps2):
    dx = pos_s[None, :, 0] - pos_t[:, None, 0]
    dy = pos_s[None, :, 1] - pos_t[:, None, 1]
    dz = pos_s[None, :, 2] - pos_t[:, None, 2]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    h_eff = torch.maximum(h_t[:, None], h_s[None, :])
    return dx, dy, dz, r2, h_eff


def accel_tile(kind, pos_t, h_t, idx_t, pos_s, m_s, h_s, idx_s,
               eps2=PAIRWISE_EPS2):
    """Un-scaled acceleration of a target tile due to a source tile.

    pos_t (TM, 3), h_t/idx_t (TM,); pos_s (TN, 3), m_s/h_s/idx_s (TN,).
    Returns (TM, 3) sum over sources of ``m_j * w(r2, h_eff) * (x_j - x_i)``
    (the caller multiplies by G).  Self pairs (same global index) and
    padded sources (mass 0) contribute exactly zero."""
    dx, dy, dz, r2, h_eff = _pair_terms(pos_t, h_t, pos_s, h_s, eps2)
    w = force_factor(kind, r2, h_eff)
    not_self = (idx_t[:, None] != idx_s[None, :]).to(w.dtype)
    s = m_s[None, :] * w * not_self
    return torch.stack([(s * dx).sum(1), (s * dy).sum(1), (s * dz).sum(1)],
                       dim=-1)


def potential_tile(kind, pos_t, h_t, idx_t, pos_s, m_s, h_s, idx_s,
                   eps2=PAIRWISE_EPS2):
    """Un-scaled potential of a target tile due to a source tile: (TM,)."""
    _, _, _, r2, h_eff = _pair_terms(pos_t, h_t, pos_s, h_s, eps2)
    u = potential_factor(kind, r2, h_eff)
    not_self = (idx_t[:, None] != idx_s[None, :]).to(u.dtype)
    return (m_s[None, :] * u * not_self).sum(1)


# ---------------------------------------------------------------------------
# Full O(N^2) evaluation, blocked
# ---------------------------------------------------------------------------

def _choose_block(n):
    # Keep (B, B) tiles around a few MB; small problems use one block.
    b = 1 << max(4, min(11, math.ceil(math.log2(max(n, 2)))))
    return min(b, 2048)


def _pairwise_blocked(pos, mass, soft, G, kind, kahan, block_size, mode,
                      eps2):
    """Blocked all-pairs sum: targets in blocks, Kahan (optional) across
    source blocks.  Every argument tensor shares one dtype and device."""
    n = pos.shape[0]
    idx = torch.arange(n, device=pos.device)
    tile = accel_tile if mode == "acc" else potential_tile
    out = torch.empty((n, 3) if mode == "acc" else (n,), dtype=pos.dtype,
                      device=pos.device)
    for t0 in range(0, n, block_size):
        t1 = min(t0 + block_size, n)
        total = torch.zeros_like(out[t0:t1])
        comp = torch.zeros_like(total)
        for s0 in range(0, n, block_size):
            s1 = min(s0 + block_size, n)
            part = tile(kind, pos[t0:t1], soft[t0:t1], idx[t0:t1],
                        pos[s0:s1], mass[s0:s1], soft[s0:s1], idx[s0:s1],
                        eps2=eps2)
            if kahan:
                total, comp = kahan_add(total, comp, part)
            else:
                total = total + part
        out[t0:t1] = total
    return G * out


def _as_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _prepare(pos, mass, softening, precision, kernel, device):
    validate_kernel(kernel)
    validate_precision(precision)
    dtype = torch.float64 if precision == "float64" else torch.float32
    if device is not None:
        device = resolve_device(device)
    elif isinstance(pos, torch.Tensor):
        device = pos.device
    else:
        device = resolve_device("cuda")
    pos = _as_tensor(pos, dtype, device)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos must be (N, 3), got {tuple(pos.shape)}")
    n = pos.shape[0]
    mass = _as_tensor(mass, dtype, pos.device)
    if mass.ndim == 0:
        mass = mass.expand(n).contiguous()
    if mass.shape != (n,):
        raise ValueError(f"mass must be scalar or (N,), got "
                         f"{tuple(mass.shape)}")
    soft = _as_tensor(softening, dtype, pos.device)
    if soft.ndim == 0:
        soft = soft.expand(n).contiguous()
    if soft.shape != (n,):
        raise ValueError(
            f"softening must be scalar or (N,), got {tuple(soft.shape)}")
    return pos, mass, soft


def compute_forces_direct(
    pos,
    mass,
    softening=0.0,
    G: float = G_DEFAULT,
    kernel: str = "spline",
    precision: str = "float32_kahan",
    block_size: int | None = None,
    eps2: float = PAIRWISE_EPS2,
    device=None,
):
    """O(N^2) softened gravitational accelerations, plain-torch oracle.

    Inputs may be numpy arrays or tensors; the result is an (N, 3) tensor
    in the precision's dtype on ``device``.  By default a tensor ``pos``
    keeps its own device and other input goes to the card (raising
    without one; pass ``device='cpu'`` for the CPU).
    """
    pos, mass, soft = _prepare(pos, mass, softening, precision, kernel,
                               device)
    bs = block_size or _choose_block(pos.shape[0])
    return _pairwise_blocked(pos, mass, soft, float(G), kernel,
                             precision == "float32_kahan", bs, "acc",
                             float(eps2))


def compute_potential_direct(
    pos,
    mass,
    softening=0.0,
    G: float = G_DEFAULT,
    kernel: str = "spline",
    precision: str = "float32_kahan",
    block_size: int | None = None,
    eps2: float = PAIRWISE_EPS2,
    device=None,
):
    """O(N^2) softened gravitational potential per particle, shape (N,);
    ``device`` as in :func:`compute_forces_direct`."""
    pos, mass, soft = _prepare(pos, mass, softening, precision, kernel,
                               device)
    bs = block_size or _choose_block(pos.shape[0])
    return _pairwise_blocked(pos, mass, soft, float(G), kernel,
                             precision == "float32_kahan", bs, "pot",
                             float(eps2))
