"""The softened all-pairs acceleration at chosen targets, float64 torch.

Pair convention of the direct sum under test: softening h = max(h_i, h_j)
with the Monaghan (1992) cubic spline of support h (exactly Newtonian for
r >= h); a target is not its own source.
"""
from __future__ import annotations

import torch


def spline_factor(r2, h):
    """w with a_i += G m_j w (x_j - x_i): 1/r^3 for r >= h, the cubic
    spline's force over r inside, in terms of q = r / h."""
    r = torch.sqrt(r2)
    q = r / h
    inner = (32.0 / 3.0 + q * q * (32.0 * q - 38.4)) / h ** 3
    outer = (64.0 / 3.0 - 48.0 * q + 38.4 * q * q - 32.0 / 3.0 * q ** 3
             - 1.0 / (15.0 * q ** 3)) / h ** 3
    soft = torch.where(q < 0.5, inner, outer)
    return torch.where(r >= h, 1.0 / (r2 * r), soft)


def accel(tgt_pos, tgt_soft, tgt_index, src_pos, src_mass, src_soft, G,
          elements: int = 1 << 25):
    """(S, 3) accelerations at ``tgt_pos`` (S, 3) from every source, the
    source whose index equals ``tgt_index`` left out; blocks of targets
    hold about ``elements`` pairs at a time."""
    n = src_pos.shape[0]
    block = max(1, elements // n)
    idx = torch.arange(n, device=src_pos.device)
    out = torch.empty_like(tgt_pos)
    for i0 in range(0, tgt_pos.shape[0], block):
        t = tgt_pos[i0:i0 + block]
        d = src_pos[None, :, :] - t[:, None, :]
        r2 = (d * d).sum(-1)
        h = torch.maximum(tgt_soft[i0:i0 + block, None], src_soft[None, :])
        self_pair = idx[None, :] == tgt_index[i0:i0 + block, None]
        r2 = torch.where(self_pair, torch.ones_like(r2), r2)
        w = spline_factor(r2, h) * src_mass[None, :]
        w = torch.where(self_pair, torch.zeros_like(w), w)
        out[i0:i0 + block] = G * (w[:, :, None] * d).sum(1)
    return out
