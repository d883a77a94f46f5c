"""The card's published peaks and the work a force evaluation needs.

A frozen copy of the arithmetic of ``chip_smoke.bound`` with the
Newtonian pair counts: a pair of the direct sum costs 19 FP32 operations
(a subtraction per axis, the squared distance, one rsqrt and its cube, the
mass factor and a fused multiply-add per axis) and one rsqrt, so the least
time a pair can take on an H100 SXM is the larger of 19 / 67 TFLOP/s and
1 / (132 SMs x 16 MUFU lanes x 1.98 GHz).  The count is the same whatever
kernel does the work (the softened kernels do more, which is theirs to
win back), so a kernel that does less work for the same answer shows as a
higher share.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the full 700 W: FP32 outside the
#: tensor cores.
PEAK_FP32 = 67e12
#: MUFU rsqrt results a second: 132 SMs x 16 lanes x 1.98 GHz.
PEAK_MUFU = 132 * 16 * 1.98e9
#: FP32 operations and rsqrts a pair, Newtonian law.
PAIR_FLOPS = 19
PAIR_RSQRTS = 1


def pair_seconds() -> float:
    """The least time one pair can take on the card (2.836e-13 s)."""
    return max(PAIR_FLOPS / PEAK_FP32, PAIR_RSQRTS / PEAK_MUFU)


def evaluation_seconds(n: int) -> float:
    """The least time of one all-pairs force evaluation over ``n``
    particles: n^2 pairs (1.218 ms at n = 65,536)."""
    return float(n) * float(n) * pair_seconds()


def evaluation_flops(n: int) -> float:
    """The FP32 operations one evaluation needs, n^2 x 19."""
    return float(n) * float(n) * PAIR_FLOPS
