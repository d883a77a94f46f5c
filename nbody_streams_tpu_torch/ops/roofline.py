"""Roofline kernels: the card's FP32 FMA and MUFU rsqrt rates, and the
speed of light of the force tile.

Counterpart of the TPU's measurement kernels.  Three kernels in
``csrc/roofline.cu``:

* ``fma_chain_kernel`` (``fma_chain``): ``acc = fmaf(acc, v, v)`` chains,
  replacing the fma chains of ``ops/probe.py::delivered_pallas_tops``,
  ``bench.py::_capacity_probe`` and ``benchmarks/tile_sweep.py::roofline``;
* ``rsqrt_chain_kernel`` (``rsqrt_chain``): ``acc = rsqrt(acc + v)``
  chains, the rsqrt half of ``roofline``;
* ``tile_sol_kernel`` (``tile_sol``): the exact pair arithmetic of
  ``direct_tile_kernel`` (acc mode, Kahan across passes) on one source
  tile resident in shared memory, replacing ``tile_sweep.py::sol``.

A chain runs, for every element ``x`` of its input, ``passes`` passes of
``CHAINS`` independent chains of ``K // CHAINS`` links each, chain ``c``
starting at ``v + c``; after each pass ``v = x + total * NUDGE`` (the
element nudged by the pass's total, so no pass can be hoisted or
deleted), and the result is the sum of the pass totals.  Each launch does
``x.numel() * K * passes`` links.  On the probe tile the chains reach
their fixed point within ~25 links, so a check that should see every
link runs at a K below that (K = 16).

Beside each wrapper is its plain torch version (``_fma_chain_reference``,
``_rsqrt_chain_reference``, ``_tile_sol_reference``).  A wrapper runs the
plain version only for tensors on the CPU; for a CUDA tensor it launches
the kernel or raises.  ``LAUNCHES`` counts kernel launches.  The kernel
contracts ``acc * v + v`` into one FFMA; the plain version rounds as
torch does on its device, so the two agree to a stated tolerance, not
bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from ..constants import KERNEL_IDS
from . import cuda_direct as cd
from .pairwise import kahan_add

__all__ = ["fma_chain", "rsqrt_chain", "tile_sol", "tile_sol_blocks",
           "CHAINS", "LAUNCHES"]

#: Independent chains per thread (csrc/roofline.cu refuses any other).
CHAINS = 4
#: Scale of the nudge that carries one pass into the next.
NUDGE = 1e-30
#: Kernel launches, counted by the wrappers where they launch (plain ints).
LAUNCHES = {"fma_chain": 0, "rsqrt_chain": 0, "tile_sol": 0}

_SOL_KINDS = ("newtonian", "spline")


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# fma_chain_kernel, rsqrt_chain_kernel and their plain versions
# ---------------------------------------------------------------------------

def _chain_reference(x, K, passes, link):
    offsets = torch.arange(CHAINS, dtype=x.dtype, device=x.device)
    offsets = offsets.reshape(CHAINS, *([1] * x.ndim))
    v = x
    out = torch.zeros_like(x)
    for _ in range(passes):
        acc = v + offsets
        for _ in range(K // CHAINS):
            acc = link(acc, v)
        total = acc[0]
        for c in range(1, CHAINS):
            total = total + acc[c]
        v = x + total * NUDGE
        out = out + total
    return out


def _fma_chain_reference(x, K, passes):
    """Plain torch version of ``fma_chain_kernel``."""
    return _chain_reference(x, K, passes,
                            lambda acc, v: torch.addcmul(v, acc, v))


def _rsqrt_chain_reference(x, K, passes):
    """Plain torch version of ``rsqrt_chain_kernel``."""
    return _chain_reference(x, K, passes,
                            lambda acc, v: torch.rsqrt(acc + v))


def _check_chain(x, K, passes):
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"x must be a non-empty contiguous float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"x has {x.numel()} elements; the kernel indexes "
                         "with 32-bit ints")
    if K < CHAINS or K % CHAINS or passes < 1:
        raise ValueError(f"K={K} must be a positive multiple of {CHAINS} "
                         f"and passes={passes} positive")


def _chain(name, x, K, passes, reference):
    _check_chain(x, K, passes)
    if not x.is_cuda:
        return reference(x, K, passes)
    from . import _build

    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = getattr(cd._kernel_lib(), f"nbody_{name}")(
            x.data_ptr(), x.numel(), CHAINS, K // CHAINS, passes,
            out.data_ptr(), _stream())
    _build.check(rc, f"{name}_kernel")
    LAUNCHES[name] += 1
    return out


def fma_chain(x, K, passes):
    """``passes`` passes of ``K`` fma links per element of float32 ``x``
    (2 ops a link) through ``fma_chain_kernel``; same shape as ``x``."""
    return _chain("fma_chain", x, K, passes, _fma_chain_reference)


def rsqrt_chain(x, K, passes):
    """``passes`` passes of ``K`` rsqrt links per element of float32 ``x``
    (one MUFU rsqrt and one add a link) through ``rsqrt_chain_kernel``."""
    return _chain("rsqrt_chain", x, K, passes, _rsqrt_chain_reference)


# ---------------------------------------------------------------------------
# tile_sol_kernel and its plain version
# ---------------------------------------------------------------------------

def _tile_sol_reference(tgt, src, kind, blocks, reps, eps2=1e-15):
    """Plain torch version of ``tile_sol_kernel``: block ``b``'s targets
    ``(b * BLOCK + lane) % nt`` against source tile ``b % (ns / BLOCK)``,
    ``reps`` passes of the pair sum with a Kahan step after each and the
    target nudged by the running total; (blocks * BLOCK, 3)."""
    nt, ns = tgt.shape[1], src.shape[1]
    dev = tgt.device
    g = torch.arange(blocks * cd.BLOCK, device=dev)
    i = g % nt
    lane = torch.arange(cd.BLOCK, device=dev)[None, :]
    j = ((g // cd.BLOCK) % (ns // cd.BLOCK) * cd.BLOCK)[:, None] + lane
    sources = [src[k][j] for k in range(5)]
    x0, y0, z0, pt = (tgt[k][i][:, None] for k in range(4))
    xt, yt, zt = x0, y0, z0
    total = torch.zeros((g.shape[0], 3), dtype=tgt.dtype, device=dev)
    comp = torch.zeros_like(total)
    for _ in range(reps):
        part = cd._pair_sum(kind, "acc", eps2, xt, yt, zt, pt, *sources)
        total, comp = kahan_add(total, comp, part)
        xt = x0 + total[:, 0:1] * NUDGE
        yt = y0 + total[:, 1:2] * NUDGE
        zt = z0 + total[:, 2:3] * NUDGE
    return total


def _check_sol(tgt, src, kind, blocks, reps):
    if kind not in _SOL_KINDS:
        raise ValueError(f"tile_sol kind must be one of {_SOL_KINDS}, "
                         f"got {kind!r}")
    for name, t, rows in (("tgt", tgt, 4), ("src", src, 5)):
        if (t.dtype != torch.float32 or t.ndim != 2 or t.shape[0] != rows
                or t.shape[1] == 0 or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"({rows}, n) tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if src.device != tgt.device:
        raise ValueError("tgt and src must be on one device")
    if src.shape[1] % cd.BLOCK:
        raise ValueError(f"source count {src.shape[1]} must be a multiple "
                         f"of {cd.BLOCK}")
    if blocks < 1 or reps < 1 or blocks * cd.BLOCK * 3 >= 2**31:
        raise ValueError(f"blocks={blocks} and reps={reps} must be positive "
                         "(and the output under 2**31 floats)")


def tile_sol(tgt, src, kind, blocks, reps, eps2=1e-15):
    """Speed of light of the force tile through ``tile_sol_kernel``:
    ``blocks`` blocks of ``BLOCK`` targets of ``tgt`` (4, nt), each
    against one resident tile of ``src`` (5, ns), ``reps`` passes;
    (blocks * BLOCK, 3).  Divided by ``reps`` it is each target's
    acceleration (times 1/G) from its block's source tile."""
    _check_sol(tgt, src, kind, blocks, reps)
    if not tgt.is_cuda:
        return _tile_sol_reference(tgt, src, kind, blocks, reps, eps2)
    from . import _build

    out = torch.empty((blocks * cd.BLOCK, 3), dtype=torch.float32,
                      device=tgt.device)
    with torch.cuda.device(tgt.device):
        rc = cd._kernel_lib().nbody_tile_sol(
            KERNEL_IDS[kind], tgt.data_ptr(), tgt.shape[1], src.data_ptr(),
            src.shape[1], blocks, reps, float(eps2), out.data_ptr(),
            _stream())
    _build.check(rc, "tile_sol_kernel")
    LAUNCHES["tile_sol"] += 1
    return out


def tile_sol_blocks(kind, device):
    """Blocks of ``tile_sol_kernel`` that fill every SM of a CUDA device
    at its full occupancy (SM count x resident blocks per SM)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("full occupancy is a property of a CUDA device; "
                         f"got {device}")
    if kind not in _SOL_KINDS:
        raise ValueError(f"kind must be one of {_SOL_KINDS}, got {kind!r}")
    from . import _build

    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = cd._kernel_lib().nbody_tile_sol_occupancy(KERNEL_IDS[kind],
                                             ctypes.byref(per_sm))
    _build.check(rc, "tile_sol_kernel occupancy")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * per_sm.value
