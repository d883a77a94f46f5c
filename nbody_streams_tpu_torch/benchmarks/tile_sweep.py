"""Single-card kernel headroom study.

    python -m nbody_streams_tpu_torch.benchmarks.tile_sweep \\
        roofline | sol [kind ...] | sweep64k | sweep1m  [--device DEV]

Counterpart of the repo's ``benchmarks/tile_sweep.py``:

1. ``sweep``: the band geometry (tm, tn) of the sorted two-pass path at
   N = 64k and 1M (spline + Kahan, the bench configuration), one
   precomputed slab order, so the kernels alone are timed.  The TPU's
   third axis, ``max_sub`` (sources per VMEM grid step), has no CUDA
   counterpart: a block stages 64 sources at a time whatever the geometry.
2. ``roofline``: the card's FP32 FMA and MUFU rsqrt rates on a
   (512, 512) float32 tile (``fma_chain_kernel``, ``rsqrt_chain_kernel``).
3. ``sol``: the speed of light of the exact pair arithmetic of the force
   kernels on a resident source tile (``tile_sol_kernel``), at the base
   pass's own launch shape (N / 64 = 1,024 blocks at N = 65,536) and at
   full occupancy (blocks that fill every SM).

Each measurement prints one JSON line that names its device, timed by
CUDA events on a CUDA device.  The device is ``cuda`` unless one is
named, and a CUDA device that torch cannot see raises; a CPU device is
named explicitly and runs the plain versions under the host clock, a CPU
number for tests.  The TPU-history modes (``mxu*``, ``refine*``,
``reuse64k``) are not ported.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import cuda_direct as cd
from ..ops import roofline as rl
from ..ops.probe import probe_tile, time_call

#: Geometries of sweep64k: the default 512/512 and its neighbours.
GEOMS_64K = [(512, 512), (256, 512), (128, 512), (512, 256), (256, 256),
             (512, 1024), (128, 128)]
GEOMS_1M = [(512, 512), (256, 512), (512, 1024)]
#: Base pass launch shape at the bench case: N / BLOCK blocks.
BASE_BLOCKS = 65536 // cd.BLOCK


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the tile sweep measures a CUDA device and torch "
                           "sees none; name device='cpu' for the plain "
                           "versions")
    return device


def _emit(device, record):
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    record = dict(record, device=name)
    print(json.dumps(record), flush=True)
    return record


def sweep(n, iters, geoms, device="cuda"):
    """Time ``_self_sorted`` (spline, Kahan, acc) per (tm, tn) at ``n``
    particles over ``iters`` calls each.  Returns ``{(tm, tn): record}``
    with ``ms_per_eval``, ``gint_per_s``, the ``branch`` taken and the
    accelerations ``acc`` (in the particles' order)."""
    device = _device(device)
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.tensor(rng.normal(0, 1.0, (n, 3)), **f32)
    gm = torch.tensor(rng.uniform(0.5, 1.5, n) * 4.3e-6, **f32)
    h = torch.full((n,), 0.05, **f32)
    # one precomputed slab order: stepping amortises the argsort (the
    # integrator refreshes it once per step), so the sweep times the
    # kernels and the band bookkeeping alone
    order = cd.slab_sort_key(pos)
    results = {}
    for tm, tn in geoms:
        def force(tm=tm, tn=tn):
            return cd._self_sorted(pos, gm, h, "spline", True, "acc", 1e-15,
                                   tm=tm, tn=tn, order=order)

        before = dict(cd.BRANCHES)
        acc = force()
        branch = next(k for k in cd.BRANCHES if cd.BRANCHES[k] > before[k])
        dt = time_call(force, device, iters)
        record = _emit(device, {"metric": "tile_sweep", "n": n, "tm": tm, "tn": tn,
                        "branch": branch, "ms_per_eval": dt * 1e3,
                        "gint_per_s": n * n / dt / 1e9})
        results[(tm, tn)] = dict(record, acc=acc)
    return results


def roofline(device="cuda", K=512, passes=5120, reps=3):
    """FP32 fma and MUFU rsqrt throughput on a (512, 512) float32 tile:
    ``passes`` passes of ``K`` links per element (the TPU's grid 256 x 20
    scans of K = 512 by default).  Returns ``{"fma": record, "rsqrt":
    record}`` with ``g_ops_per_s``, ``g_lanes_per_s`` and ``ms``."""
    device = _device(device)
    x = probe_tile(device)
    lanes = x.numel() * K * passes
    out = {}
    for name, fn, ops_per_link in (("fma", rl.fma_chain, 2),
                                   ("rsqrt", rl.rsqrt_chain, 1)):
        y = fn(x, K, passes)
        if not torch.isfinite(y).all():
            raise RuntimeError(f"{name} chain is not finite")
        dt = time_call(lambda f=fn: f(x, K, passes), device, reps)
        out[name] = _emit(device, {
            "metric": f"fp32_{name}_throughput", "K": K, "passes": passes,
            "g_ops_per_s": lanes * ops_per_link / dt / 1e9,
            "g_lanes_per_s": lanes / dt / 1e9, "ms": dt * 1e3})
    return out


def sol_operands(kind, nt, ns, device, seed=3):
    """Random targets (4, nt) and sources (5, ns) in the kernels' layout,
    h = 0.05 (1/h = 20 as the TPU's sol)."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    pt = torch.tensor(rng.normal(0, 1, (nt, 3)), **f32)
    ps = torch.tensor(rng.normal(0, 1, (ns, 3)), **f32)
    gm = torch.tensor(rng.uniform(0.5, 1.5, ns), **f32)
    pre_t = cd._soft_pre(kind, torch.full((nt,), 0.05, **f32))
    pre_s = cd._soft_pre(kind, torch.full((ns,), 0.05, **f32))
    return cd._targets(pt, pre_t), cd._sources(ps, gm, pre_s, cd.BLOCK)


def sol(kind="spline", blocks=None, reps=1024, device="cuda",
        timing_reps=3):
    """Pair-arithmetic speed of light: ``tile_sol_kernel`` over ``blocks``
    blocks (default: full occupancy) of 64 targets, each against one
    resident tile of 64 sources, ``reps`` passes.  pairs/s here bounds
    ``direct_tile_kernel`` (newtonian: the base pass; spline: the band
    and single passes) at the same launch shape."""
    device = _device(device)
    if blocks is None:
        blocks = rl.tile_sol_blocks(kind, device)
    tgt, src = sol_operands(kind, blocks * cd.BLOCK, 64 * cd.BLOCK, device)
    y = rl.tile_sol(tgt, src, kind, blocks, reps)
    if not torch.isfinite(y).all():
        raise RuntimeError(f"tile_sol {kind} is not finite")
    dt = time_call(lambda: rl.tile_sol(tgt, src, kind, blocks, reps), device,
                   timing_reps)
    pairs = blocks * cd.BLOCK * cd.BLOCK * reps
    return _emit(device, {"metric": f"{kind}_kahan_arith_speed_of_light",
                  "blocks": blocks, "reps": reps,
                  "g_pairs_per_s": pairs / dt / 1e9, "ms": dt * 1e3})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="roofline")
    ap.add_argument("kinds", nargs="*", default=["newtonian", "spline"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mode, dev = args.mode, args.device
    if mode == "roofline":
        roofline(dev)
    elif mode == "sol":
        for kind in args.kinds:
            sol(kind, BASE_BLOCKS, device=dev)
            sol(kind, device=dev)
    elif mode == "sweep64k":
        sweep(65536, 50, GEOMS_64K, dev)
    elif mode == "sweep1m":
        sweep(1_048_576, 2, GEOMS_1M, dev)
    else:
        raise SystemExit(f"unknown mode {mode!r}: roofline | sol [kind ...] "
                         "| sweep64k | sweep1m")


if __name__ == "__main__":
    main()
