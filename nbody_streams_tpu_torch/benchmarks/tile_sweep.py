"""Single-card kernel headroom study.

    python -m nbody_streams_tpu_torch.benchmarks.tile_sweep \\
        roofline | sol [kind ...] | solmxu | moment | sweep64k | sweep1m
        | splits [--device DEV]

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
   full occupancy (blocks that fill every SM).  ``solmxu``: the moment
   tile's (``tile_sol_moment_kernel``, kernel M's step loop; Newtonian)
   beside the spline force tile, each at both shapes, as the TPU's
   ``solmxu`` mode sets the moment base pass beside the band pass.
4. ``moment``: the tensor-core forms of the base pass at the bench case
   (kernels M folded and unfolded, F acc and pot, each against its plain
   version), M's two-set form at the ring's D = 4 far tile, row 1 and
   row 2's Newtonian tile at the same operands, and the moment tile's
   speed of light at the base pass's shape and at full occupancy.
5. ``splits``: the base and band passes alone at N = 16k to 256k
   for forced source-stream split counts S and for the S that
   ``split_count`` picks, with the default geometry.

Each measurement prints one JSON line that names its device, timed by
CUDA events on a CUDA device.  The device is ``cuda`` unless one is
named, and a CUDA device that torch cannot see raises; a CPU device is
named explicitly and runs the plain versions under the host clock, a CPU
number for tests.  The TPU-history modes (``mxu``, ``mxu2``, ``mxu3``,
``refine64k``, ``reuse64k``) are not ported.
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
#: Split counts of the ``splits`` mode per N (None: the wrappers' own).
SPLIT_SWEEP = {16384: [None, 1, 4, 8, 12, 16, 20, 24],
               65536: [None, 1, 2, 4, 6, 8, 9, 10, 12, 16],
               131072: [None, 1, 2, 4, 6, 8],
               262144: [None, 1, 2, 3, 4, 6]}
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
        branch = next(k for k in ("two_pass", "single_pass")
                      if cd.BRANCHES[k] > before[k])
        dt = time_call(force, device, iters)
        record = _emit(device, {"metric": "tile_sweep", "n": n, "tm": tm, "tn": tn,
                        "branch": branch, "ms_per_eval": dt * 1e3,
                        "gint_per_s": n * n / dt / 1e9})
        results[(tm, tn)] = dict(record, acc=acc)
    return results


def split_sweep(n, counts, iters, device="cuda"):
    """Time the base pass and the band pass of the sorted path at ``n``
    particles (the sweep's cloud, one slab order) for each split count in
    ``counts``, None being the wrappers' own choice.  Returns the records:
    ``kernel``, ``splits`` (the S used, or "auto" on the CPU), ``ms``,
    ``g_pairs_per_s``."""
    device = _device(device)
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.tensor(rng.normal(0, 1.0, (n, 3)), **f32)
    gm = torch.tensor(rng.uniform(0.5, 1.5, n) * 4.3e-6, **f32)
    h = torch.full((n,), 0.05, **f32)
    ps = pos[cd.slab_sort_key(pos)]
    hinv = cd._soft_pre("spline", h)
    first, width, rows = cd.band_window(ps[:, 0], h.max())
    nb = cd.band_rows(rows)
    if int(width) > nb:
        raise RuntimeError(f"band window {int(width)} > {nb} rows at n={n}")
    start = first.clamp(0, rows - nb).to(torch.int32).contiguous()
    tgt, src = cd._targets(ps, hinv), cd._sources(ps, gm, hinv, cd.TN)
    ns = src.shape[1]
    passes = {
        "direct": (n * (ns - nb * cd.TN), lambda s: cd._direct_tile(
            tgt, src, "newtonian", "acc", True, 1e-15, False, nb, start,
            splits=s)),
        "band": (n * nb * cd.TN, lambda s: cd._band(
            tgt, src, start, "acc", True, 1e-15, False, cd.TM, cd.TN, nb,
            splits=s))}
    records = []
    for kernel, (pairs, run) in passes.items():
        for splits in counts:
            if splits is None and device.type == "cuda":
                sms = torch.cuda.get_device_properties(
                    device).multi_processor_count
                splits = cd.split_count(kernel, n, ns, sms, nb, cd.TN)
            dt = time_call(lambda s=splits: run(s), device, iters)
            records.append(_emit(device, {
                "metric": "split_sweep", "kernel": kernel, "n": n,
                "nb": nb, "splits": splits or "auto",
                "blocks": -(-n // cd.BLOCK) * (splits or 1),
                "ms": dt * 1e3, "g_pairs_per_s": pairs / dt / 1e9}))
    return records


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
        timing_reps=3, mxu=False):
    """Pair-arithmetic speed of light: ``tile_sol_kernel`` over ``blocks``
    blocks (default: full occupancy) of 64 targets, each against one
    resident tile of 64 sources, ``reps`` passes.  pairs/s here bounds
    ``direct_tile_kernel`` (newtonian: the base pass; spline: the band
    and single passes) at the same launch shape.  With ``mxu`` the moment
    tile (``tile_sol_moment_kernel``, Newtonian only): it bounds kernel M
    (``moment_tile_kernel``, the base pass with ``tile_config={'mxu':
    True}``)."""
    device = _device(device)
    if blocks is None:
        blocks = rl.tile_sol_blocks(kind, device, mxu)
    tgt, src = sol_operands(kind, blocks * cd.BLOCK, 64 * cd.BLOCK, device)
    y = rl.tile_sol(tgt, src, kind, blocks, reps, mxu=mxu)
    if not torch.isfinite(y).all():
        raise RuntimeError(f"tile_sol {kind} mxu={mxu} is not finite")
    dt = time_call(lambda: rl.tile_sol(tgt, src, kind, blocks, reps,
                                       mxu=mxu), device, timing_reps)
    pairs = blocks * cd.BLOCK * cd.BLOCK * reps
    return _emit(device, {"metric": f"{kind}_kahan_arith_speed_of_light",
                  "mxu": mxu, "blocks": blocks, "reps": reps,
                  "g_pairs_per_s": pairs / dt / 1e9, "ms": dt * 1e3})


#: Kernel M and F forms of ``moment``: (mode, fold_mass, fast).
MOMENT_FORMS = {"fold": ("acc", True, False), "unfold": ("acc", False, False),
                "fast": ("acc", True, True), "fast_pot": ("pot", True, True)}


def moment_forms(n=65536, iters=30, device="cuda", sol_reps=1024):
    """Time the tensor-core forms at the bench case (N = ``n`` Plummer,
    seed 2, spline h = 0.05, slab-sorted and centred as the sorted path
    hands them to the base pass): kernels M and F (``MOMENT_FORMS``) each
    with ``rel``, max |kernel - plain| / max |plain| at the kernel's S;
    M's two-set form at the ring's D = 4 far tile (shard 1's targets
    against shard 3's sources); row 1 and row 2's Newtonian tile on the
    same operands; tile_sol_moment at the base pass's shape (N / 64 x S
    blocks) and, on a card, at full occupancy.  One JSON line each;
    returns the records by name."""
    from .. import make_plummer_sphere
    from ..parallel.sharded import slab_sort_for_sharding

    device = _device(device)
    f32 = dict(dtype=torch.float32, device=device)
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    gm_all = torch.tensor(m * 4.300917270069976e-06, **f32)
    pos = torch.tensor(xv[:, :3], **f32)
    order = cd.slab_sort_key(pos)
    ps = pos[order] - pos[order].mean(0, keepdim=True)
    h = torch.full((n,), 0.05, **f32)
    hinv = cd._soft_pre("spline", h)
    first, _, rows = cd.band_window(ps[:, 0], h.max())
    nb = cd.band_rows(rows)
    start = first.clamp(0, rows - nb).to(torch.int32).contiguous()
    tgt, src = cd._targets(ps, hinv), cd._sources(ps, gm_all[order], hinv,
                                                  cd.TN)
    ns = src.shape[1]
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 1)
    splits = cd.split_count("direct", n, ns, sms, nb, cd.TN)
    pairs = n * (ns - nb * cd.TN)
    out = {}

    def emit(name, fn, pairs, ref=None, **extra):
        rel = None
        if ref is not None:
            got, want = fn(), ref()
            diff = (got.double() - want.double()).abs().max()
            scale = want.double().abs().max()
            rel = (diff / scale if scale > 0 else diff).item()
        dt = time_call(fn, device, iters)
        out[name] = _emit(device, {"metric": "moment_forms", "form": name,
                                   "n": n, "ms": dt * 1e3, "rel": rel,
                                   "g_pairs_per_s": pairs / dt / 1e9,
                                   **extra})

    for name, (mode, fold, fast) in MOMENT_FORMS.items():
        args = (tgt, src, "newtonian", mode, True, 1e-15, fold, fast)
        emit(name, lambda a=args: cd._moment_tile(
                 *a, nb=nb, start=start, splits=splits), pairs,
             lambda a=args: cd._moment_tile_reference(
                 *a, nb=nb, start=start, splits=splits), splits=splits)
    emit("row1", lambda: cd._direct_tile(tgt, src, "newtonian", "acc", True,
                                         1e-15, False, nb, start,
                                         splits=splits), pairs,
         splits=splits)
    # the ring's far tile at D = 4: shard 1 against shard 3, Newtonian
    xs, ms_ = slab_sort_for_sharding(xv, m)
    pr = torch.tensor(xs[:, :3], **f32)
    pr = pr - pr.mean(0, keepdim=True)
    gr = torch.tensor(ms_ * 4.300917270069976e-06, **f32)
    pre = cd._soft_pre("newtonian", h)
    nl = n // 4
    t2 = cd._targets(pr[nl:2 * nl], pre[nl:2 * nl])
    s2 = cd._sources(pr[3 * nl:], gr[3 * nl:], pre[3 * nl:], cd.BLOCK)
    splits2 = cd.split_count("direct", nl, s2.shape[1], sms)
    args = (t2, s2, "newtonian", "acc", True, 1e-15)
    emit("2m", lambda: cd._moment_tile(*args, splits=splits2),
         nl * s2.shape[1],
         lambda: cd._moment_tile_reference(*args, splits=splits2),
         splits=splits2)
    emit("row2_newtonian_tile", lambda: cd._direct_tile(
        *args, splits=splits2), nl * s2.shape[1], splits=splits2)
    shapes = {"7m_base": n // cd.BLOCK * splits}
    if device.type == "cuda":
        shapes["7m_full"] = None
    for name, blocks in shapes.items():
        r = sol("newtonian", blocks, sol_reps, device, 3, mxu=True)
        out[name] = r
    return out


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
    elif mode == "solmxu":
        # the moment tile (kernel M's ceiling) beside the spline force
        # tile (the band pass's), each at the base pass's shape and full
        for kind, mxu in (("newtonian", True), ("spline", False)):
            sol(kind, BASE_BLOCKS, device=dev, mxu=mxu)
            sol(kind, device=dev, mxu=mxu)
    elif mode == "moment":
        moment_forms(device=dev)
    elif mode == "sweep64k":
        sweep(65536, 50, GEOMS_64K, dev)
    elif mode == "sweep1m":
        sweep(1_048_576, 2, GEOMS_1M, dev)
    elif mode == "splits":
        for n, counts in SPLIT_SWEEP.items():
            split_sweep(n, counts, 30, dev)
    else:
        raise SystemExit(f"unknown mode {mode!r}: roofline | sol [kind ...] "
                         "| solmxu | moment | sweep64k | sweep1m | splits")


if __name__ == "__main__":
    main()
