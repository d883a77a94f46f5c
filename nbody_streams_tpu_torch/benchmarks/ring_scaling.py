"""Ring scaling on virtual shards of one device.

Counterpart of the repo-root ``benchmarks/ring_scaling.py``, which times
the JAX ring on the 8-device virtual CPU mesh.  Here the D shards are
virtual shards of one device (the card by default): every tile runs on the
same silicon whatever D is, so t(D) against t(1) is what the ring adds or
saves an evaluation: D^2 tiles instead of one, D - 1 block copies a shard,
the Kahan adds across steps, and, for the spline on slab-sorted input, the
far blocks that take the Newtonian law.

    python -m nbody_streams_tpu_torch.benchmarks.ring_scaling \\
        [--device cuda] [-N 65536] [--per-shard 16384] [--reps 5]

Prints the strong-scaling table (fixed N; D = 1, 2, 4, 8) and the
weak-scaling table (fixed N/D): for each D the ms an evaluation (host
clock after a device synchronize, best of ``--reps``), the kernel launches
an evaluation (``cuda_direct.LAUNCHES``) and the far tiles out of D^2
(``parallel.sharded.TILES``).  The bench case's particles (Plummer, seed
2, spline h = 0.05, float32_kahan), slab-sorted before sharding.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device

DS = (1, 2, 4, 8)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_ms(fn, device, reps=5):
    """Best of ``reps`` calls of ``fn`` in ms, host clock after a device
    synchronize, after one warm-up call."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def eval_row(n, d, device, reps=5):
    """One D: the ring over ``[device] * d`` at N = ``n``; a dict of
    ``D, N, ms, launches, far, tiles``."""
    from .. import make_plummer_sphere
    from ..ops import cuda_direct
    from ..ops.dispatch import DirectGravity
    from ..parallel.sharded import TILES, slab_sort_for_sharding

    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    soft = np.full(n, 0.05)
    xv, m, soft = slab_sort_for_sharding(xv, m, soft)
    solver = DirectGravity(m, soft, kernel="spline",
                           precision="float32_kahan", impl="sharded",
                           devices=[device] * d)
    pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=device)
    launches0 = sum(cuda_direct.LAUNCHES.values())
    far0 = TILES["newtonian"]
    ms = best_ms(lambda: solver.accel(pos), device, reps)
    calls = reps + 1
    return {"D": d, "N": n, "ms": ms,
            "launches": (sum(cuda_direct.LAUNCHES.values()) - launches0)
            / calls,
            "far": (TILES["newtonian"] - far0) / calls, "tiles": d * d}


def _line(row, t1):
    return (f"D={row['D']}: N={row['N']:>7}  {row['ms']:9.3f} ms/eval "
            f"({row['ms'] / t1:5.2f}x)  {row['launches']:5.0f} launches  "
            f"far {row['far']:.0f}/{row['tiles']}")


def strong(n, device, reps=5, ds=DS):
    """Fixed N, growing D: the rows of the strong-scaling table."""
    rows = [eval_row(n, d, device, reps) for d in ds]
    print(f"== strong scaling: N = {n}, virtual shards of {device} ==",
          flush=True)
    for row in rows:
        print("  " + _line(row, rows[0]["ms"]), flush=True)
    return rows


def weak(per_shard, device, reps=5, ds=DS):
    """Fixed N/D: the rows of the weak-scaling table (pair work grows as
    D^2 on the same device)."""
    rows = [eval_row(per_shard * d, d, device, reps) for d in ds]
    print(f"== weak scaling: N/D = {per_shard}, virtual shards of {device} "
          "==", flush=True)
    for row in rows:
        print("  " + _line(row, rows[0]["ms"])
              + f"  {row['N'] ** 2 / (row['ms'] * 1e-3) / 1e9:8.1f} Gint/s",
              flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain tiles)")
    ap.add_argument("-N", type=int, default=65536)
    ap.add_argument("--per-shard", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return {"strong": strong(args.N, device, args.reps),
            "weak": weak(args.per_shard, device, args.reps)}


if __name__ == "__main__":
    main()
