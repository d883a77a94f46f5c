"""Benchmark suite (`python -m nbody_streams_tpu_torch.bench_suite`).

Counterpart of ``nbody_streams_tpu/bench_suite.py`` (itself the native
equivalent of the reference's ``python -m nbody_streams.fields`` CLI):
per-kernel and per-precision force and potential timings, validation
against the float64 oracle, host transfer, N-scaling and KDK drift by
precision tier.

Usage:
    python -m nbody_streams_tpu_torch.bench_suite [-N 65536] [--reps 6] \\
        [--sections 1,2,3,4,5,6] [--device cuda]
    python -m nbody_streams_tpu_torch.bench_suite --sharded [-N 8192] \\
        [--reps 3] [--device cuda] [--shards 8]

On a CUDA device (the default; without one it raises) every fp32 row
pins ``impl='cuda'`` (the hand-written kernels) and each call is timed by
CUDA events.  ``--device cpu`` runs sections 1-5 through the plain-torch
oracle (``impl='torch'``) under the host clock, a CPU number for tests;
section 6 is ``bench.measure`` per precision tier and needs a CUDA
device.  The float64 rows always run the torch oracle: the kernels are
fp32-only by design.  ``float32_fast`` has its row on the sorted spline
path (spline, N >= 16,384), where the card runs kernel F; the CPU's
torch oracle runs it as plain float32 (the dispatch warns).  ``main``
returns the measured rows as a dict, with the device's name.
``--sharded`` runs the sharded row instead (``main_sharded``): the ring
of shards against one device, on 8 virtual shards of the card by default
(``--device cpu`` for 8 CPU shards).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    from . import make_plummer_sphere
    from .constants import G_DEFAULT
    from .ops.dispatch import DirectGravity
    from .ops.pairwise import accel_tile
    from .ops.probe import time_call

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-N", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--sections", type=str, default="1,2,3,4,5,6",
                    help="comma-separated section numbers to run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    n, reps = args.N, args.reps
    sections = {int(s) for s in args.sections.split(",")}

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_suite measures a CUDA device and torch "
                           "sees none; pass --device cpu for the plain "
                           "versions")
    impl = "cuda" if device.type == "cuda" else "torch"
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}  impl: {impl}")
    print(f"N = {n}, reps = {reps} (timed per call)\n")

    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    pos64 = xv[:, :3]
    soft = np.full(n, 0.05)
    out = {"device": name, "impl": impl, "n": n}

    def timed(solver, fn, pos, r):
        p = torch.as_tensor(pos, dtype=solver.dtype, device=device)
        return time_call(lambda: fn(p), device, r)

    if 1 in sections:
        # ---- section 1: force throughput by kernel x precision ------------
        print("SECTION 1: force kernels (Gint/s = N^2 pair interactions/s)")
        rows = {}
        for kernel in ("spline", "plummer", "dehnen_k1", "newtonian"):
            # float32_fast only exists on the slab-sorted spline path
            # (kernel F); elsewhere it is plain float32
            tiers = ("float32_kahan", "float32", "float32_fast") \
                if kernel == "spline" and n >= 16384 \
                else ("float32_kahan", "float32")
            for precision in tiers:
                s = DirectGravity(m, soft, kernel=kernel, precision=precision,
                                  impl=impl, device=device)
                dt = timed(s, s.accel, pos64, reps)
                rows[(kernel, precision)] = {"ms": dt * 1e3,
                                             "gint": n * n / dt / 1e9}
                print(f"  {kernel:10s} {precision:14s} {dt*1e3:9.2f} ms "
                      f"{n*n/dt/1e9:8.1f} Gint/s")
        # float64 rows: the torch oracle (the kernels are fp32-only);
        # skipped above 256k, where one eval would run minutes
        if n <= 262144:
            for kernel in ("spline", "newtonian"):
                s = DirectGravity(m, soft, kernel=kernel, precision="float64",
                                  device=device)
                dt = timed(s, s.accel, pos64, max(1, reps // 3))
                rows[(kernel, "float64")] = {"ms": dt * 1e3,
                                             "gint": n * n / dt / 1e9}
                print(f"  {kernel:10s} {'float64':14s} {dt*1e3:9.2f} ms "
                      f"{n*n/dt/1e9:8.1f} Gint/s")
        else:
            print("  (float64 rows skipped above N=262144)")
        out["section1"] = rows

    if 2 in sections:
        # ---- section 2: potential kernel ----------------------------------
        print("\nSECTION 2: potential (vs force) kernel")
        s = DirectGravity(m, soft, kernel="spline", precision="float32_kahan",
                          impl=impl, device=device)
        dtf = timed(s, s.accel, pos64, reps)
        dtp = timed(s, s.potential, pos64, reps)
        print(f"  force {dtf*1e3:9.2f} ms   potential {dtp*1e3:9.2f} ms "
              f"({dtf/dtp:.2f}x)")
        out["section2"] = {"force_ms": dtf * 1e3, "potential_ms": dtp * 1e3}

    if 3 in sections:
        # ---- section 3: validation vs the float64 oracle ------------------
        # The fp32 solver runs at full N, so the production path (the
        # sorted two-pass kernels at N >= 16,384) is what gets validated;
        # the oracle is rectangular, 4,096 targets against all N sources.
        nv = min(n, 4096)
        print(f"\nSECTION 3: validation vs the float64 torch oracle "
              f"({nv} targets x all {n:,} sources, full-N fp32 solve)")
        f64 = dict(dtype=torch.float64, device=device)
        pt = torch.as_tensor(pos64[:nv], **f64)
        ht = torch.as_tensor(soft[:nv], **f64)
        it = torch.arange(nv, device=device)
        a_ref = torch.zeros((nv, 3), **f64)
        cs = 4096
        for s0 in range(0, n, cs):
            s1 = min(s0 + cs, n)
            a_ref += accel_tile(
                "spline", pt, ht, it, torch.as_tensor(pos64[s0:s1], **f64),
                torch.as_tensor(m[s0:s1], **f64),
                torch.as_tensor(soft[s0:s1], **f64),
                torch.arange(s0, s1, device=device))
        a_ref = (G_DEFAULT * a_ref).cpu().numpy()
        scale = np.abs(a_ref).max()
        rows = {}
        for precision in ("float32_kahan", "float32"):
            s = DirectGravity(m, soft, kernel="spline", precision=precision,
                              impl=impl, device=device)
            a = s.accel(torch.as_tensor(pos64, dtype=s.dtype,
                                        device=device)).double().cpu().numpy()
            err = np.abs(a[:nv] - a_ref).max() / scale
            net = np.abs((m[:, None] * a).sum(0)).max() \
                / np.abs(m[:, None] * a).sum()
            rows[precision] = {"max_rel_err": err, "net_force": net}
            print(f"  {precision:14s} max rel err {err:.2e}   "
                  f"net-force/|F|sum {net:.2e}")
        out["section3"] = rows

    if 4 in sections:
        # ---- section 4: host <-> device transfer --------------------------
        print("\nSECTION 4: host <-> device transfer")
        x = torch.as_tensor(pos64, dtype=torch.float32, device=device)
        x.cpu()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(10):
            x.cpu()
        d2h = (time.perf_counter() - t0) / 10
        print(f"  D->H (N,3) float32: {d2h*1e3:.3f} ms "
              f"({pos64.nbytes / 2 / d2h / 1e9:.2f} GB/s)")
        out["section4"] = {"d2h_ms": d2h * 1e3}

    if 5 in sections:
        # ---- section 5: N-scaling -----------------------------------------
        print("\nSECTION 5: N-scaling (spline + Kahan)")
        rows = {}
        for nn in (16384, 65536, 262144, 1048576):
            if nn > n * 4:
                break
            xvn, mn = make_plummer_sphere(nn, M_total=1e9, a=1.0, seed=2)
            s = DirectGravity(mn, np.full(nn, 0.05), kernel="spline",
                              precision="float32_kahan", impl=impl,
                              device=device)
            rr = max(2, reps // 2) if nn <= 262144 else 2
            dt = timed(s, s.accel, xvn[:, :3], rr)
            rows[nn] = {"ms": dt * 1e3, "gint": nn * nn / dt / 1e9}
            print(f"  N={nn:8d}: {dt*1e3:9.2f} ms  {nn*nn/dt/1e9:8.1f} "
                  f"Gint/s")
        out["section5"] = rows

    if 6 in sections:
        # ---- section 6: KDK stepping drift by precision tier --------------
        from .bench import measure

        steps = 300 if n <= 262144 else 60
        print(f"\nSECTION 6: KDK stepping (spline): Gint/s + |dE/E| over "
              f"{steps} steps (bench.measure, one window)")
        rows = {}
        for precision in ("float32_kahan", "float32", "float32_fast"):
            r = measure(device, windows=1, steps=steps, precision=precision,
                        n=n)
            rows[precision] = {"ms_per_step": r["ms_per_step"], "de": r["de"]}
            print(f"  {precision:14s} {r['ms_per_step']:9.2f} ms/step "
                  f"{r['gint_per_s']:8.1f} Gint/s   |dE/E| = {r['de']:.2e}")
        out["section6"] = rows

    print("\ndone.")
    return out


def main_sharded(argv=None):
    """The suite's sharded row (the JAX suite's ``main_sharded``): the ring
    of shards at N = 8,192 (spline, float32_kahan) against the one-device
    solver on the same device, max relative error and ms an evaluation.

    ``--device`` names the device and ``--shards`` how many virtual shards
    of it the ring spans: 8 shards of the card by default, where the ring
    runs the kernels (without a card it raises).  ``--device cpu`` is the
    counterpart of the JAX row's 8-device virtual CPU mesh: there the ring
    takes the plain tile and its time measures the orchestration, not a
    kernel.  Returns the row as a dict."""
    from . import make_plummer_sphere
    from ._device import resolve_device
    from .ops.dispatch import DirectGravity

    ap = argparse.ArgumentParser(description="the sharded-ring row")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("-N", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the shards' device")
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args(argv)
    n = args.N
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise RuntimeError(f"{err} (here: --device cpu)") from None

    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    soft = np.full(n, 0.05)
    sharded = DirectGravity(m, soft, kernel="spline", impl="sharded",
                            precision="float32_kahan",
                            devices=[device] * args.shards)
    single = DirectGravity(m, soft, kernel="spline",
                           precision="float32_kahan", device=device)
    p = torch.tensor(xv[:, :3], dtype=torch.float32, device=device)
    a_s = sharded.accel(p).double()
    a_1 = single.accel(p).double()
    rel = ((a_s - a_1).abs().max() / a_1.abs().max()).item()
    best = float("inf")
    for _ in range(args.reps):
        _sync(device)
        t0 = time.perf_counter()
        sharded.accel(p)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    tile = "kernel" if sharded._sharded.use_kernels else "plain"
    print(f"  sharded ring {args.shards}-shard ({device.type}, {tile} "
          f"tile): N={n}  {best * 1e3:9.2f} ms/eval   max rel vs "
          f"single-device ({single.impl}) {rel:.2e}")
    return {"n": n, "shards": args.shards, "device": device.type,
            "tile": tile, "ms": best * 1e3, "max_rel_err": rel}


if __name__ == "__main__":
    import sys

    if "--sharded" in sys.argv:
        main_sharded()
    else:
        main()
