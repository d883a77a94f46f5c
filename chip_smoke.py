"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--log-dir DIR]

Builds the CUDA kernels of ``nbody_streams_tpu_torch`` from the sources in
this checkout, checks each against its plain torch version on the card,
drives ``run_simulation(method='direct', architecture='gpu')`` on the bench
case (N = 65,536 Plummer, spline softening h = 0.05, float32 + Kahan,
dt = 2e-5), times it, and drives the measurement path (probe, bench,
roofline, speed of light, tile sweep, bench suite).  Phases:

  (a) card name and power limit; kernel build time
  (b) kernels vs plain versions on the card; kernel vs the fp64 oracle
  (c) Kahan compensation beats plain fp32 on an adversarial sum
  (d) run_simulation on the bench case, 300 steps: |dE/E| < 1e-4, the last
      snapshot (the restart file where h5py is absent) reads back, and the
      path ran through both kernels
  (e) impl='cuda' vs impl='torch' over 10 KDK steps at N = 16,384
  (f) ms/step and Gint/s of the bench case, best of 3 windows of 100 steps
      (``bench.measure``, |dE/E| < 1e-4 over the windows)
  (g) the roofline kernels vs their plain versions; then, with their
      launch counts zeroed, the measurement path: the FMA probe, the
      bench's capacity probe, the FMA and rsqrt rates and tile_sol at the
      base pass's shape and at full occupancy, each <= 1.05 x the card's
      peak (SM count x max clock); the base and band passes as fractions
      of the speed of light; the base pass at full occupancy (16 copies
      of its targets, the same work per block)
  (h) the tile sweep at N = 65,536 (every geometry within 2e-6 * max of
      the default's accelerations), bench_suite sections 1-3 (errors vs
      the fp64 oracle <= 3e-6), and the single-pass kernel's plain time

Every phase raises on failure.  The last line is
``{"ok": true, "device": {...}}``; the line before it is the card, and
the one before that a JSON object of the kernels: launches in phase (d)
for the force kernels and in phase (g)'s measurement path for the
roofline kernels, max error and times from (b)/(g).
Exits nonzero, and prints no result, without a CUDA device.
"""
import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_BENCH = 65536
DT = 2e-5
H = 0.05
SOURCE = "nbody_streams_tpu_torch/csrc/direct.cu"
ROOFLINE_SOURCE = "nbody_streams_tpu_torch/csrc/roofline.cu"
# the chains (K links per pass, passes) for the kernel-vs-plain checks: the
# probe's K, where the chains sit at their fixed point, and a K below it,
# where every link and every pass moves the output
CHAIN_CHECKS = ((256, 40), (16, 2))
# tile_sol reps for the kernel-vs-plain check and for the rates
SOL_CHECK_REPS, SOL_REPS = 16, 1024
# copies of the bench case's targets for the base pass at full occupancy
OCC_COPIES = 16


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def rel_err(a, b):
    """max |a - b| / max |b| (and the absolute max)."""
    d = (a.double() - b.double()).abs().max().item()
    return d / b.double().abs().max().item(), d


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, by events."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plummer_case(n, seed):
    from nbody_streams_tpu_torch import make_plummer_sphere

    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=seed)
    return xv, m


def phase_a(log_dir):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"(a) nvidia-smi: {smi}")
    log(f"(a) torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    from nbody_streams_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"(a) kernels built in {time.perf_counter() - t0:.1f} s: {lib_path}")
    if log_dir:
        shutil.copy(lib_path.parent / "build.log", log_dir)
    return smi, name


def phase_b(dev):
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops.pairwise import (
        compute_forces_direct, compute_potential_direct)

    rng = np.random.default_rng(5)
    # direct_tile_kernel, single pass: 5 laws x acc/pot x Kahan on/off at a
    # ragged N.  Tolerance: 2e-6 * max with Kahan, 1e-5 * max without
    # (fp32 sums in another order; rsqrt <= 2 ulp on both sides)
    n = 3000
    pos = torch.tensor(rng.normal(0, 1, (n, 3)), dtype=torch.float32,
                       device=dev)
    gm = torch.tensor(rng.uniform(0.5, 2.0, n) * 0.43, dtype=torch.float32,
                      device=dev)
    soft = torch.tensor(rng.uniform(0.05, 0.3, n), dtype=torch.float32,
                        device=dev)
    worst = 0.0
    for kind in ("newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline"):
        pre = cd._soft_pre(kind, soft)
        tgt, src = cd._targets(pos, pre), cd._sources(pos, gm, pre, cd.TN)
        for mode in ("acc", "pot"):
            for kahan in (True, False):
                args = (tgt, src, kind, mode, kahan, 1e-15, mode == "pot")
                got = cd._direct_tile(*args)
                want = cd._direct_tile_reference(*args)
                rel, _ = rel_err(got, want)
                tol = 2e-6 if kahan else 1e-5
                check(torch.isfinite(got).all().item(), f"{kind} {mode}")
                check(rel < tol, f"direct {kind} {mode} kahan={kahan}: "
                      f"{rel:.2e} >= {tol}")
                worst = max(worst, rel / tol)
    log(f"(b) direct_tile_kernel single pass, 20 variants at N={n}: "
        f"worst error {worst:.2f} of its tolerance")

    # skip_band base pass + band pass at the bench case's shapes
    xv, m = plummer_case(N_BENCH, 2)
    pos64 = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    order = cd.slab_sort_key(pos64)
    ps = pos64[order]
    gs = torch.full((N_BENCH,), m[0] * 4.300917270069976e-06,
                    dtype=torch.float32, device=dev)
    hs = torch.full((N_BENCH,), H, dtype=torch.float32, device=dev)
    hinv = cd._soft_pre("spline", hs)
    first, max_width, rows = cd.band_window(ps[:, 0], hs.max())
    nb = cd.band_rows(rows)
    check(int(max_width) <= nb, f"bench case window {int(max_width)} > {nb}")
    start = first.clamp(0, rows - nb).to(torch.int32).contiguous()
    tgt, src = cd._targets(ps, hinv), cd._sources(ps, gs, hinv, cd.TN)
    stats = {}
    for name, fn, ref in (
            ("direct", lambda: cd._direct_tile(
                tgt, src, "newtonian", "acc", True, 1e-15, False, nb, start),
             lambda: cd._direct_tile_reference(
                 tgt, src, "newtonian", "acc", True, 1e-15, False, nb,
                 start)),
            ("band", lambda: cd._band(tgt, src, start, "acc", True, 1e-15,
                                      False, cd.TM, cd.TN, nb),
             lambda: cd._band_reference(tgt, src, start, "acc", True, 1e-15,
                                        False, cd.TM, cd.TN, nb))):
        got, want = fn(), ref()
        rel, absolute = rel_err(got, want)
        check(rel < 2e-6, f"{name} at N={N_BENCH}: {rel:.2e} >= 2e-6")
        ms = cuda_ms(fn, 20)
        plain_ms = cuda_ms(ref, 3)
        stats[name] = dict(max_abs_err=absolute, rel=rel, ms=ms,
                           plain_ms=plain_ms)
        log(f"(b) {name} kernel at N={N_BENCH} (nb={nb} of {rows} rows): "
            f"rel err {rel:.2e} (tol 2e-6), {ms:.3f} ms vs plain "
            f"{plain_ms:.3f} ms")
    for mode in ("acc", "pot"):
        # the single-pass spline (the fallback branch) at the same shapes
        ms = cuda_ms(lambda: cd._direct_tile(
            tgt, src, "spline", mode, True, 1e-15, mode == "pot"), 5)
        log(f"(b) single-pass spline {mode} at N={N_BENCH}: {ms:.3f} ms")
    stats["operands"] = (tgt, src, start, nb)

    # kernels vs the fp64 oracle at N = 16,384 (sorted two-pass path).
    # Tolerance 3e-6 * max, the JAX package's kernel-vs-oracle tolerance
    n = 16384
    xv, m = plummer_case(n, 4)
    p = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    mt = torch.tensor(m, dtype=torch.float32, device=dev)
    ht = torch.full((n,), H, dtype=torch.float32, device=dev)
    G = 4.300917270069976e-06
    before = dict(cd.BRANCHES)
    acc = cd.cuda_accel(p, mt, ht, G, "spline", True)
    phi = cd.cuda_potential(p, mt, ht, G, "spline", True)
    check(cd.BRANCHES["two_pass"] == before["two_pass"] + 2,
          "N=16384 did not take the two-pass branch")
    acc64 = compute_forces_direct(p.double(), mt.double(), ht.double(), G=G,
                                  precision="float64")
    phi64 = compute_potential_direct(p.double(), mt.double(), ht.double(),
                                     G=G, precision="float64")
    for what, got, want in (("acc", acc, acc64), ("pot", phi, phi64)):
        rel, _ = rel_err(got, want)
        check(rel < 3e-6, f"{what} vs fp64 at N={n}: {rel:.2e} >= 3e-6")
        log(f"(b) cuda_{'accel' if what == 'acc' else 'potential'} vs fp64 "
            f"oracle at N={n}: rel err {rel:.2e} (tol 3e-6)")
    return stats


def phase_c(dev):
    """One heavy near source first, then 65,535 light far ones, each below
    half an ulp of the running sum: plain fp32 drops them all."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    n = N_BENCH
    rng = np.random.default_rng(9)
    xs = np.empty((n, 3))
    xs[0] = (1.0, 0.0, 0.0)
    xs[1:] = (100.0, 0.0, 0.0) + rng.normal(0, 1.0, (n - 1, 3))
    gm = np.full(n, 5e-6)
    gm[0] = 1.0
    xs32 = xs.astype(np.float32).astype(np.float64)
    gm32 = gm.astype(np.float32).astype(np.float64)
    r = np.linalg.norm(xs32, axis=1)
    exact = (gm32 / r**3 * xs32[:, 0]).sum()
    zero = torch.zeros((1, 3), dtype=torch.float32, device=dev)
    tgt = cd._targets(zero, torch.zeros(1, device=dev))
    src = cd._sources(torch.tensor(xs, dtype=torch.float32, device=dev),
                      torch.tensor(gm, dtype=torch.float32, device=dev),
                      torch.zeros(n, device=dev), cd.TN)
    errs = {}
    for kahan in (True, False):
        a = cd._direct_tile(tgt, src, "newtonian", "acc", kahan, 1e-15)
        errs[kahan] = abs(a[0, 0].item() - exact) / abs(exact)
    log(f"(c) Kahan check: rel err {errs[True]:.2e} compensated vs "
        f"{errs[False]:.2e} plain (fp64 sum {exact:.9e})")
    check(errs[True] * 10 < errs[False],
          "compensated sum is not 10x better than plain fp32")


def phase_d(dev):
    import nbody_streams_tpu_torch as nst
    from nbody_streams_tpu_torch import nbody_io
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    xv, m = plummer_case(N_BENCH, 2)
    species = [nst.Species.dark(N=N_BENCH, mass=float(m[0]), softening=H)]
    solver = nst.DirectGravity(m, np.full(N_BENCH, H), device=dev)

    def energy(xv_):
        pos = torch.tensor(xv_[:, :3], dtype=torch.float32, device=dev)
        phi = solver.potential(pos).double().cpu().numpy()
        return 0.5 * (m * (xv_[:, 3:] ** 2).sum(1)).sum() + \
            0.5 * (m * phi).sum()

    e0 = energy(xv)
    steps = 300
    # snapshots need h5py; without it the run writes only its restart file
    snaps = nbody_io.H5PY_AVAILABLE
    if not snaps:
        log("(d) h5py is not installed: snapshots off, the restart file "
            "is read back instead")
    with tempfile.TemporaryDirectory() as out_dir:
        for key in cd.LAUNCHES:
            cd.LAUNCHES[key] = 0
        for key in cd.BRANCHES:
            cd.BRANCHES[key] = 0
        t0 = time.perf_counter()
        res = nst.run_simulation(
            xv, species, 0.0, steps * DT, DT, architecture="gpu",
            method="direct", output_dir=out_dir, save_snapshots=snaps,
            snapshots=4, debug_energy=True, verbose=True)
        wall = time.perf_counter() - t0
        launches, branches = dict(cd.LAUNCHES), dict(cd.BRANCHES)
        final = res["dark"]
        if snaps:
            reader = nst.ParticleReader(f"{out_dir}/snapshot*.h5")
            saved = reader.read_snapshot(
                int(reader.Snapshots[-1])).dark["posvel"]
        else:
            saved, _, saved_step = nbody_io._load_restart(out_dir)[:3]
            check(saved_step == steps, f"restart at step {saved_step}")
        check(np.array_equal(saved, final),
              "saved state differs from the returned state")
    check(final.shape == (N_BENCH, 6) and np.isfinite(final).all(),
          "final state not finite / wrong shape")
    de = abs((energy(final) - e0) / e0)
    log(f"(d) run_simulation: {steps} steps in {wall:.2f} s, |dE/E| = "
        f"{de:.3e} (limit 1e-4), launches {launches}, branches {branches}")
    check(de < 1e-4, f"|dE/E| = {de:.3e} >= 1e-4")
    check(launches["direct"] > 0 and launches["band"] > 0,
          f"main path missed a kernel: {launches}")
    check(branches["two_pass"] > 0, f"two-pass branch never ran: {branches}")
    return launches


def phase_e(dev):
    from nbody_streams_tpu_torch.integrate import (
        init_state, make_accel_fn, make_kdk_step, run_chunk)
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    n = 16384
    xv, m = plummer_case(n, 3)
    finals = {}
    for impl in ("cuda", "torch"):
        solver = DirectGravity(m, np.full(n, H), impl=impl, device=dev)
        accel_fn = make_accel_fn(solver, solver.mass)
        step_fn = make_kdk_step(accel_fn, DT, 0.0)
        presort = solver.spatial_sort_active
        state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, 0.0,
                           sort_fn=solver.sort_key if presort else None,
                           device=dev)
        finals[impl] = run_chunk(step_fn, state, 10, presort=presort)
    for field in ("pos", "vel"):
        a = getattr(finals["cuda"], field)
        b = getattr(finals["torch"], field)
        rel, _ = rel_err(a, b)
        check(rel < 1e-6, f"cuda vs torch {field}: {rel:.2e} >= 1e-6")
        log(f"(e) impl='cuda' vs 'torch', 10 steps at N={n}: {field} rel "
            f"err {rel:.2e} (tol 1e-6)")


def phase_f(dev, smi, name):
    from nbody_streams_tpu_torch import bench

    r = bench.measure(dev, windows=3, steps=100)
    log(f"(f) N={N_BENCH} {r['ms_per_step']:.3f} ms/step (windows "
        f"{', '.join(f'{w:.3f}' for w in r['windows_ms'])} ms), "
        f"{r['gint_per_s']:.2f} Gint/s, |dE/E| = {r['de']:.2e} over "
        f"{r['steps']} steps, on {name} ({smi})")
    log(json.dumps({
        "metric": bench.METRIC, "value": round(r["gint_per_s"], 2),
        "unit": "Gint/s",
        "vs_baseline": round(r["gint_per_s"] / bench.BASELINE_GINT, 3),
        "card": smi}))
    return r


def phase_g(dev, base):
    """Roofline kernels vs plain, then the measurement path."""
    from nbody_streams_tpu_torch import bench
    from nbody_streams_tpu_torch.benchmarks import tile_sweep
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops import probe
    from nbody_streams_tpu_torch.ops import roofline as rl

    t0 = time.perf_counter()
    stats = {}
    # chains: tolerance 1e-5 * max (one FFMA on the card, two roundings in
    # torch; rsqrt within 2 ulp on both sides; the recurrences contract).
    # The kernels line takes the worst error of the checks and the times
    # of the first (the probe's K)
    x = probe.probe_tile(dev)
    for name in ("fma_chain", "rsqrt_chain"):
        fn = getattr(rl, name)
        ref = getattr(rl, f"_{name}_reference")
        for K, passes in CHAIN_CHECKS:
            got, want = fn(x, K, passes), ref(x, K, passes)
            check(torch.isfinite(got).all().item(), f"{name} not finite")
            rel, absolute = rel_err(got, want)
            check(rel < 1e-5, f"{name} K={K}: {rel:.2e} >= 1e-5")
            if name not in stats:
                stats[name] = dict(
                    max_abs_err=absolute, rel=rel,
                    ms=cuda_ms(lambda: fn(x, K, passes), 10),
                    plain_ms=cuda_ms(lambda: ref(x, K, passes), 1))
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                             absolute)
            log(f"(g) {name}_kernel on (512, 512), K={K}, {passes} passes: "
                f"rel err {rel:.2e}, abs {absolute:.3e} (tol 1e-5 rel)")
        log(f"(g) {name}_kernel at K={CHAIN_CHECKS[0][0]}, "
            f"{CHAIN_CHECKS[0][1]} passes: {stats[name]['ms']:.3f} ms vs "
            f"plain {stats[name]['plain_ms']:.3f} ms")
    # tile_sol at the base pass's shape on the bench operands: 2e-6 * max
    # (the Kahan tolerance of direct_tile_kernel)
    tgt, src, _, nb = base["operands"]
    blocks = tgt.shape[1] // 64
    for kind in ("newtonian", "spline"):
        def sol(kind=kind):
            return rl.tile_sol(tgt, src, kind, blocks, SOL_CHECK_REPS)

        def plain(kind=kind):
            return rl._tile_sol_reference(tgt, src, kind, blocks,
                                          SOL_CHECK_REPS)

        got, want = sol(), plain()
        rel, absolute = rel_err(got, want)
        check(torch.isfinite(got).all().item(), f"tile_sol {kind}")
        check(rel < 2e-6, f"tile_sol {kind}: {rel:.2e} >= 2e-6")
        ms, plain_ms = cuda_ms(sol, 10), cuda_ms(plain, 1)
        if kind == "newtonian":
            stats["tile_sol"] = dict(max_abs_err=absolute, rel=rel, ms=ms,
                                     plain_ms=plain_ms)
        log(f"(g) tile_sol_kernel<{kind}> at {blocks} blocks, "
            f"{SOL_CHECK_REPS} reps: rel err {rel:.2e} (tol 2e-6), "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")

    # the measurement path, its launch counts zeroed just before
    for key in rl.LAUNCHES:
        rl.LAUNCHES[key] = 0
    tops = probe.delivered_tops(device=dev)
    torch_tops, cuda_tops = bench._capacity_probe(device=dev)
    roof = tile_sweep.roofline(dev)
    sols = {(kind, shape): tile_sweep.sol(
                kind, blocks if shape == "base" else None, SOL_REPS, dev)
            for kind in ("newtonian", "spline") for shape in ("base", "full")}
    launches = dict(rl.LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"measurement path missed a kernel: {launches}")

    peaks = probe.card_peaks(dev)
    fp32, mufu = peaks["fp32_ops_per_s"], peaks["mufu_per_s"]
    log(f"(g) card peaks from {peaks['sms']} SMs at {peaks['max_sm_mhz']:.0f} "
        f"MHz max: FP32 {fp32 / 1e12:.2f} TFLOP/s, MUFU "
        f"{mufu / 1e12:.3f} T/s")
    readings = [("delivered_tops fma", tops * 1e12, fp32),
                ("capacity probe fma_chain_kernel", cuda_tops * 1e12, fp32),
                ("roofline fma", roof["fma"]["g_ops_per_s"] * 1e9, fp32),
                ("roofline rsqrt", roof["rsqrt"]["g_lanes_per_s"] * 1e9,
                 mufu)]
    readings += [(f"tile_sol {kind} {shape} ({r['blocks']} blocks) pairs",
                  r["g_pairs_per_s"] * 1e9, mufu)
                 for (kind, shape), r in sols.items()]
    for what, rate, peak in readings:
        check(np.isfinite(rate) and 0 < rate <= 1.05 * peak,
              f"{what}: {rate:.4e}/s is not within (0, 1.05 x peak "
              f"{peak:.4e}]")
        log(f"(g) {what}: {rate:.6e}/s = {rate / peak:.4f} of peak")
    log(f"(g) capacity probe: plain torch chain {torch_tops:.5f} Top/s, "
        f"fma_chain_kernel {cuda_tops:.4f} Top/s")

    # base and band passes (phase b) as fractions of the speed of light
    nt, ns = tgt.shape[1], src.shape[1]
    base_pairs = nt * (ns - nb * cd.TN) / (base["direct"]["ms"] * 1e-3)
    # the base pass itself at full occupancy: OCC_COPIES copies of the
    # targets (and of their band windows) against the same sources, the
    # same work per block in OCC_COPIES times the blocks
    start = base["operands"][2]
    tgt_n, start_n = tgt.repeat(1, OCC_COPIES), start.repeat(OCC_COPIES)

    def base_pass(t, s):
        return cd._direct_tile(t, src, "newtonian", "acc", True, 1e-15, False,
                               nb, s)

    check(torch.equal(base_pass(tgt_n, start_n)[:nt], base_pass(tgt, start)),
          "base pass over copied targets differs from the base pass")
    own_ms = cuda_ms(lambda: base_pass(tgt, start), 20)
    full_ms = cuda_ms(lambda: base_pass(tgt_n, start_n), 5)
    own_pairs = nt * (ns - nb * cd.TN) / (own_ms * 1e-3)
    full_pairs = OCC_COPIES * nt * (ns - nb * cd.TN) / (full_ms * 1e-3)
    log(f"(g) base pass occupancy: {nt // cd.BLOCK} blocks {own_ms:.3f} ms, "
        f"{own_pairs:.6e} pairs/s; {OCC_COPIES * nt // cd.BLOCK} blocks "
        f"{full_ms:.3f} ms, {full_pairs:.6e} pairs/s; own shape / full = "
        f"{own_pairs / full_pairs:.4f}")
    band_pairs = nt * nb * cd.TN / (base["band"]["ms"] * 1e-3)
    for shape in ("base", "full"):
        sn = sols[("newtonian", shape)]["g_pairs_per_s"] * 1e9
        ss = sols[("spline", shape)]["g_pairs_per_s"] * 1e9
        log(f"(g) speed of light at the {shape} shape: base pass "
            f"{base_pairs:.6e} pairs/s = {base_pairs / sn:.4f} of "
            f"tile_sol newtonian; band pass {band_pairs:.6e} pairs/s = "
            f"{band_pairs / ss:.4f} of tile_sol spline")
    sn = sols[("newtonian", "full")]["g_pairs_per_s"] * 1e9
    log(f"(g) base pass at full occupancy: {full_pairs / sn:.4f} of "
        "tile_sol newtonian at full occupancy")
    log(f"(g) wall {time.perf_counter() - t0:.1f} s")
    return stats, launches


def phase_h(dev, base):
    from nbody_streams_tpu_torch import bench_suite
    from nbody_streams_tpu_torch.benchmarks import tile_sweep
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    t0 = time.perf_counter()
    res = tile_sweep.sweep(N_BENCH, 10, tile_sweep.GEOMS_64K, dev)
    ref = res[(512, 512)]["acc"]
    for (tm, tn), r in res.items():
        rel, _ = rel_err(r["acc"], ref)
        check(rel < 2e-6, f"sweep {tm}/{tn}: {rel:.2e} >= 2e-6 of 512/512")
        log(f"(h) sweep tm={tm} tn={tn}: {r['ms_per_eval']:.3f} ms/eval, "
            f"{r['gint_per_s']:.2f} Gint/s ({r['branch']}), rel err vs "
            f"512/512 {rel:.2e} (tol 2e-6)")
    out = bench_suite.main(["-N", str(N_BENCH), "--reps", "3",
                            "--sections", "1,2,3"])
    for precision, row in out["section3"].items():
        check(row["max_rel_err"] <= 3e-6,
              f"bench_suite {precision}: {row['max_rel_err']:.2e} > 3e-6")
    # row 2 of the kernel table: the single-pass kernel's plain version
    tgt, src = base["operands"][:2]
    plain_ms = cuda_ms(lambda: cd._direct_tile_reference(
        tgt, src, "spline", "acc", True, 1e-15), 1)
    log(f"(h) single-pass spline acc plain version at N={N_BENCH}: "
        f"{plain_ms:.3f} ms")
    log(f"(h) wall {time.perf_counter() - t0:.1f} s")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log-dir", help="copy the nvcc build log here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # the package must come from this checkout: fail before printing
    # anything when the script stands alone
    import nbody_streams_tpu_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi, name = phase_a(args.log_dir)
    stats = phase_b(dev)
    phase_c(dev)
    launches = phase_d(dev)
    phase_e(dev)
    phase_f(dev, smi, name)
    roof_stats, roof_launches = phase_g(dev, stats)
    phase_h(dev, stats)
    replaces = {"direct": "nbody_streams_tpu/ops/pallas_direct.py:301",
                "band": "nbody_streams_tpu/ops/pallas_direct.py:494"}
    kernels = [{"name": f"{key}_{'tile_' if key == 'direct' else ''}kernel",
                "route": "cuda", "source": SOURCE,
                "replaces": replaces[key], "launches": launches[key],
                "max_abs_err": stats[key]["max_abs_err"],
                "ms": stats[key]["ms"], "plain_ms": stats[key]["plain_ms"]}
               for key in ("direct", "band")]
    replaces = {
        "fma_chain": "nbody_streams_tpu/ops/probe.py:62, bench.py:95, "
                     "benchmarks/tile_sweep.py:111",
        "rsqrt_chain": "benchmarks/tile_sweep.py:111",
        "tile_sol": "benchmarks/tile_sweep.py:193"}
    kernels += [{"name": f"{key}_kernel", "route": "cuda",
                 "source": ROOFLINE_SOURCE, "replaces": replaces[key],
                 "launches": roof_launches[key],
                 "max_abs_err": roof_stats[key]["max_abs_err"],
                 "ms": roof_stats[key]["ms"],
                 "plain_ms": roof_stats[key]["plain_ms"]}
                for key in ("fma_chain", "rsqrt_chain", "tile_sol")]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
