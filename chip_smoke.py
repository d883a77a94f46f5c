"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--log-dir DIR]

Builds the CUDA kernels of ``nbody_streams_tpu_torch`` from the sources in
this checkout, checks each against its plain torch version on the card,
drives ``run_simulation(method='direct', architecture='gpu')`` on the bench
case (N = 65,536 Plummer, spline softening h = 0.05, float32 + Kahan,
dt = 2e-5), and times it.  Phases:

  (a) card name and power limit; kernel build time
  (b) kernels vs plain versions on the card; kernel vs the fp64 oracle
  (c) Kahan compensation beats plain fp32 on an adversarial sum
  (d) run_simulation on the bench case, 300 steps: |dE/E| < 1e-4, the last
      snapshot (the restart file where h5py is absent) reads back, and the
      path ran through both kernels
  (e) impl='cuda' vs impl='torch' over 10 KDK steps at N = 16,384
  (f) ms/step and Gint/s of the bench case, best of 3 windows of 100 steps

Every phase raises on failure.  The last line is
``{"ok": true, "device": {...}}``; the line before it is a JSON object of
the kernels: launches in phase (d), max error and times from (b)/(f).
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
BASELINE_GINT = 124.0  # the reference's RTX 3080 direct fp32 path
SOURCE = "nbody_streams_tpu_torch/csrc/direct.cu"


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
    from nbody_streams_tpu_torch.integrate import (
        init_state, make_accel_fn, make_kdk_step, run_chunk)
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    xv, m = plummer_case(N_BENCH, 2)
    solver = DirectGravity(m, np.full(N_BENCH, H), device=dev)
    accel_fn = make_accel_fn(solver, solver.mass)
    step_fn = make_kdk_step(accel_fn, DT, 0.0)
    state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, 0.0,
                       sort_fn=solver.sort_key, device=dev)
    every = solver.presort_interval   # the driver's order-refresh policy
    state = run_chunk(step_fn, state, 10, presort=True, presort_every=every)
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = run_chunk(step_fn, state, 100, presort=True,
                          presort_every=every)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 100)
    check(torch.isfinite(state.pos).all().item(), "timed run not finite")
    best = min(windows)
    gint = N_BENCH * N_BENCH / best / 1e9
    log(f"(f) N={N_BENCH} {best * 1e3:.3f} ms/step (windows "
        f"{', '.join(f'{w * 1e3:.3f}' for w in windows)} ms), "
        f"{gint:.2f} Gint/s on {name} ({smi})")
    log(json.dumps({
        "metric": f"direct-force KDK pairwise throughput (N={N_BENCH}, "
                  "spline softening, float32+Kahan)",
        "value": round(gint, 2), "unit": "Gint/s",
        "vs_baseline": round(gint / BASELINE_GINT, 3),
        "card": smi}))
    return best


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
    replaces = {"direct": "nbody_streams_tpu/ops/pallas_direct.py:301",
                "band": "nbody_streams_tpu/ops/pallas_direct.py:494"}
    kernels = [{"name": f"{key}_{'tile_' if key == 'direct' else ''}kernel",
                "route": "cuda", "source": SOURCE,
                "replaces": replaces[key], "launches": launches[key],
                "max_abs_err": stats[key]["max_abs_err"],
                "ms": stats[key]["ms"], "plain_ms": stats[key]["plain_ms"]}
               for key in ("direct", "band")]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
