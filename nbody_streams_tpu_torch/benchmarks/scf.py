"""The SCF tier on the card: speed, accuracy ladder and energy drift.

    python -m nbody_streams_tpu_torch.benchmarks.scf speed|ladder|drift

Counterpart of the repo's ``benchmarks/scf_bench.py``; each mode prints
JSON lines naming the card:

* ``speed``: ms per force evaluation (median of ``REPS`` calls, each
  ending in a synchronize) with the CUDA launches and device ms of one
  more under ``torch.profiler``, and ms per KDK step (``bench.measure``:
  best of 3 windows of 20 steps, with their |dE/E|), at N = 1M and 8M,
  (nmax, lmax) = (8, 4), a Plummer sphere (seed 7);
* ``ladder``: median and p99 relative force error against direct
  summation (the Plummer law at h = 1e-4 through the single-pass CUDA
  kernel) over (nmax, lmax), on the 65,536-particle Plummer sphere of
  seed 8 moved 0.5 along x so that l > 0 terms matter;
* ``drift``: |dE/E| of ``run_simulation(method='scf')`` on a 1M Plummer
  sphere (seed 2, dt = 2e-5), the energy in the same truncated field from
  a float64 ``SCFGravity`` on the card.

Without a CUDA device each mode raises.  The TPU script's supervisor
(``resupervise``) is not ported.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time

import numpy as np
import torch

REPS = 10
LADDER = ((2, 0), (4, 2), (8, 4), (12, 6), (16, 8))


def _device(device):
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"benchmarks.scf measures a CUDA device; got "
                           f"{device} (CUDA available: "
                           f"{torch.cuda.is_available()})")
    return device


def _emit(rec, device):
    rec = dict(rec, device=torch.cuda.get_device_name(device))
    print(json.dumps(rec), flush=True)
    return rec


def run_speed(ns=(1_048_576, 8_388_608), nmax=8, lmax=4, device="cuda",
              reps=REPS):
    """ms per force evaluation and per KDK step at each N; returns the
    records."""
    from .. import make_plummer_sphere
    from ..bench import measure
    from ..ops.scf import SCFGravity
    from .fields import profile_call

    device = _device(device)
    out = []
    for n in ns:
        xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=7)
        solver = SCFGravity(m, nmax=nmax, lmax=lmax, a=1.0, device=device)
        pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=device)
        torch.cuda.reset_peak_memory_stats(device)
        force = profile_call(lambda: solver.accel(pos), reps)
        kdk = measure(device, windows=3, steps=20, case=(xv, m),
                      solver=solver, dt=2e-5, warmup=5)
        out.append(_emit({
            "metric": "scf_speed", "n": n, "nmax": nmax, "lmax": lmax,
            "terms": solver.terms,
            "ms_per_force_eval": force["wall_median_ms"],
            "ms_per_force_eval_min": force["wall_min_ms"],
            "launches_per_force": force["launches"],
            "device_ms_per_force": force["device_ms"],
            "busy_share": force["busy_share"],
            "ms_per_kdk_step": kdk["ms_per_step"],
            "mpart_steps_per_s": n / kdk["ms_per_step"] / 1e3,
            "abs_dE_over_E": kdk["de"],
            "peak_gb": torch.cuda.max_memory_allocated(device) / 2**30,
        }, device))
    return out


def ladder_case(n=65536):
    """The ladder's sample: (positions (n, 3), masses)."""
    from .. import make_plummer_sphere

    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=8)
    xv[:, 0] += 0.5
    return xv[:, :3], m


def run_ladder(n=65536, orders=LADDER, device="cuda"):
    """Median and p99 relative force error of each (nmax, lmax) against
    the direct Plummer-law sum; returns the records."""
    from ..ops.dispatch import DirectGravity
    from ..ops.scf import SCFGravity

    device = _device(device)
    x, m = ladder_case(n)
    pos = torch.tensor(x, dtype=torch.float32, device=device)
    exact = DirectGravity(m, np.full(n, 1e-4), kernel="plummer",
                          impl="cuda", device=device)
    a_ref = exact.accel(pos).double().cpu().numpy()
    ref_mag = np.linalg.norm(a_ref, axis=1)
    out = []
    for nmax, lmax in orders:
        scf = SCFGravity(m, nmax=nmax, lmax=lmax, a=1.0, device=device)
        a = scf.accel(pos).double().cpu().numpy()
        rel = np.linalg.norm(a - a_ref, axis=1) / ref_mag
        out.append(_emit({
            "metric": "scf_force_error_vs_direct", "n": n, "nmax": nmax,
            "lmax": lmax, "terms": scf.terms,
            "median_rel_err": float(np.median(rel)),
            "p99_rel_err": float(np.quantile(rel, 0.99))}, device))
    return out


def run_drift(n=1_048_576, steps=1000, nmax=8, lmax=4, dt=2e-5,
              device="cuda", verbose=True):
    """|dE/E| of ``steps`` SCF steps through ``run_simulation``; returns
    the record."""
    from .. import Species, make_plummer_sphere, run_simulation
    from ..ops.scf import SCFGravity

    device = _device(device)
    xv, masses = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    species = [Species.dark(N=n, mass=float(masses[0]), softening=0.05)]
    scf = SCFGravity(masses, nmax=nmax, lmax=lmax, a=1.0,
                     precision="float64", device=device)

    def energy(arr):
        pos = torch.tensor(arr[:, :3], device=device)
        phi = scf.potential(pos).cpu().numpy()
        return (0.5 * (masses * (arr[:, 3:] ** 2).sum(1)).sum(),
                0.5 * (masses * phi).sum())

    ke0, pe0 = energy(xv)
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = run_simulation(
            xv, species, 0.0, steps * dt, dt, architecture="gpu",
            method="scf", scf_nmax=nmax, scf_lmax=lmax, scf_a=1.0,
            save_snapshots=False, verbose=verbose, output_dir=out_dir)
        wall = time.perf_counter() - t0
    final = res["dark"]
    ke1, pe1 = energy(final)
    e0, e1 = ke0 + pe0, ke1 + pe1
    return _emit({
        "metric": "scf_abs_dE_over_E", "value": abs((e1 - e0) / e0),
        "steps": steps, "n": n, "nmax": nmax, "lmax": lmax,
        "ms_per_step": 1e3 * wall / steps, "Q0": ke0 / abs(pe0),
        "Q1": ke1 / abs(pe1), "wall_s": wall,
        "finite": bool(np.isfinite(final).all())}, device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "speed"
    modes = {"speed": run_speed, "ladder": run_ladder, "drift": run_drift}
    if mode not in modes:
        raise SystemExit(f"mode must be one of {sorted(modes)}, got {mode!r}")
    modes[mode]()


if __name__ == "__main__":
    main()
