"""The north-star scale gates on the card, one JSON line each.

    python -m nbody_streams_tpu_torch.benchmarks.northstar {argsort,gate2m,gate1m}
    python -m nbody_streams_tpu_torch.benchmarks.northstar gate1m \
        [--steps N] [--target-drift X] [--out DIR]

Counterpart of the repo's ``benchmarks/northstar.py``:

* ``argsort``: the sorted path's slab sort (a stable ``torch.argsort`` of
  the x key) at N = 2M, ms a sort (CUDA events: one warm call, then the
  median of 5);
* ``gate2m``: N = 2,097,152 Plummer, 100 KDK steps through
  ``run_simulation`` with snapshots, restarts and ``debug_energy`` on, and
  |dE/E| from a float64 energy bracket on the host;
* ``gate1m``: N = 1,048,576 Plummer, 1,000 steps, the |dE/E| < 1e-4 gate;
  a rerun resumes from the restart file a stopped attempt left.
  ``--steps`` cuts the depth, ``--target-drift`` goes to the solver,
  ``--out`` names the output directory.

The energy bracket sums KE and 0.5 sum m phi in float64 on the host, phi
from ``DirectGravity(impl='cuda')`` (the kernels' potential form).  The
JSON keys are the TPU script's (``peak_hbm_gb`` is
``torch.cuda.max_memory_allocated`` since the gate began).  The warm-ups
are runs of 2 steps: they only build and first-launch the kernels (the
TPU script's filled XLA's compile cache).  The TPU script's supervisor is
not ported.  Without a CUDA device each gate raises unless given
``device='cpu'``; without h5py the command line runs gate2m with
snapshots off and says so.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device

OUT_2M = "./output_northstar_2m"
OUT_1M = "./output_northstar_1m"
DT = 2e-5
SOFTENING = 0.05
WARMUP_STEPS = 2


def _device(device):
    """The card unless the caller asks for the CPU."""
    return resolve_device("cuda" if device is None else device)


def _arch(device):
    return "gpu" if device.type == "cuda" else "cpu"


def _peak_gb(device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _name(device):
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _emit(rec):
    print(json.dumps(rec), flush=True)
    return rec


def energy_bracket(masses, device):
    """``energy(phase_space) -> (KE, PE)`` in float64 on the host, with phi
    from the kernels' self-masked potential at h = SOFTENING on
    ``device``."""
    from ..ops.dispatch import DirectGravity

    solver = DirectGravity(masses, np.full(len(masses), SOFTENING),
                           impl="cuda", device=device)

    def energy(arr):
        pos = torch.tensor(arr[:, :3], dtype=torch.float32, device=device)
        vel = np.asarray(arr[:, 3:], np.float64)
        phi = solver.potential(pos).double().cpu().numpy()
        ke = 0.5 * (masses * (vel ** 2).sum(1)).sum()
        pe = 0.5 * (masses * phi).sum()
        return ke, pe

    return energy


def _plummer(n, seed):
    from ..ic import make_plummer_sphere
    from ..species import Species

    xv, masses = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=seed)
    species = [Species.dark(N=n, mass=float(masses[0]), softening=SOFTENING)]
    return xv, masses, species


def run_argsort(n=2_097_152, device=None):
    """ms of the sorted path's slab sort (``slab_sort_key``: a stable
    ``torch.argsort`` of the x key) of n particles: one warm call, then the
    median of 5, each timed by CUDA events (the host clock on the CPU)."""
    from ..ops.cuda_direct import slab_sort_key

    device = _device(device)
    rng = np.random.default_rng(0)
    pos = torch.tensor(rng.normal(0, 1, (n, 3)), dtype=torch.float32,
                       device=device)
    slab_sort_key(pos)
    times = []
    for _ in range(5):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            slab_sort_key(pos)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            slab_sort_key(pos)
            times.append((time.perf_counter() - t0) * 1e3)
    per_sort = float(np.median(times))
    _emit({"metric": "argsort_2m_ms", "value": per_sort, "unit": "ms",
           "n": n, "device": _name(device)})
    return per_sort


def run_gate2m(n=2_097_152, steps=100, device=None, out=OUT_2M,
               save_snapshots=True):
    """N = 2M Plummer through ``run_simulation`` with snapshots, restarts
    and ``debug_energy``; returns the JSON record."""
    from ..sim import run_simulation

    device = _device(device)
    _reset_peak(device)
    out_dir = Path(out)
    xv, masses, species = _plummer(n, seed=1)
    energy = energy_bracket(masses, device)
    ke0, pe0 = energy(xv)
    kw = dict(architecture=_arch(device), method="direct", impl="cuda",
              restart_interval=50, debug_energy=True, verbose=True,
              overwrite=True, step_timeout_s=120,
              save_snapshots=save_snapshots)
    # warm-up: builds and first-launches the kernels
    run_simulation(xv, species, 0.0, WARMUP_STEPS * DT, DT, snapshots=2,
                   output_dir=str(out_dir) + "_warmup", **kw)
    t0 = time.perf_counter()
    res = run_simulation(xv, species, 0.0, steps * DT, DT, snapshots=3,
                         output_dir=str(out_dir), **kw)
    wall = time.perf_counter() - t0
    ke1, pe1 = energy(res["dark"])
    e0, e1 = ke0 + pe0, ke1 + pe1
    return _emit({
        "metric": "gate2m_ms_per_step", "value": 1e3 * wall / steps,
        "unit": "ms/step", "steps": steps, "n": n,
        "gint_per_s": n * n * steps / wall / 1e9,
        "abs_dE_over_E": abs((e1 - e0) / e0),
        "Q0": ke0 / abs(pe0), "Q1": ke1 / abs(pe1),
        "peak_hbm_gb": _peak_gb(device),
        "wall_s": wall,
        "snapshots": sorted(p.name for p in out_dir.glob("snapshot*")),
        "restart": (out_dir / "restart.npz").exists(),
        "device": _name(device),
    })


def run_gate1m(n=1_048_576, steps=1000, device=None, out=OUT_1M,
               target_drift=None):
    """N = 1M Plummer over ``steps`` steps, the |dE/E| < 1e-4 gate,
    resuming from a restart file an earlier attempt left; returns the JSON
    record.  ``target_drift`` goes to the solver (``DirectGravity``)."""
    from ..sim import run_simulation

    device = _device(device)
    _reset_peak(device)
    out_dir = Path(out)
    xv, masses, species = _plummer(n, seed=2)
    energy = energy_bracket(masses, device)
    ke0, pe0 = energy(xv)
    # e0 comes from the deterministic ICs, so the bracket survives a resume
    start_step = 0
    resume = (out_dir / "restart.npz").exists()
    if resume:
        with np.load(out_dir / "restart.npz") as data:
            start_step = int(data["step"])
        resume = 0 < start_step < steps
    kw = dict(architecture=_arch(device), method="direct", impl="cuda",
              save_snapshots=False, verbose=True, step_timeout_s=60,
              target_drift=target_drift)
    if not resume:
        # warm-up: builds and first-launches the kernels
        run_simulation(xv, species, 0.0, WARMUP_STEPS * DT, DT,
                       overwrite=True, output_dir=str(out_dir) + "_warmup",
                       **kw)
    t0 = time.perf_counter()
    res = run_simulation(
        xv, species, 0.0, steps * DT, DT, output_dir=str(out_dir),
        restart_interval=100,
        **({"continue_run": True} if resume else {"overwrite": True}), **kw)
    wall = time.perf_counter() - t0
    stepped = steps - start_step if resume else steps
    ke1, pe1 = energy(res["dark"])
    e0, e1 = ke0 + pe0, ke1 + pe1
    return _emit({
        "metric": "gate1m_abs_dE_over_E", "value": abs((e1 - e0) / e0),
        "unit": "dimensionless", "steps": steps, "n": n,
        "ms_per_step": 1e3 * wall / stepped,
        "gint_per_s": n * n * stepped / wall / 1e9,
        "Q0": ke0 / abs(pe0), "Q1": ke1 / abs(pe1),
        "peak_hbm_gb": _peak_gb(device),
        "wall_s": wall, "resumed_from_step": start_step if resume else 0,
        "device": _name(device),
    })


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m nbody_streams_tpu_torch.benchmarks.northstar")
    ap.add_argument("mode", nargs="?", default="argsort",
                    choices=("argsort", "gate2m", "gate1m"))
    ap.add_argument("--steps", type=int, default=1000,
                    help="gate1m: KDK steps (default 1000)")
    ap.add_argument("--target-drift", type=float, default=None,
                    help="gate1m: the solver's target_drift")
    ap.add_argument("--out", default=OUT_1M,
                    help=f"gate1m: output directory (default {OUT_1M})")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.mode == "argsort":
        run_argsort()
    elif args.mode == "gate1m":
        run_gate1m(steps=args.steps, out=args.out,
                   target_drift=args.target_drift)
    else:
        have_h5py = importlib.util.find_spec("h5py") is not None
        if not have_h5py:
            print("h5py is not installed: gate2m runs with snapshots off "
                  "(the restart file is written)", flush=True)
        run_gate2m(save_snapshots=have_h5py)
    return 0


if __name__ == "__main__":
    sys.exit(main())
