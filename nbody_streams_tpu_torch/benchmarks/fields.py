"""What one external-field evaluation costs on the card.

    python -m nbody_streams_tpu_torch.benchmarks.fields

Builds each field of :func:`field_builders` (MWPotential22,
McMillan17_streams, the MW+LMC evolving field, and a FIRE-like BFE from
the checkout's ``tests/data``), moves it to the card in float32 and times
``force`` at the ``N`` points of :func:`field_points`: the median and
least wall ms of ``REPS`` calls (host clock, each call ending in a
synchronize) and, from one more call under ``torch.profiler``, the CUDA
kernels it launched, their summed device time and that time over the
call's wall time (the card's busy share).  Prints one JSON line per
field.  ``chip_smoke.py`` phase (i) builds the same fields.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

#: the checkout this package sits in (its ``tests/data`` holds the
#: FIRE-like BFE fixtures)
ROOT = Path(__file__).resolve().parents[2]
#: first time of the MW+LMC field (a table node)
T_LMC = -1.0
#: points a force evaluation, and timed calls a field
N = 65536
REPS = 15


def field_builders():
    """{name: (builder, times)}: the four fields, built on the CPU in
    float64 from this package's data directory and ``ROOT / 'tests' /
    'data'``, at the times they are evaluated (the MW+LMC field at a table
    node and between nodes)."""
    from .. import potentials as P

    data = Path(__file__).resolve().parents[1] / "data" / "potentials"
    fire = ROOT / "tests" / "data"
    return {
        "MWPotential22": (lambda: P.load_potential_ini(
            data / "MWPotential22.ini", device="cpu"), (0.0,)),
        "McMillan17_streams": (lambda: P.make_potential(
            file=data / "MW_LMC_evolv" / "McMillan17_streams.ini",
            device="cpu"), (0.0,)),
        "MW+LMC": (lambda: P.load_mw_lmc_potential(
            data / "MW_LMC_evolv", device="cpu")[0], (T_LMC, -0.99, -0.5)),
        "FIRE BFE": (lambda: P.CompositePotential([
            P.MultipolePotential(str(fire / "600.dark.none_8.coef_mul_DR")),
            P.CylSplinePotential(
                str(fire / "600.bar.none_8.coef_cylsp_DR"))]), (0.0,)),
    }


def field_points(n, seed=11):
    """Points where the fields are evaluated: log-uniform radius in
    [0.05, 300] kpc, isotropic, with the origin, two z-axis points and one
    1e-3 kpc off the axis first (float32)."""
    rng = np.random.default_rng(seed)
    r = 10.0 ** rng.uniform(np.log10(0.05), np.log10(300.0), n)
    v = rng.normal(size=(n, 3))
    x = r[:, None] * v / np.linalg.norm(v, axis=1)[:, None]
    x[:4] = [[0, 0, 0], [0, 0, 5], [0, 0, -2], [1e-3, 0, 3]]
    return x.astype(np.float32)


def profile_call(fn, reps=REPS):
    """Wall ms (median, least) of ``reps`` calls of ``fn`` after one
    warm-up, each ending in a synchronize; then, from one call under
    torch.profiler, its CUDA kernels, their summed device ms and that
    over the profiled call's wall ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    return dict(wall_median_ms=float(np.median(walls)),
                wall_min_ms=float(min(walls)), launches=len(kernels),
                device_ms=device_ms, busy_share=device_ms / wall)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("benchmarks.fields times the card: torch sees no "
                         "CUDA device")
    dev = torch.device("cuda")
    x = torch.tensor(field_points(N), device=dev)
    for name, (build, times) in field_builders().items():
        pot = build().to(dev, torch.float32)
        rec = profile_call(lambda: pot.force(x, times[0]))
        print(json.dumps({"metric": "external_force", "field": name,
                          "n": N, "t": times[0], **rec,
                          "device": torch.cuda.get_device_name(dev)}),
              flush=True)


if __name__ == "__main__":
    main()
