"""Plummer-sphere stability test (the reference's headline example,
examples/plummer_stability_gpu_tree.ipynb): integrate an equilibrium
Plummer sphere and verify energy conservation and a stable density
profile.

Run:  python nbody_streams_tpu_torch/examples/plummer_stability.py [N]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import time

import numpy as np

from nbody_streams_tpu_torch import (
    G_DEFAULT,
    Species,
    make_plummer_sphere,
    run_simulation,
)
from nbody_streams_tpu_torch.utils.main import empirical_density_profile

N = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
DT = 2e-5
STEPS = 1000

xv, masses = make_plummer_sphere(N, M_total=1e9, a=1.0, seed=1)
species = [Species.dark(N=N, mass=float(masses[0]), softening=0.05)]

r0, rho0, _ = empirical_density_profile(xv[:, :3], masses, bins=20,
                                        r_min=0.1, r_max=10.0)

t0 = time.perf_counter()
result = run_simulation(
    xv, species, 0.0, STEPS * DT, DT,
    architecture="auto", method="direct",
    save_snapshots=False, verbose=True, debug_energy=True,
    output_dir="./output_plummer",
)
wall = time.perf_counter() - t0

xv1 = result["dark"]
r1, rho1, _ = empirical_density_profile(xv1[:, :3], masses, bins=20,
                                        r_min=0.1, r_max=10.0)
# only bins populated in the reference profile (small-N runs leave
# empty outer bins -> 0/0)
ok = rho0 > 0
drift = np.nanmax(np.abs(rho1[ok] / rho0[ok] - 1.0))
print(f"\n{STEPS} steps at N={N:,}: {wall:.1f} s "
      f"({1e3 * wall / STEPS:.1f} ms/step)")
print(f"max density-profile drift: {100 * drift:.1f}%")
