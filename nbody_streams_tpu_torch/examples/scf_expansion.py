"""SCF expansion-tier demo: million-particle self-gravity in milliseconds.

The reference framework's answer to "N > 2M is too slow for direct
summation" is its Barnes-Hut GPU tree (README.md:848-855, ~1-2 s per
force call at 2M, 1-5% force error).  The expansion tier here is the
Hernquist-Ostriker basis expansion (`method='scf'`, ops/scf.py): the
particle density is projected onto a biorthogonal basis and the smooth
truncated field evaluated back — two dense float32 matmul passes,
O(N·terms) per step.

This demo
1. integrates an equilibrium Plummer sphere with `method='scf'` and
   checks energy conservation of the truncated (but conservative) field,
2. measures the per-force rate vs the exact direct tier at the same N,
3. prints the accuracy ladder: median relative force error vs the exact
   direct sum as (nmax, lmax) grows — showing truncation order is the
   accuracy dial, and that (8, 4) sits in the reference tree's 1-5%
   class.

Run:  python nbody_streams_tpu_torch/examples/scf_expansion.py [N] [steps] [architecture]
Defaults: N=200_000, steps=400, architecture='auto' (the card; 'cpu'
runs the same demo on the CPU).
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from nbody_streams_tpu_torch import Species, make_plummer_sphere, run_simulation
from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
from nbody_streams_tpu_torch.ops.scf import SCFGravity

N = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 400
ARCH = sys.argv[3] if len(sys.argv) > 3 else "auto"
DEVICE = "cpu" if ARCH == "cpu" else "cuda"
DT = 2e-5
SOFT = 0.05

xv, masses = make_plummer_sphere(N, M_total=1e9, a=1.0, seed=4)
species = [Species.dark(N=N, mass=float(masses[0]), softening=SOFT)]

# ── 1. Integrate with the expansion field ────────────────────────────────────
t0 = time.perf_counter()
result = run_simulation(
    xv, species, 0.0, STEPS * DT, DT,
    architecture=ARCH, method="scf", scf_nmax=8, scf_lmax=4,
    save_snapshots=False, verbose=True, debug_energy=True,
    output_dir="./output_scf_demo", overwrite=True,
)
wall = time.perf_counter() - t0
print(f"scf run: {STEPS} steps in {wall:.1f} s "
      f"({1e3 * wall / STEPS:.1f} ms/step incl. energy diagnostics)")


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ── 2. Per-force-eval rate vs the exact direct tier ─────────────────────────
pos32 = torch.tensor(xv[:, :3], dtype=torch.float32, device=DEVICE)
scf = SCFGravity(masses, a=1.0, nmax=8, lmax=4, device=DEVICE)
direct = DirectGravity(masses, np.full(N, SOFT), device=DEVICE)
for name, solver in (("scf (8,4)", scf), ("direct", direct)):
    solver.accel(pos32)   # warm-up (the kernels build at first use)
    sync()
    t0 = time.perf_counter()
    solver.accel(pos32)
    sync()
    print(f"  {name:10s}: {1e3 * (time.perf_counter() - t0):8.2f} ms/force eval")

# ── 3. Accuracy ladder vs the exact direct sum ───────────────────────────────
a_ref = direct.accel(pos32).double().cpu().numpy()
ref_norm = np.linalg.norm(a_ref, axis=1)
print("  (nmax, lmax)  terms  median rel force err")
for nmax, lmax in ((2, 0), (4, 2), (8, 4), (12, 6)):
    s = SCFGravity(masses, a=1.0, nmax=nmax, lmax=lmax, device=DEVICE)
    a = s.accel(pos32).double().cpu().numpy()
    err = np.median(np.linalg.norm(a - a_ref, axis=1) / ref_norm)
    print(f"  ({nmax:2d}, {lmax:1d})      {s.terms:5d}  {err:.3f}")
