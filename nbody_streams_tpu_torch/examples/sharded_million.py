"""Ring-sharded direct summation at large N.

Over every visible card, named in `devices=`, this runs the exact
O(N^2/D) ring of shards (`method='tree'`, parallel/sharded.py); on one
card `method='tree'` is the direct path.  `cpu` as the second argument runs 8 virtual CPU shards
instead (tiny N!).

Run:  python nbody_streams_tpu_torch/examples/sharded_million.py [N] [cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import time

import torch

from nbody_streams_tpu_torch import Species, make_plummer_sphere, run_simulation
from nbody_streams_tpu_torch.parallel.sharded import slab_sort_for_sharding

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
ON_CPU = len(sys.argv) > 2 and sys.argv[2] == "cpu"
if ON_CPU:
    ARCH, DEVICES = "cpu", ["cpu"] * 8
else:
    # every visible card (without one run_simulation raises, naming the
    # CPU option)
    ARCH = "auto"
    DEVICES = [f"cuda:{i}" for i in range(torch.cuda.device_count())] or None
count = len(DEVICES or ())
print(f"{count} device(s): {'cpu' if ON_CPU else 'cuda'}")

xv, masses = make_plummer_sphere(N, M_total=1e10, a=2.0, seed=3)

# slab-sort before sharding: each shard then owns a thin x-slab, so
# non-adjacent ring blocks take the compact-support Newtonian fast path
xv, masses = slab_sort_for_sharding(xv, masses)
species = [Species.dark(N=N, mass=float(masses[0]), softening=0.1)]

t0 = time.perf_counter()
result = run_simulation(
    xv, species, 0.0, 10 * 1e-4, 1e-4,
    architecture=ARCH,
    method="tree",            # = the ring over more than one device
    devices=DEVICES,
    save_snapshots=False, verbose=True,
    output_dir="./output_sharded",
)
wall = time.perf_counter() - t0
rate = N * N * 10 / wall / 1e9
print(f"10 steps at N={N:,} on {count} device(s): {wall:.1f} s "
      f"({rate:.1f} Gint/s aggregate)")
