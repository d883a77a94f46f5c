"""nbody_streams_tpu_torch — the direct N-body framework on PyTorch + CUDA.

The port of ``nbody_streams_tpu`` (JAX/Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper GPUs.  It keeps the JAX
package's module names and public surface, and imports neither jax nor the
JAX package.  It covers the direct-summation KDK path,
``run_simulation(method='direct')`` down to the all-pairs kernels in
``csrc/direct.cu``, external potentials (``potentials``: analytic,
Multipole, CylSpline, modifiers, GalPot, MW+LMC, fits), dynamical
friction (``friction``), DF sampling (``df``), King models
(``fast_sims.king``), the SCF tier (``ops/scf.py``,
``run_simulation(method='scf')``), and the measurement path
(``bench``, ``bench_suite``, ``benchmarks.tile_sweep``) with the
roofline kernels in ``csrc/roofline.cu``, stream generation
(``fast_sims``: orbits, particle spray, restricted N-body), coordinate
frames (``coords``), the analysis toolkit (``utils``: profiles, fits,
centres, unbinding), the reference's drop-in names (the one-card tree
tier in ``tree``, ``fields``, ``agama_helper``), SPH surface-density
maps and plots (``viz``), the host kNN library (``native``), the
``nbody-torch-run`` command line (``cli``) and the multi-device ring
(``parallel``: ``impl='sharded'``, ``method='tree'`` over a device list);
the kernels are built with
nvcc, the host library with g++, at first use.
"""
from .__version__ import __version__
from .constants import G_DEFAULT, NBODY_UNITS, KERNEL_IDS
from .species import Species, PerformanceWarning
from .ops import (
    DirectGravity,
    compute_forces_direct,
    compute_potential_direct,
)
from .ic import make_plummer_sphere, place_on_orbit
from .run import run_nbody, run_nbody_tpu, run_nbody_cpu, run_nbody_gpu
from .sim import run_simulation
from .nbody_io import ParticleReader
from .df import sample_quasispherical, sample_disk, eddington_df
from .friction import make_df_force_extra, ChandrasekharFriction
from . import fast_sims
from . import potentials
from . import utils
from . import coords
from . import viz
from . import parallel
from .utils.devices import get_device_info, device_alive
from . import agama_helper   # reference module-path alias -> potentials
from . import fields         # reference module-path alias -> ops
from . import tree_gpu       # reference module-path alias -> tree
from .tree import TreeGPU, tree_gravity_gpu, run_nbody_gpu_tree
from .fields import (
    compute_nbody_forces_gpu, compute_nbody_forces_cpu,
    compute_nbody_potential_gpu, compute_nbody_potential_cpu,
)

# Drop-in aliases for reference call sites (as nbody_streams_tpu's)
get_gpu_info = get_device_info
cuda_alive = device_alive

__all__ = [
    "__version__",
    "G_DEFAULT",
    "NBODY_UNITS",
    "KERNEL_IDS",
    "Species",
    "PerformanceWarning",
    "run_simulation",
    "run_nbody",
    "run_nbody_tpu",
    "run_nbody_cpu",
    "run_nbody_gpu",
    "ParticleReader",
    "potentials",
    "make_plummer_sphere",
    "place_on_orbit",
    "DirectGravity",
    "compute_forces_direct",
    "compute_potential_direct",
    "sample_quasispherical",
    "sample_disk",
    "eddington_df",
    "make_df_force_extra",
    "ChandrasekharFriction",
    "compute_nbody_forces_gpu",
    "compute_nbody_forces_cpu",
    "compute_nbody_potential_gpu",
    "compute_nbody_potential_cpu",
    "fast_sims",
    "utils",
    "coords",
    "viz",
    "parallel",
    "agama_helper",
    "fields",
    "tree_gpu",
    "get_device_info",
    "device_alive",
    "get_gpu_info",
    "cuda_alive",
    "TreeGPU",
    "tree_gravity_gpu",
    "run_nbody_gpu_tree",
]
