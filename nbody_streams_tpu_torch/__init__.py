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
roofline kernels in ``csrc/roofline.cu``; the kernels are built with
nvcc at first use.
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
from .run import run_nbody
from .sim import run_simulation
from .nbody_io import ParticleReader
from .df import sample_quasispherical, sample_disk, eddington_df
from .friction import make_df_force_extra, ChandrasekharFriction
from . import fast_sims
from . import potentials

__all__ = [
    "__version__",
    "G_DEFAULT",
    "NBODY_UNITS",
    "KERNEL_IDS",
    "Species",
    "PerformanceWarning",
    "run_simulation",
    "run_nbody",
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
    "fast_sims",
]
