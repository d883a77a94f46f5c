"""Force/potential evaluation (plain-torch oracle + hand-written CUDA path)."""
from .kernels import force_factor, potential_factor
from .pairwise import (
    compute_forces_direct,
    compute_potential_direct,
    accel_tile,
    potential_tile,
)
from .dispatch import DirectGravity

__all__ = [
    "force_factor",
    "potential_factor",
    "compute_forces_direct",
    "compute_potential_direct",
    "accel_tile",
    "potential_tile",
    "DirectGravity",
]
