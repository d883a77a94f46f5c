"""Particle species definitions for multi-species simulations.

API-compatible with the reference framework's ``nbody_streams.species``
(reference: species.py:24-210): a :class:`Species` dataclass with
scalar-or-array mass/softening, convenience constructors, and internal
helpers used by :func:`nbody_streams_tpu_torch.sim.run_simulation` to build
concatenated per-particle arrays and to split results back out.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Union

import numpy as np

__all__ = ["Species", "PerformanceWarning"]


class PerformanceWarning(UserWarning):
    """Emitted when a particle count exceeds a recommended threshold."""


def _as_per_particle(value, n: int, what: str, name: str) -> np.ndarray:
    """Expand a scalar or validate an (N,) array; always float64."""
    if np.isscalar(value):
        return np.full(n, float(value), dtype=np.float64)
    arr = np.asarray(value, dtype=np.float64)
    if arr.shape != (n,):
        raise ValueError(
            f"Species {name!r}: {what} array shape {arr.shape} != ({n},)"
        )
    return arr


@dataclass
class Species:
    """One particle species.

    Parameters
    ----------
    name : str
        Identifier ('dark', 'star', 'bh', or any non-empty string).
    N : int
        Particle count (> 0).
    mass : float or (N,) array
        Scalar = shared mass, array = per-particle masses (Msun).
    softening : float or (N,) array, optional
        Gravitational softening length(s) in kpc.  Default 0.
    """

    name: str
    N: int
    mass: Union[float, np.ndarray]
    softening: Union[float, np.ndarray] = 0.0

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise ValueError("Species name must be a non-empty string")
        if self.N <= 0:
            raise ValueError(
                f"Species {self.name!r}: N must be > 0, got {self.N}"
            )
        # Validate shapes eagerly (raises on mismatch).
        _as_per_particle(self.mass, self.N, "mass", self.name)
        _as_per_particle(self.softening, self.N, "softening", self.name)

    # -- convenience constructors ------------------------------------------
    @staticmethod
    def dark(N: int, mass, softening=0.0) -> "Species":
        """Dark-matter species."""
        return Species("dark", N, mass, softening)

    @staticmethod
    def star(N: int, mass, softening=0.0) -> "Species":
        """Stellar species."""
        return Species("star", N, mass, softening)

    # -- per-species arrays -------------------------------------------------
    def mass_array(self) -> np.ndarray:
        return _as_per_particle(self.mass, self.N, "mass", self.name)

    def softening_array(self) -> np.ndarray:
        return _as_per_particle(self.softening, self.N, "softening", self.name)


# ---------------------------------------------------------------------------
# Internal helpers (importable, not in __all__)
# ---------------------------------------------------------------------------

def _build_particle_arrays(species: list[Species]):
    """Concatenate per-particle (mass, softening) arrays in species order."""
    mass = np.concatenate([s.mass_array() for s in species])
    soft = np.concatenate([s.softening_array() for s in species])
    return mass, soft


def _validate_species(phase_space: np.ndarray, species: list[Species]) -> None:
    """Check species list consistency against the combined phase-space array."""
    if not species:
        raise ValueError("species list must not be empty")
    names = [s.name for s in species]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"Duplicate species names: {dupes}")
    n_total = sum(s.N for s in species)
    if n_total != phase_space.shape[0]:
        raise ValueError(
            f"sum(s.N for s in species) = {n_total} does not match "
            f"phase_space.shape[0] = {phase_space.shape[0]}"
        )


def _split_by_species(xv, species: list[Species]) -> dict:
    """Split a combined (N_total, 6) array into {name: (N_k, 6)} slices."""
    out = {}
    start = 0
    for s in species:
        out[s.name] = xv[start:start + s.N]
        start += s.N
    return out


def _emit_performance_warnings(n_total: int, architecture: str,
                               method: str) -> None:
    """Warn on particle counts beyond recommended thresholds.

    Thresholds follow the reference (species.py:177-210).
    """
    if architecture in ("auto", None):
        # 'auto' is the card, as run_nbody resolves it (it raises there
        # without one); an unresolved 'auto' would skip every
        # per-backend threshold below
        architecture = "gpu"
    if n_total > 2_000_000 and method not in ("tree", "scf"):
        warnings.warn(
            f"{n_total:,} particles: direct summation at this scale will be "
            "extremely slow. Consider a hierarchical method or more devices.",
            PerformanceWarning,
            stacklevel=4,
        )
    elif architecture == "cpu" and method == "direct" and n_total > 20_000:
        warnings.warn(
            f"{n_total:,} particles with CPU direct summation is O(N^2) and "
            "will be very slow. Consider architecture='gpu'.",
            PerformanceWarning,
            stacklevel=4,
        )
    elif architecture == "gpu" and method == "direct" \
            and n_total > 500_000:
        warnings.warn(
            f"{n_total:,} particles with single-GPU direct summation may be "
            "slow at this scale.",
            PerformanceWarning,
            stacklevel=4,
        )
