"""Unified multi-species simulation entry point.

Counterpart of ``nbody_streams_tpu/sim.py`` for ``method='direct'``: species
validation and assembly, kwarg routing, then ``run_nbody`` (with an
``external_potential``, e.g. from ``nbody_streams_tpu_torch.potentials``).
The other methods and dynamical friction are not ported yet and raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import numpy as np

from .constants import G_DEFAULT
from .run import run_nbody
from .species import (
    Species,
    _build_particle_arrays,
    _emit_performance_warnings,
    _split_by_species,
    _validate_species,
)

__all__ = ["run_simulation"]

_DIRECT_KW = {
    "precision", "kernel", "external_update_interval", "impl", "devices",
    "block_size", "nan_check", "step_timeout_s", "profile_dir",
    "target_drift",
}

_NOT_PORTED = {
    "tree": "method='tree' (the multi-device ring) is not ported yet "
            "(ROADMAP.md Queue 1 item 8)",
    "scf": "method='scf' is not ported yet (ROADMAP.md Queue 1 item 7)",
}


def run_simulation(
    phase_space: np.ndarray,
    species: list[Species],
    time_start: float,
    time_end: float,
    dt: float,
    G: float = G_DEFAULT,
    architecture: str = "auto",
    method: str = "direct",
    external_potential=None,
    dynamical_friction: bool = False,
    output_dir: str = "./output",
    save_snapshots: bool = True,
    snapshots: int = 100,
    num_files_to_write: int = 1,
    restart_interval: int = 1000,
    continue_run: bool = False,
    overwrite: bool = False,
    verbose: bool = True,
    debug_energy: bool = False,
    **kwargs,
) -> dict[str, np.ndarray]:
    """Run a multi-species N-body simulation; returns {name: (N_k, 6)}.

    The surface of ``nbody_streams_tpu.run_simulation``; here
    ``architecture`` is 'gpu' or 'auto' (a CUDA device; each raises without
    one) or 'cpu', and ``method`` is 'direct'.
    """
    phase_space = np.asarray(phase_space, np.float64)
    if phase_space.ndim != 2 or phase_space.shape[1] != 6:
        raise ValueError(
            f"phase_space must be (N, 6), got {phase_space.shape}")
    if architecture not in ("cpu", "gpu", "auto"):
        raise ValueError(
            f"architecture must be 'cpu', 'gpu' or 'auto', got "
            f"{architecture!r}")
    if method in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[method])
    if method != "direct":
        raise ValueError(
            f"method must be 'direct', 'tree' or 'scf', got {method!r}")
    if dynamical_friction:
        raise NotImplementedError(
            "dynamical friction is not ported yet (ROADMAP.md Queue 1 "
            "item 6)")

    _validate_species(phase_space, species)
    mass_arr, soft_arr = _build_particle_arrays(species)
    _emit_performance_warnings(phase_space.shape[0], architecture, method)

    kw = dict(kwargs)
    direct_kwargs = {k: kw.pop(k) for k in list(kw) if k in _DIRECT_KW}
    for legacy in ("theta", "nleaf", "ncrit", "level_split", "nthreads"):
        if legacy in kw:
            kw.pop(legacy)
            if verbose:
                print(f"note: {legacy!r} has no effect (direct summation "
                      "is exact)")
    if kw:
        raise TypeError(f"Unknown keyword arguments: {sorted(kw)}")

    xv_final = run_nbody(
        phase_space,
        mass_arr,
        time_start,
        time_end,
        dt,
        softening=soft_arr,
        G=G,
        output_dir=output_dir,
        save_snapshots=save_snapshots,
        snapshots=snapshots,
        num_files_to_write=num_files_to_write,
        restart_interval=restart_interval,
        continue_run=continue_run,
        overwrite=overwrite,
        verbose=verbose,
        debug_energy=debug_energy,
        species=species,
        architecture=architecture,
        external_potential=external_potential,
        **direct_kwargs,
    )
    return _split_by_species(xv_final, species)
