"""Import-path alias for reference call sites.

Counterpart of ``nbody_streams_tpu/agama_helper.py``: the reference
packages its BFE/potential layer as ``nbody_streams.agama_helper``; here
the same surface lives in :mod:`nbody_streams_tpu_torch.potentials`.
This module re-exports the reference-public names so that

    from nbody_streams_tpu_torch.agama_helper import fit_potential
    import nbody_streams_tpu_torch.agama_helper as agama_helper

work unchanged after the package rename.  New code should import from
:mod:`nbody_streams_tpu_torch.potentials` directly.
"""
from .potentials import (  # noqa: F401
    PotentialGPU,
    create_snapshot_dict,
    fit_potential,
    write_coef_to_h5,
    write_snapshot_coefs_to_h5,
    read_coefs,
    read_coef_string,
    MultipoleCoefs,
    CylSplineCoefs,
    generate_lmax_pairs,
    load_agama_potential,
    load_agama_evolving_potential,
    create_evolving_ini,
    load_fire_pot,
    read_snapshot_times,
    create_fire_evolving_ini,
    # class aliases (reference _analytic_potentials.py / _potential.py)
    NFWPotentialGPU,
    PlummerPotentialGPU,
    HernquistPotentialGPU,
    DehnenSphericalPotentialGPU,
    IsochronePotentialGPU,
    MiyamotoNagaiPotentialGPU,
    LogHaloPotentialGPU,
    DiskAnsatzPotentialGPU,
    UniformAccelerationGPU,
    AnalyticPotentialGPU,
    MultipolePotentialGPU,
    CylSplinePotentialGPU,
    CompositePotentialGPU,
    EvolvingPotentialGPU,
    ShiftedPotentialGPU,
    ScaledPotentialGPU,
)

__all__ = [
    "PotentialGPU",
    "create_snapshot_dict",
    "fit_potential",
    "write_coef_to_h5",
    "write_snapshot_coefs_to_h5",
    "read_coefs",
    "read_coef_string",
    "MultipoleCoefs",
    "CylSplineCoefs",
    "generate_lmax_pairs",
    "load_agama_potential",
    "load_agama_evolving_potential",
    "create_evolving_ini",
    "load_fire_pot",
    "read_snapshot_times",
    "create_fire_evolving_ini",
    "NFWPotentialGPU",
    "PlummerPotentialGPU",
    "HernquistPotentialGPU",
    "DehnenSphericalPotentialGPU",
    "IsochronePotentialGPU",
    "MiyamotoNagaiPotentialGPU",
    "LogHaloPotentialGPU",
    "DiskAnsatzPotentialGPU",
    "UniformAccelerationGPU",
    "AnalyticPotentialGPU",
    "MultipolePotentialGPU",
    "CylSplinePotentialGPU",
    "CompositePotentialGPU",
    "EvolvingPotentialGPU",
    "ShiftedPotentialGPU",
    "ScaledPotentialGPU",
]
