"""External potentials: analytic, BFE (Multipole/CylSpline), modifiers.

Counterpart of ``nbody_streams_tpu/potentials``, with the same public
names: every evaluator is a torch ``nn.Module`` (``potential``/``force``/
``density``/``forceDeriv`` with Agama conventions) whose tables are
buffers, so ``.to(device, dtype)`` puts a whole field on the card.  The
classes build on the CPU, as every ``nn.Module`` does; the loaders and
the ``*GPU`` names take ``device=`` and build on the card unless the
caller passes ``device='cpu'`` (without a card they raise).  Pass a field
to ``run_simulation(external_potential=...)``; the run moves it to its
device and state dtype.
"""
from .base import Potential, CompositePotential, resolve_device
from .analytic import (
    NFWPotential,
    PlummerPotential,
    HernquistPotential,
    DehnenPotential,
    IsochronePotential,
    MiyamotoNagaiPotential,
    LogHaloPotential,
    DiskAnsatzPotential,
    UniformAcceleration,
    AnalyticPotential,
)
from .multipole import MultipolePotential
from .cylspline import CylSplinePotential
from .modifiers import ShiftedPotential, ScaledPotential, EvolvingPotential
from .coefs import (
    MultipoleCoefs,
    CylSplineCoefs,
    read_mult_coefs,
    read_cylspl_coefs,
    read_coefs,
    generate_lmax_pairs,
)
from .io import (
    write_coef_to_h5,
    write_snapshot_coefs_to_h5,
    read_coef_string,
)
from .load import (
    load_potential,
    load_evolving_potential,
    load_agama_potential,
    load_agama_evolving_potential,
)
from .fit import (
    fit_potential,
    fit_multipole_from_particles,
    fit_cylspline_from_particles,
    create_snapshot_dict,
)
from .factory import make_potential, load_potential_ini
from .fire import (
    read_snapshot_times,
    create_evolving_ini,
    create_fire_evolving_ini,
    load_fire_pot,
)
from .mwlmc import load_mw_lmc_potential, mw_lmc_data_dir


def _on_card(cls, name):
    """``cls`` under its reference name ``name``: the same constructor
    with ``device=``, building on the card unless the caller passes
    ``device='cpu'``."""
    def __init__(self, *args, device="cuda", **kwargs):
        device = resolve_device(device)
        cls.__init__(self, *args, **kwargs)
        self.to(device)

    return type(name, (cls,), {"__init__": __init__, "__module__": __name__,
                               "__doc__": cls.__doc__})


# Drop-in names for reference call sites.  The reference exposes its
# evaluators under *GPU names (agama_helper/_potential.py,
# _analytic_potentials.py); each takes the native class's constructor
# forms and builds on the card.
PotentialTPU = make_potential
PotentialGPU = make_potential
NFWPotentialGPU = _on_card(NFWPotential, "NFWPotentialGPU")
PlummerPotentialGPU = _on_card(PlummerPotential, "PlummerPotentialGPU")
HernquistPotentialGPU = _on_card(HernquistPotential, "HernquistPotentialGPU")
DehnenSphericalPotentialGPU = _on_card(DehnenPotential,
                                       "DehnenSphericalPotentialGPU")
IsochronePotentialGPU = _on_card(IsochronePotential, "IsochronePotentialGPU")
MiyamotoNagaiPotentialGPU = _on_card(MiyamotoNagaiPotential,
                                     "MiyamotoNagaiPotentialGPU")
LogHaloPotentialGPU = _on_card(LogHaloPotential, "LogHaloPotentialGPU")
DiskAnsatzPotentialGPU = _on_card(DiskAnsatzPotential,
                                  "DiskAnsatzPotentialGPU")
UniformAccelerationGPU = _on_card(UniformAcceleration,
                                  "UniformAccelerationGPU")


def AnalyticPotentialGPU(type: str, device="cuda", **kwargs):
    """:func:`AnalyticPotential`, built on ``device`` (the card unless the
    caller passes ``device='cpu'``)."""
    device = resolve_device(device)
    return AnalyticPotential(type, **kwargs).to(device)



CompositePotentialGPU = _on_card(CompositePotential, "CompositePotentialGPU")
MultipolePotentialGPU = _on_card(MultipolePotential, "MultipolePotentialGPU")
CylSplinePotentialGPU = _on_card(CylSplinePotential, "CylSplinePotentialGPU")
ShiftedPotentialGPU = _on_card(ShiftedPotential, "ShiftedPotentialGPU")
ScaledPotentialGPU = _on_card(ScaledPotential, "ScaledPotentialGPU")
EvolvingPotentialGPU = _on_card(EvolvingPotential, "EvolvingPotentialGPU")

__all__ = [
    "Potential",
    "CompositePotential",
    "NFWPotential",
    "PlummerPotential",
    "HernquistPotential",
    "DehnenPotential",
    "IsochronePotential",
    "MiyamotoNagaiPotential",
    "LogHaloPotential",
    "DiskAnsatzPotential",
    "UniformAcceleration",
    "AnalyticPotential",
    "MultipolePotential",
    "CylSplinePotential",
    "ShiftedPotential",
    "ScaledPotential",
    "EvolvingPotential",
    "MultipoleCoefs",
    "CylSplineCoefs",
    "read_mult_coefs",
    "read_cylspl_coefs",
    "read_coefs",
    "generate_lmax_pairs",
    "write_coef_to_h5",
    "write_snapshot_coefs_to_h5",
    "read_coef_string",
    "load_potential",
    "load_evolving_potential",
    "load_agama_potential",
    "load_agama_evolving_potential",
    "create_snapshot_dict",
    "fit_potential",
    "fit_multipole_from_particles",
    "fit_cylspline_from_particles",
    "make_potential",
    "load_potential_ini",
    "read_snapshot_times",
    "create_evolving_ini",
    "create_fire_evolving_ini",
    "load_fire_pot",
    "load_mw_lmc_potential",
    "mw_lmc_data_dir",
    "PotentialTPU",
    "PotentialGPU",
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
    "CompositePotentialGPU",
    "MultipolePotentialGPU",
    "CylSplinePotentialGPU",
    "ShiftedPotentialGPU",
    "ScaledPotentialGPU",
    "EvolvingPotentialGPU",
]
