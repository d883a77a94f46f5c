"""The MW + LMC evolving-potential workflow (Vasiliev+2021 style).

Native build of the reference's flagship stream-modelling setup
(reference: examples/MW_LMC_evolv.ipynb + data/potentials/MW_LMC_evolv/):
the Milky Way potential stays at the origin of a *non-inertial* frame
that accelerates toward the infalling LMC, so the total field is

    Phi(x, t) = Phi_MW(x) + Phi_LMC(x - x_LMC(t)) - a_MW(t) . x

with x_LMC(t) the LMC trajectory relative to the MW centre and
a_MW(t) the MW-centre acceleration induced by the LMC (both tabulated;
the shipped tables were produced by the mutual MW-LMC orbit integration
in the reference notebook).  The combined field is one torch module,
built on the card by default; the LMC trajectory and the frame
acceleration are evaluated at the step's host time.

Counterpart of ``nbody_streams_tpu/potentials/mwlmc.py``; the fixture
directory is this package's own copy.  The reference builds the MW/LMC
components through Agama
(`agama.Potential(file=...)`); here they go through the native GalPot
builders (potentials/galpot.py), so the whole workflow runs without
Agama.  Time unit: kpc/(km/s) ~ 0.978 Gyr, matching the shipped tables
(t = 0 is the present day; the tables cover t in [-10, 0]).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .analytic import UniformAcceleration
from .base import CompositePotential, Potential, resolve_device
from .factory import make_potential
from .modifiers import ShiftedPotential

__all__ = ["mw_lmc_data_dir", "load_mw_lmc_potential"]


def mw_lmc_data_dir() -> Path:
    """The shipped MW_LMC_evolv fixture directory."""
    return Path(__file__).resolve().parent.parent / "data" / "potentials" \
        / "MW_LMC_evolv"


def load_mw_lmc_potential(base_dir=None,
                          mw_ini: str = "McMillan17_streams.ini",
                          lmc_ini: str = "LMC_vasiliev21.ini",
                          traj_file: str = "trajLMC_McM17streams",
                          acc_file: str = "accMW_McM17streams",
                          include_frame_acceleration: bool = True,
                          device="cuda"):
    """Build the evolving MW + moving LMC potential.

    Returns (potential, trajLMC) where trajLMC is the raw (T, 7) table
    [t, x, y, z, vx, vy, vz] of the LMC centre (useful for plotting and
    for placing progenitors relative to the LMC).  The field is built on
    ``device``: the card unless the caller passes ``device='cpu'``.
    """
    device = resolve_device(device)
    base = Path(base_dir) if base_dir is not None else mw_lmc_data_dir()
    mw = make_potential(file=base / mw_ini, device="cpu")
    lmc = make_potential(file=base / lmc_ini, device="cpu")
    traj = np.loadtxt(base / traj_file)
    if traj.ndim != 2 or traj.shape[1] != 7:
        raise ValueError(f"{traj_file}: expected (T, 7) [t, xv] rows, "
                         f"got {traj.shape}")
    parts: list[Potential] = [mw, ShiftedPotential(lmc, traj)]
    if include_frame_acceleration:
        acc = np.loadtxt(base / acc_file)
        parts.append(UniformAcceleration(table=acc))
    return CompositePotential(parts).to(device), traj
