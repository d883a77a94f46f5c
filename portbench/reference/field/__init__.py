"""The benchmark's float64 reference of the evolving MW + LMC field.

The field is built again here from the raw files the program ships
(``data/potentials/MW_LMC_evolv``: two Agama INI files and the LMC's
trajectory and frame-acceleration tables), through frozen copies of the
program's GalPot, Multipole and modifier code, so that it takes no table
the program has made:

    Phi(x, t) = Phi_MW(x) + Phi_LMC(x - x_LMC(t)) - a_MW(t) . x
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .analytic import UniformAcceleration
from .base import CompositePotential
from .galpot import build_disk, build_spheroid
from .modifiers import ShiftedPotential

__all__ = ["load_mw_lmc", "parse_ini"]

# Agama INI keys (lower case) -> the builders' keyword names
_KEYS = {
    "densitynorm": "densityNorm", "mass": "mass",
    "scaleradius": "scaleRadius", "scaleheight": "scaleHeight",
    "gamma": "gamma", "beta": "beta", "alpha": "alpha",
    "axisratioz": "axisRatioZ", "outercutoffradius": "outerCutoffRadius",
    "innercutoffradius": "innerCutoffRadius",
    "surfacedensity": "surfaceDensity",
}
_BUILDERS = {"disk": build_disk, "spheroid": build_spheroid}


def parse_ini(path):
    """The ``[Potential ...]`` sections of an Agama INI file as a list of
    (type, {keyword: number}); only the Disk and Spheroid types the MW + LMC
    files use are accepted."""
    sections, cur = [], None
    for line in Path(path).read_text().splitlines():
        s = line.split("#")[0].strip()
        if not s:
            continue
        if s.startswith("["):
            cur = {} if s.lower().startswith("[potential") else None
            if cur is not None:
                sections.append(cur)
            continue
        if cur is not None and "=" in s:
            k, _, v = s.partition("=")
            cur[k.strip().lower()] = v.strip().rstrip(",").strip()
    out = []
    for sec in sections:
        kind = sec.pop("type").lower()
        if kind not in _BUILDERS:
            raise ValueError(f"{path}: unsupported potential type {kind!r}")
        out.append((kind, {_KEYS[k]: float(v) for k, v in sec.items()}))
    return out


def _build(path):
    parts = [_BUILDERS[kind](**kw) for kind, kw in parse_ini(path)]
    return parts[0] if len(parts) == 1 else CompositePotential(parts)


def load_mw_lmc(data_dir, device="cpu", dtype=None):
    """The MW + LMC field from ``data_dir``'s raw files, on ``device`` in
    ``dtype`` (float64 by default)."""
    import torch

    base = Path(data_dir)
    traj = np.loadtxt(base / "trajLMC_McM17streams")
    acc = np.loadtxt(base / "accMW_McM17streams")
    pot = CompositePotential([
        _build(base / "McMillan17_streams.ini"),
        ShiftedPotential(_build(base / "LMC_vasiliev21.ini"), traj),
        UniformAcceleration(table=acc),
    ])
    return pot.to(device=device, dtype=dtype or torch.float64)
