"""Potential factory: Agama-constructor-compatible entry point.

Counterpart of ``nbody_streams_tpu/potentials/factory.py``.

Reference-equivalent of ``PotentialGPU`` (reference: _potential.py:2620)
— one callable that accepts any of:

* ``type='NFW', mass=..., ...``         analytic dispatch
* ``type='Multipole'/'CylSpline'`` with ``file=`` or an inline
  ``coefficients=`` string
* ``file='pot.ini'``                     multi-section Agama INI files
  (inline Coefficients blocks, file= references, type=Evolving with
  Timestamps)
* a coefs dataclass, an existing Potential, or a list (-> Composite)
* modifiers ``center=`` (static/trajectory) and ``scale=``/``ampl=``
* Agama density types ``Disk``/``Spheroid``/``King``/``Sersic`` and
  triaxial ``Dehnen`` — built natively by the GalPot-style solvers in
  ``potentials/galpot.py`` (the reference materialises these *through
  the Agama C++ library*, _potential.py:2109-2232); this makes the
  shipped ``McMillan17.ini`` MW model load without Agama.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from .analytic import ANALYTIC_TYPE_MAP
from .base import CompositePotential, Potential, resolve_device
from .coefs import (
    CylSplineCoefs,
    MultipoleCoefs,
    read_coefs,
)
from .cylspline import CylSplinePotential
from .modifiers import EvolvingPotential, ScaledPotential, ShiftedPotential
from .multipole import MultipolePotential

__all__ = ["make_potential", "load_potential_ini"]

# camelCase canonical names for builder kwargs (shared by the
# GalPot-style and analytic branches — ONE table so a new kwarg cannot
# silently canonicalise on one path and fall through on the other)
_GALPOT_CANONICAL = {
    "densitynorm": "densityNorm", "mass": "mass",
    "scaleradius": "scaleRadius", "scaleheight": "scaleHeight",
    "alpha": "alpha", "beta": "beta", "gamma": "gamma",
    "axisratioy": "axisRatioY", "axisratioz": "axisRatioZ",
    "outercutoffradius": "outerCutoffRadius",
    "cutoffstrength": "cutoffStrength",
    "innercutoffradius": "innerCutoffRadius",
    "surfacedensity": "surfaceDensity", "sersicindex": "sersicIndex",
    "w0": "W0", "trunc": "trunc", "lmax": "lmax",
    "gridsizer": "gridSizeR", "rmin": "rmin", "rmax": "rmax",
    "ntheta": "n_theta", "g": "G",
    # analytic-only kwargs
    "velocity": "velocity", "v0": "velocity", "coreradius": "coreRadius",
    "ax": "ax", "ay": "ay", "az": "az",
}


def _galpot_kwargs(params: dict) -> dict:
    return {_GALPOT_CANONICAL.get(k, k): v for k, v in params.items()}


def _coerce(v: str):
    if isinstance(v, str):
        # Agama INI files may carry trailing commas on values
        # (e.g. 'mass = 1.5e11,' in LMC_vasiliev21.ini)
        v = v.strip().rstrip(",")
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v


def _apply_modifiers(pot: Potential, center=None, scale=None, ampl=None):
    # Scaled inside, Shifted OUTERMOST (Agama nesting, reference
    # _potential.py:2277-2305): Phi' = a s Phi(s (x - c)), so the center
    # is where the user said in unscaled coordinates
    if scale is not None or (ampl is not None and ampl != 1.0):
        pot = ScaledPotential(pot, scale if scale is not None else 1.0,
                              ampl=1.0 if ampl is None else float(ampl))
    if center is not None:
        if isinstance(center, (str, Path)):
            parts = re.split(r"[,\s]+", str(center).strip())
            if len(parts) == 3:
                try:
                    center = np.array([float(x) for x in parts])
                except ValueError:
                    center = np.loadtxt(center)   # a trajectory file
            else:
                center = np.loadtxt(center)
        else:
            center = np.asarray(center, float)
        pot = ShiftedPotential(pot, center)
    return pot


def _build_single(spec, base_dir: Path | None = None) -> Potential:
    """One potential from a dict of params / coefs / path / Potential."""
    if isinstance(spec, Potential):
        return spec
    if isinstance(spec, MultipoleCoefs):
        return MultipolePotential(spec)
    if isinstance(spec, CylSplineCoefs):
        return CylSplinePotential(spec)
    if isinstance(spec, (list, tuple)):
        return CompositePotential([_build_single(s, base_dir)
                                   for s in spec])
    if isinstance(spec, (str, Path)):
        path = Path(spec)
        if base_dir is not None and not path.is_absolute():
            path = base_dir / path
        if path.suffix.lower() == ".ini":
            return _parse_ini(path)
        coefs = read_coefs(path)
        return _build_single(coefs)
    if not isinstance(spec, dict):
        raise TypeError(f"Cannot build a potential from {type(spec)}")

    params = {k.lower(): v for k, v in spec.items()}
    center = params.pop("center", None)
    scale = params.pop("scale", None)
    ampl = params.pop("ampl", None)

    if "file" in params and "type" not in params:
        pot = _build_single(params.pop("file"), base_dir)
        return _apply_modifiers(pot, center, scale, ampl)

    kind = str(params.pop("type", "")).lower().replace("_", "") \
        .replace(" ", "")
    if kind in ("disk", "spheroid", "king", "sersic"):
        from . import galpot

        builder = {"disk": galpot.build_disk,
                   "spheroid": galpot.build_spheroid,
                   "king": galpot.build_king,
                   "sersic": galpot.build_sersic}[kind]
        return _apply_modifiers(builder(**_galpot_kwargs(params)),
                                center, scale, ampl)
    if kind in ("dehnen", "dehnensph") and (
            float(params.get("axisratioy", 1.0)) != 1.0
            or float(params.get("axisratioz", 1.0)) != 1.0):
        # triaxial Dehnen == Spheroid(alpha=1, beta=4) with
        # densityNorm = (3 - gamma) M / (4 pi a^3 p q)
        # (reference routes this through Agama, _potential.py:2122-2155)
        from . import galpot

        kw = _galpot_kwargs(params)
        kw.setdefault("alpha", 1.0)
        kw.setdefault("beta", 4.0)
        return _apply_modifiers(galpot.build_spheroid(**kw),
                                center, scale, ampl)
    if kind == "multipole":
        if "coefficients" in params:
            return _apply_modifiers(
                MultipolePotential(read_coefs(params["coefficients"])),
                center, scale, ampl)
        return _apply_modifiers(_build_single(params["file"], base_dir),
                                center, scale, ampl)
    if kind == "cylspline":
        if "coefficients" in params:
            return _apply_modifiers(
                CylSplinePotential(read_coefs(params["coefficients"])),
                center, scale, ampl)
        return _apply_modifiers(_build_single(params["file"], base_dir),
                                center, scale, ampl)
    if kind == "uniformacceleration" and "file" in params:
        # time-dependent table (T,4) [t, ax, ay, az]; resolve the path
        # relative to the INI file that referenced it
        src = params.pop("file")
        if isinstance(src, (str, Path)):
            path = Path(src)
            if base_dir is not None and not path.is_absolute():
                path = base_dir / path
            src = np.loadtxt(path)
        from .analytic import UniformAcceleration

        return _apply_modifiers(UniformAcceleration(table=src),
                                center, scale, ampl)
    if kind in ANALYTIC_TYPE_MAP:
        # normalise Agama kwarg capitalisation (shared canonical table)
        pot = ANALYTIC_TYPE_MAP[kind](**_galpot_kwargs(params))
        return _apply_modifiers(pot, center, scale, ampl)
    raise ValueError(f"Unknown potential type {kind!r}")


def make_potential(*args, device="cuda", **kwargs) -> Potential:
    """Agama-style constructor:

    ``make_potential(type='NFW', mass=1e12, scaleRadius=20)``
    ``make_potential(file='MWPotential22.ini')``
    ``make_potential(dict_a, dict_b)`` -> composite

    The field is built on ``device``: the card unless the caller passes
    ``device='cpu'``.
    """
    device = resolve_device(device)
    specs = list(args)
    if kwargs:
        specs.append(kwargs)
    if not specs:
        raise ValueError("make_potential() needs parameters")
    pots = [_build_single(s) for s in specs]
    pot = pots[0] if len(pots) == 1 else CompositePotential(pots)
    return pot.to(device)


def load_potential_ini(path, device="cuda") -> Potential:
    """Parse a (possibly multi-section) Agama INI potential file into a
    field on ``device`` (the card unless the caller passes
    ``device='cpu'``)."""
    device = resolve_device(device)
    return _parse_ini(path).to(device)


def _parse_ini(path) -> Potential:
    """An INI file's field, built on the CPU."""
    path = Path(path)
    base = path.parent
    lines = path.read_text().splitlines()
    headers = [i for i, ln in enumerate(lines)
               if re.match(r"^\s*\[", ln)]
    starts = [i for i in headers
              if re.match(r"^\s*\[Potential", lines[i], re.IGNORECASE)]
    if not starts:
        raise ValueError(f"No [Potential] sections in {path}")

    built = []
    for start in starts:
        # a section ends at the NEXT header of any kind: trailing
        # [DF ...]/[SelfConsistentModel] blocks must not bleed their
        # keys into the last potential's params
        later = [i for i in headers if i > start]
        end = later[0] if later else len(lines)
        section = lines[start:end]
        params: dict = {}
        data_start = None
        data_kind = None
        for j, ln in enumerate(section[1:], start=1):
            s = ln.strip()
            if not s or s.startswith("#") or s.startswith(";"):
                continue
            if s.lower() == "coefficients":
                data_start, data_kind = j, "coef"
                break
            if s.lower() == "timestamps":
                data_start, data_kind = j, "ts"
                break
            if "=" in s:
                k, _, v = s.partition("=")
                params[k.strip().lower()] = _coerce(
                    v.split("#")[0].strip())

        kind = str(params.get("type", "")).lower().replace(" ", "") \
            .replace("_", "")
        if kind == "diskansatz" and data_start is None and \
                "surfacedensity" not in params:
            # Agama exports parameterless DiskAnsatz stubs inside GalPot
            # composites; skip them (reference: _potential.py:2406)
            continue
        # modifiers apply to every branch (Timestamps and inline
        # Coefficients sections carry center=/scale=/ampl= too — the
        # MW-LMC pattern shifts an Evolving LMC along its trajectory)
        center = params.pop("center", None)
        scale = params.pop("scale", None)
        ampl = params.pop("ampl", None)
        if isinstance(center, str) and not Path(center).is_absolute() \
                and (base / center).exists():
            center = base / center
        if isinstance(scale, str):
            sp = Path(scale) if Path(scale).is_absolute() else base / scale
            if sp.exists():
                scale = np.loadtxt(sp)

        if data_kind == "coef":
            p = _build_single(
                {"type": kind, "coefficients": "\n".join(section)})
        elif data_kind == "ts":
            times, pots = [], []
            for ln in section[data_start + 1:]:
                s = ln.strip()
                if not s or s.startswith("#") or s.startswith(";"):
                    continue
                # split on the FIRST whitespace only: the payload is a
                # file path that may itself contain spaces
                parts = s.split(None, 1)
                if len(parts) < 2:
                    continue
                times.append(float(parts[0]))
                pots.append(_build_single(parts[1].strip(), base))
            interp = str(params.get("interplinear", "true")).lower() \
                not in ("false", "0")
            p = EvolvingPotential(pots, times, interpolate=interp)
        else:
            p = _build_single(dict(params), base)
        built.append(_apply_modifiers(p, center, scale, ampl))

    if not built:
        raise ValueError(f"No buildable potentials in {path}")
    pot = built[0] if len(built) == 1 else CompositePotential(built)
    return pot
