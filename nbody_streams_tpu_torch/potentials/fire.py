"""FIRE-simulation convenience helpers (reference: agama_helper/_fire.py).

Counterpart of ``nbody_streams_tpu/potentials/fire.py``.

Utilities for working with FIRE-style snapshot time listings and
batched per-snapshot coefficient files.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = [
    "read_snapshot_times",
    "create_evolving_ini",
    "create_fire_evolving_ini",
    "load_fire_pot",
]


def read_snapshot_times(path, sep=None) -> dict:
    """Parse a FIRE ``snapshot_times.txt`` robustly.

    Returns {'index', 'scale_factor', 'redshift', 'time', 'lookback'}
    arrays (missing columns filled with NaN).  Handles comment headers
    and variable column counts (reference: _fire.py:29).

    Reference compatibility: a *directory* argument reads
    ``snapshot_times.txt`` inside it (the reference's ``sim_dir`` form),
    the reference column names (``'snap'``, ``'scale-factor'``,
    ``'time[Gyr]'``, ``'time_width[Myr]'``) are included as dict keys so
    ``df["time[Gyr]"]``-style reference code works unchanged, and
    ``sep=`` is accepted and ignored (the parser is whitespace/comma
    robust).
    """
    del sep
    path = Path(path)
    if path.is_dir():
        path = path / "snapshot_times.txt"
    rows = []
    for line in path.read_text().splitlines():
        s = line.strip()
        if not s or s.startswith(("#", ";", "//")):
            continue
        parts = s.replace(",", " ").split()
        try:
            rows.append([float(p) for p in parts])
        except ValueError:
            continue
    if not rows:
        raise ValueError(f"no numeric rows found in {path}")
    width = max(len(r) for r in rows)
    arr = np.full((len(rows), width), np.nan)
    for i, r in enumerate(rows):
        arr[i, :len(r)] = r
    names = ["index", "scale_factor", "redshift", "time", "lookback"]
    out = {}
    for j, name in enumerate(names):
        out[name] = arr[:, j] if j < width else np.full(len(rows), np.nan)
    out["index"] = out["index"].astype(int)
    # reference (pandas) column-name aliases
    out["snap"] = out["index"]
    out["scale-factor"] = out["scale_factor"]
    out["time[Gyr]"] = out["time"]
    out["time_width[Myr]"] = out["lookback"]
    return out


def create_evolving_ini(filename=None, coef_files=None, times=None,
                        interp_linear: bool = True, *,
                        coef_paths=None, output_path=None) -> Path:
    """Write an Agama-style ``type=Evolving`` INI with a Timestamps block
    (readable by :func:`..factory.load_potential_ini` and by Agama).

    Native form: ``create_evolving_ini(filename, coef_files, times)``.
    The reference argument order (reference _load.py:
    ``create_evolving_ini(times, coef_paths, output_path,
    interp_linear)``) is detected by a non-path first argument, and the
    reference keyword names ``coef_paths=``/``output_path=`` are
    accepted.
    """
    if coef_paths is not None:
        coef_files = coef_paths
    if output_path is not None:
        if filename is not None and not isinstance(filename,
                                                   (str, Path)):
            # reference positional order with output_path keyword:
            # (times, coef_paths, output_path=...)
            times = filename if times is None else times
        filename = output_path
    elif filename is not None and not isinstance(filename, (str, Path)):
        # reference positional order: (times, coef_paths, output_path)
        filename, coef_files, times = times, coef_files, filename
    if filename is None or coef_files is None or times is None:
        raise TypeError("create_evolving_ini needs (filename, "
                        "coef_files, times) or the reference (times, "
                        "coef_paths, output_path)")
    filename = Path(filename)
    if len(coef_files) != len(times):
        raise ValueError(
            f"{len(coef_files)} files but {len(times)} times")
    lines = [
        "[Potential]",
        "type=Evolving",
        f"interpLinear={'True' if interp_linear else 'False'}",
        "Timestamps",
    ]
    for t, f in zip(times, coef_files):
        lines.append(f"{t:.10g} {f}")
    filename.write_text("\n".join(lines) + "\n")
    return filename


def create_fire_evolving_ini(sim_dir, snapshots=None, filename=None,
                             pattern: str = "{snap}.coef_mult",
                             times=None, snapshot_times="snapshot_times.txt",
                             interp_linear: bool = True, *,
                             model_pattern=None, output_filename=None,
                             snap_range=None, verbose: bool = True):
    """Build an evolving-potential INI for a series of FIRE snapshots.

    ``pattern`` is formatted with ``snap``; times default to the physical
    times from the snapshot_times listing (reference: _fire.py:191).

    The reference call form (reference _fire.py:191:
    ``create_fire_evolving_ini(sim_dir, model_pattern,
    output_filename, snap_range=None, verbose=True)``, detected by a
    string second positional or the reference keywords) writes the INI
    into ``<sim_dir>/potential/10kpc/<output_filename>``, takes every
    snapshot in ``snapshot_times.txt`` filtered by the inclusive
    ``snap_range``, names coefficient files ``<snap><model_pattern
    without '*'>``, requires them to exist, and returns the path as a
    string.
    """
    import os

    sim_dir = Path(sim_dir)
    if isinstance(snapshots, str) and model_pattern is None:
        # reference positional layout: (sim_dir, model_pattern,
        # output_filename, ...)
        model_pattern = snapshots
        snapshots = None
        if filename is not None and output_filename is None:
            output_filename = filename
            filename = None
    if model_pattern is not None or output_filename is not None \
            or snap_range is not None:
        if model_pattern is None or output_filename is None:
            raise TypeError("the reference form needs both "
                            "model_pattern and output_filename")
        pot_dir = sim_dir / "potential" / "10kpc"
        pot_dir.mkdir(parents=True, exist_ok=True)
        listing = read_snapshot_times(sim_dir)
        snaps, t_gyr = listing["snap"], listing["time[Gyr]"]
        keep = np.isfinite(t_gyr)
        if snap_range is not None:
            keep &= (snaps >= snap_range[0]) & (snaps <= snap_range[1])
        snaps, t_gyr = snaps[keep], t_gyr[keep]
        suffix = model_pattern.replace("*", "")
        paths = [pot_dir / f"{int(s)}{suffix}" for s in snaps]
        missing = [str(p) for p in paths if not p.exists()]
        if missing:
            sample = "\n".join(missing[:10]) \
                + ("\n  ..." if len(missing) > 10 else "")
            raise FileNotFoundError(
                f"Missing {len(missing)} coefficient file(s):\n{sample}")
        out = create_evolving_ini(pot_dir / output_filename,
                                  [str(p) for p in paths],
                                  list(t_gyr),
                                  interp_linear=interp_linear)
        if verbose:
            print(f"Written: {out}  ({len(t_gyr)} snapshots)")
        return str(out)
    if snapshots is None:
        raise TypeError("create_fire_evolving_ini needs snapshots= "
                        "(native form) or model_pattern/output_filename "
                        "(reference form)")
    if times is None:
        listing = read_snapshot_times(sim_dir / snapshot_times)
        tmap = dict(zip(listing["index"], listing["time"]))
        missing = [s for s in snapshots if s not in tmap]
        if missing:
            raise ValueError(f"snapshots missing from times file: {missing}")
        times = [tmap[s] for s in snapshots]
    if not np.all(np.isfinite(np.asarray(times, float))):
        raise ValueError(
            f"non-finite snapshot times {times}: the snapshot_times "
            "listing has no physical-time column (NaN timestamps would "
            "make every Timestamps bracket comparison false)")
    filename = Path(filename) if filename is not None \
        else (sim_dir / "evolving_potential.ini")
    # Timestamps paths resolve relative to the INI's own directory
    # (load_potential_ini semantics) — prefix accordingly when the INI
    # is written outside sim_dir
    rel = os.path.relpath(sim_dir, filename.parent)
    prefix = "" if rel == "." else rel + "/"
    files = [prefix + pattern.format(snap=s) for s in snapshots]
    return create_evolving_ini(filename, files, times,
                               interp_linear=interp_linear)


def _add_negative_m(pairs):
    """Expand (l, m) keep-lists with the matching negative-m terms."""
    out = set()
    for l, m in pairs:
        out.add((l, m))
        out.add((l, -m))
    return sorted(out)


def load_fire_pot(sim_dir, nsnap, sym: str = "n", lmax: int = 4,
                  kind: str = "whole", keep_lm_mult=None,
                  keep_m_cylspl=None, include_negative_m: bool = True,
                  file_ext: str = "DR", out_acc: bool = False,
                  halo=None, verbose: bool = True,
                  return_coefs: bool = False,
                  save_modified: bool = False, save_dir=None,
                  device="cuda"):
    """One-call FIRE coefficient loader (Arora et al. 2022 layout).

    Reads the pre-computed Multipole (dark halo + hot gas) and CylSpline
    (stars + cold gas "bar") coefficient files from the FIRE
    ``potential/10kpc/`` directory and builds native evaluators —
    no Agama and no temporary files (the reference round-trips through
    ``agama.Potential(file=...)``; reference: agama_helper/_fire.py:267-429).

    Filename convention: ``{nsnap}.{component}.{sym}_{lmax}[.halo]``
    ``.coef_mul|.coef_cylsp`` ``[_{file_ext}]`` under
    ``sim_dir/potential/10kpc[/out_acc]``.

    kind: ``'whole'`` (composite of both), ``'dark'`` (Multipole only),
    ``'bar'`` (CylSpline only).  ``keep_lm_mult`` / ``keep_m_cylspl``
    zero all other harmonics in memory before building;
    ``include_negative_m`` auto-adds the negative-m counterparts.
    ``return_coefs=True`` returns the coef dataclass(es) instead of
    evaluators; ``save_modified=True`` writes filtered coef strings next
    to the originals (or into ``save_dir``).  Evaluators are built on
    ``device``: the card unless the caller passes ``device='cpu'``.
    """
    from .base import CompositePotential, resolve_device
    from .coefs import read_cylspl_coefs, read_mult_coefs
    from .cylspline import CylSplinePotential
    from .multipole import MultipolePotential

    sym_map = {"a": "axi", "s": "sph", "t": "triax", "n": "none"}
    if sym not in sym_map:
        raise ValueError(f"Unknown sym {sym!r}. Allowed: {list(sym_map)}")
    if save_modified and keep_lm_mult is None and keep_m_cylspl is None:
        import warnings

        warnings.warn(
            "save_modified=True writes only *filtered* coefficient files; "
            "without keep_lm_mult / keep_m_cylspl nothing is modified and "
            "nothing is written", UserWarning, stacklevel=2)
    if kind not in ("whole", "dark", "bar"):
        raise ValueError(
            f"Unknown kind {kind!r}. Allowed: 'whole', 'dark', 'bar'")
    sym_label = sym_map[sym]

    base = Path(sim_dir) / "potential" / "10kpc"
    if out_acc:
        base = base / "out_acc"

    def build_path(component, ext_suffix):
        name = f"{int(nsnap)}.{component}.{sym_label}_{int(lmax)}"
        if halo:
            name += f".{halo}"
        name += ext_suffix
        if file_ext:
            name += f"_{file_ext}"
        return base / name

    dark_path = build_path("dark", ".coef_mul")
    bar_path = build_path("bar", ".coef_cylsp")
    if verbose:
        if kind in ("whole", "dark"):
            print(f"Multipole : {dark_path}")
        if kind in ("whole", "bar"):
            print(f"CylSpline : {bar_path}")

    missing = [str(p) for p, needed in
               ((dark_path, kind in ("whole", "dark")),
                (bar_path, kind in ("whole", "bar")))
               if needed and not p.exists()]
    if missing:
        raise FileNotFoundError(
            "Missing FIRE coefficient file(s):\n  " + "\n  ".join(missing))

    def _save(path, coef_str):
        out = (Path(save_dir) / (path.name + ".modified") if save_dir
               else path.with_suffix(path.suffix + ".modified"))
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(coef_str)
        if verbose:
            print(f"  Saved modified coefficients -> {out}")

    def prepare_mult():
        coefs = read_mult_coefs(dark_path.read_text())
        if keep_lm_mult is not None:
            keep = (_add_negative_m(keep_lm_mult) if include_negative_m
                    else [tuple(p) for p in keep_lm_mult])
            if verbose:
                print(f"Multipole keep (l,m): {keep}")
            coefs = coefs.zeroed(keep, include_negative=False)
            if save_modified:
                _save(dark_path, coefs.to_coef_string())
        return coefs

    def prepare_cylspl():
        coefs = read_cylspl_coefs(bar_path.read_text())
        if keep_m_cylspl is not None:
            keep = ({m for mm in keep_m_cylspl for m in (mm, -mm)}
                    if include_negative_m else set(keep_m_cylspl))
            if verbose:
                print(f"CylSpline keep m: {sorted(keep)}")
            coefs = coefs.zeroed(sorted(keep),
                                 include_negative=False)
            if save_modified:
                _save(bar_path, coefs.to_coef_string())
        return coefs

    if return_coefs:
        if kind == "dark":
            return prepare_mult()
        if kind == "bar":
            return prepare_cylspl()
        return prepare_mult(), prepare_cylspl()

    device = resolve_device(device)
    if kind == "dark":
        return MultipolePotential(prepare_mult()).to(device)
    if kind == "bar":
        return CylSplinePotential(prepare_cylspl()).to(device)
    return CompositePotential([MultipolePotential(prepare_mult()),
                               CylSplinePotential(prepare_cylspl())]
                              ).to(device)
