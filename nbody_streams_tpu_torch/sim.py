"""Unified multi-species simulation entry point.

Counterpart of ``nbody_streams_tpu/sim.py``: species validation and
assembly, kwarg routing, then ``run_nbody``.  Ported:

* ``method='direct'``: O(N^2) direct summation through the CUDA kernels
  (``ops/dispatch.DirectGravity``);
* ``method='tree'``: the JAX package's ``impl='sharded'``, the exact
  direct sum.  Over more than one device (``devices=[...]``, which may
  repeat a device) it runs the ring of shards (``parallel/sharded.py``);
  without ``devices`` or on one device the direct path on one card, which
  gives the same values to float32 tolerance faster than a one-shard ring
  (the run keeps its own ``kernel``).  The ring across distinct cards is
  asked for by naming them: a copy between two cards has not yet been
  checked against the one-card path;
* ``method='scf'``: the Hernquist-Ostriker expansion (``ops/scf.py``),
  single-centre or one expansion per species group (``scf_groups``);
* ``external_potential`` (e.g. from ``nbody_streams_tpu_torch.potentials``)
  and ``dynamical_friction=True`` (``friction.py``, the ``df_*``
  keywords).

"""
from __future__ import annotations

import warnings

import numpy as np

from .constants import G_DEFAULT
from .run import run_nbody
from .species import (
    PerformanceWarning,
    Species,
    _build_particle_arrays,
    _emit_performance_warnings,
    _split_by_species,
    _validate_species,
)
from .telemetry import span

__all__ = ["run_simulation"]

_DIRECT_KW = {
    "precision", "kernel", "external_update_interval", "impl", "devices",
    "block_size", "nan_check", "step_timeout_s", "profile_dir",
    "target_drift", "_stop_step",
}
_DF_KW = {
    "df_M_sat", "df_coulomb_mode", "df_fixed_ln_lambda", "df_core_gamma",
    "df_r_core", "df_update_interval", "df_sigma_method",
    "df_apply_radius_factor", "df_shrink_n_iter", "df_shrink_frac",
    "df_sigma_grid_r", "df_com_method", "df_bound_r_max",
}
_SCF_KW = {
    "scf_nmax", "scf_lmax", "scf_mmax", "scf_a", "scf_symmetry",
    "scf_center", "scf_groups",
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
    one) or 'cpu', and ``method`` is 'direct', 'tree' (the exact direct sum:
    the ring over ``devices=`` when they name more than one) or 'scf'.
    Dynamical friction takes the ``df_*`` keywords (``df_M_sat`` defaults
    to the total mass) and needs ``external_potential``; the SCF tier takes the
    ``scf_*`` keywords, ``scf_groups`` mapping species names (or slices)
    to per-group options.
    """
    # the call's start: checks, the species' arrays, the friction's tables
    with span("entry.start"):
        phase_space = np.asarray(phase_space, np.float64)
        if phase_space.ndim != 2 or phase_space.shape[1] != 6:
            raise ValueError(
                f"phase_space must be (N, 6), got {phase_space.shape}")
        if architecture not in ("cpu", "gpu", "auto"):
            raise ValueError(
                f"architecture must be 'cpu', 'gpu' or 'auto', got "
                f"{architecture!r}")
        if method not in ("direct", "tree", "scf"):
            raise ValueError(
                f"method must be 'direct', 'tree' or 'scf', got {method!r}")

        _validate_species(phase_space, species)
        mass_arr, soft_arr = _build_particle_arrays(species)
        _emit_performance_warnings(phase_space.shape[0], architecture, method)

        kw = dict(kwargs)
        direct_kwargs = {k: kw.pop(k) for k in list(kw) if k in _DIRECT_KW}
        df_kwargs = {k: kw.pop(k) for k in list(kw) if k in _DF_KW}
        scf_kwargs = {k: kw.pop(k) for k in list(kw) if k in _SCF_KW}
        if scf_kwargs and method != "scf":
            raise TypeError(
                f"scf_* kwargs given but method={method!r}: "
                f"{sorted(scf_kwargs)}")
        for legacy in ("theta", "nleaf", "ncrit", "level_split", "nthreads"):
            if legacy in kw:
                kw.pop(legacy)
                if verbose:
                    print(f"note: {legacy!r} has no effect (direct summation "
                          "is exact)")
        if kw:
            raise TypeError(f"Unknown keyword arguments: {sorted(kw)}")

        force_extra = None
        if dynamical_friction:
            if external_potential is None:
                raise ValueError(
                    "dynamical_friction=True requires external_potential")
            from .friction import make_df_force_extra

            m_sat = df_kwargs.pop("df_M_sat", float(mass_arr.sum()))
            force_extra = make_df_force_extra(
                external_potential, M_sat=m_sat, G=G, t_start=time_start,
                t_end=time_end,
                **{k.removeprefix("df_"): v for k, v in df_kwargs.items()})
        elif df_kwargs:
            raise TypeError(
                f"df_* kwargs given but dynamical_friction=False: "
                f"{sorted(df_kwargs)}")

        # method='tree' runs as 'direct': with devices= naming more than one
        # device DirectGravity's impl='auto' takes the ring (the JAX package's
        # impl='sharded'), on one device the one-card path
        if method == "scf":
            direct_kwargs["solver_factory"] = _scf_factory(
                phase_space, species, direct_kwargs, scf_kwargs, G)

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
        force_extra=force_extra,
        **direct_kwargs,
    )
    return _split_by_species(xv_final, species)


def _scf_factory(xv0, species, direct_kwargs, scf_kwargs, G):
    """The ``solver_factory`` of ``method='scf'``: an ``SCFGravity``, or a
    ``CompositeSCFGravity`` over ``scf_groups``, in float64 for
    ``precision='float64'`` and float32 otherwise (``float32_kahan`` keeps
    its compensated state)."""
    from .ops.scf import CompositeSCFGravity, SCFGravity

    precision = direct_kwargs.get("precision", "float32_kahan")
    scf_prec = "float64" if precision == "float64" else "float32"
    for bad in ("impl", "block_size", "kernel", "devices", "target_drift"):
        if bad in direct_kwargs:
            raise TypeError(f"{bad!r} has no effect with method='scf'")
    if precision == "float32_fast":
        warnings.warn(
            "precision='float32_fast' only accelerates the direct pairwise "
            "kernels; with method='scf' it runs as plain 'float32'",
            PerformanceWarning, stacklevel=3)
    opts = {k.removeprefix("scf_"): v for k, v in scf_kwargs.items()}
    groups_spec = opts.pop("groups", None)
    if groups_spec is None:
        def factory(mass_arr, soft_arr, device):
            return SCFGravity(mass_arr, soft_arr, G=G, precision=scf_prec,
                              phase_space=xv0, device=device, **opts)

        return factory

    # species are contiguous: names map onto slices of the particle array
    by_name, start = {}, 0
    for s in species:
        by_name[s.name] = slice(start, start + s.N)
        start += s.N
    items = (groups_spec.items() if isinstance(groups_spec, dict)
             else groups_spec)
    groups = []
    for key, gopts in items:
        if isinstance(key, str):
            if key not in by_name:
                raise ValueError(
                    f"scf_groups references unknown species {key!r}; "
                    f"have {sorted(by_name)}")
            key = by_name[key]
        groups.append((key, dict(gopts)))

    def factory(mass_arr, soft_arr, device):
        return CompositeSCFGravity(mass_arr, soft_arr, groups=groups, G=G,
                                   precision=scf_prec, phase_space=xv0,
                                   device=device, **opts)

    return factory
