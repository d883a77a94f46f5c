"""The flagship run at N = 2M: a multi-species satellite in the evolving
MW + LMC field with dynamical friction, on the card.

    python -m nbody_streams_tpu_torch.benchmarks.flagship2m [N_total] [steps] [--figures-only]

Counterpart of the repo's ``benchmarks/flagship2m.py`` (BASELINE config
#5, the reference's flagship demonstration), with every subsystem on at
once:

* N = 2,097,153 particles in three species (a Plummer dark halo, a compact
  stellar Plummer and a central BH particle), sampled in equilibrium from
  the Eddington DF of the combined satellite potential (``df.py``, on the
  host);
* self-gravity by direct summation through the CUDA kernels (the port's
  default impl);
* the evolving MW + moving LMC field with the frame's acceleration
  (``potentials/mwlmc.py``);
* Chandrasekhar dynamical friction on the satellite (shrinking-sphere
  centre, variable Coulomb log);
* snapshots, restarts and the per-step watchdog (``step_timeout_s``);
* SPH surface-density figures of the first and last snapshots
  (``figures``).

Defaults: N = 2,097,153, 200 steps of dt = 5e-4 (t from -0.1 to 0, ~98
Myr of infall ending at the present day of the LMC tables), output in
``./output_flagship2m_torch``.  A rerun resumes from the output's
``restart.npz`` (there is no supervisor that kills and restarts the
process, as the TPU script has).  Each attempt appends its steps and wall
seconds to ``attempts.json`` beside the restart file, and the summary line
divides the steps of all attempts by their summed wall time.  Without
h5py the command line runs with snapshots off (the restart file still
holds the state) and writes no figures; it says so.  Without a CUDA
device ``run`` and ``build_ics`` raise unless given ``device='cpu'``.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device

N_TOTAL = 2_097_153
STEPS = 200
DT = 5e-4
OUT = "./output_flagship2m_torch"
ATTEMPTS = "attempts.json"

# satellite model (Sgr-class dwarf): Plummer dark halo + compact
# stellar Plummer + central BH
M_DARK = 2.0e9
A_DARK = 1.5          # kpc
M_STAR = 2.5e8
A_STAR = 0.4
M_BH = 1.0e6
R0 = np.array([52.0, 0.0, 35.0])       # ~63 kpc out, infalling
V0 = np.array([-35.0, 95.0, -40.0])    # sub-circular: decaying orbit


def _device(device):
    """The card unless the caller asks for the CPU."""
    return resolve_device("cuda" if device is None else device)


def build_ics(n_total, seed=42, device=None):
    """The satellite's phase space (n_total, 6) and species: ~5/6 dark,
    the rest stars, one BH, sampled on the host; the satellite potentials
    are evaluated on ``device``."""
    from ..df import sample_quasispherical
    from ..potentials.analytic import PlummerPotential
    from ..species import Species

    device = _device(device)
    n_dark = int(round((n_total - 1) * 5 / 6))
    n_star = n_total - 1 - n_dark

    def plummer(mass, a):
        return PlummerPotential(mass=mass, scaleRadius=a).to(device)

    pot_sat = (plummer(M_DARK, A_DARK) + plummer(M_STAR, A_STAR)
               + plummer(M_BH, 1e-3))
    r_grid = np.geomspace(1e-3, 60.0, 384)
    print(f"sampling {n_dark:,} dark + {n_star:,} star particles "
          "from the Eddington DF of the combined satellite potential ...",
          flush=True)
    t0 = time.time()
    xv_dark, m_dark = sample_quasispherical(
        plummer(M_DARK, A_DARK), pot_sat, n_dark, seed=seed, r_grid=r_grid,
        total_mass=M_DARK)
    xv_star, m_star = sample_quasispherical(
        plummer(M_STAR, A_STAR), pot_sat, n_star, seed=seed + 1,
        r_grid=r_grid, total_mass=M_STAR)
    print(f"  sampled in {time.time() - t0:.0f} s", flush=True)

    xv_bh = np.zeros((1, 6))
    xv = np.concatenate([xv_dark, xv_star, xv_bh], axis=0)
    # common CoM correction, then place the whole satellite on its orbit
    mass = np.concatenate([m_dark, m_star, [M_BH]])
    w = mass / mass.sum()
    xv -= (w[:, None] * xv).sum(axis=0, keepdims=True)
    xv[:, :3] += R0
    xv[:, 3:] += V0

    species = [
        Species(name="dark", N=n_dark, mass=m_dark, softening=0.05),
        Species(name="stars", N=n_star, mass=m_star, softening=0.02),
        Species(name="bh", N=1, mass=np.array([M_BH]), softening=0.02),
    ]
    return xv, species


def _restart_step(out):
    """The step of ``out``'s restart file, 0 without one."""
    path = Path(out) / "restart.npz"
    if not path.exists():
        return 0
    with np.load(path) as data:
        return int(data["step"])


def _record_attempt(out, start_step, wall_s):
    """Append one attempt (the steps it moved the restart file on, and its
    wall seconds) to ``out``'s attempts file."""
    path = Path(out) / ATTEMPTS
    path.parent.mkdir(parents=True, exist_ok=True)
    recs = json.loads(path.read_text()) if path.exists() else []
    end_step = _restart_step(out)
    recs.append({"start_step": start_step, "end_step": end_step,
                 "steps": end_step - start_step, "wall_s": wall_s})
    path.write_text(json.dumps(recs, indent=1))


def summary(out=OUT):
    """The run in ``out`` over all its attempts: ``steps`` (the steps the
    attempts moved the restart file on), ``wall_s`` (their summed wall
    seconds) and ``attempts``."""
    recs = json.loads((Path(out) / ATTEMPTS).read_text())
    return {"steps": sum(r["steps"] for r in recs),
            "wall_s": sum(r["wall_s"] for r in recs),
            "attempts": len(recs)}


def satellite(result, species):
    """The satellite's structure in a run's output ({species: (N_k, 6)}):
    ``r_com`` [kpc] and ``v_com`` [km/s] of its centre of mass, the stars'
    half-mass radius ``r_half`` [kpc] about their own centre of mass and
    the BH's offset from it, ``bh_offset_pc``."""
    mass = {sp.name: np.broadcast_to(sp.mass, sp.N) for sp in species}
    xv = np.concatenate([result[sp.name] for sp in species])
    w = np.concatenate([mass[sp.name] for sp in species])
    com = np.average(xv, axis=0, weights=w)
    stars = result["stars"]
    com_s = np.average(stars[:, :3], axis=0, weights=mass["stars"])
    r = np.linalg.norm(stars[:, :3] - com_s, axis=1)
    order = np.argsort(r)
    cum = np.cumsum(mass["stars"][order])
    r_half = r[order][np.searchsorted(cum, 0.5 * cum[-1])]
    return {"r_com": float(np.linalg.norm(com[:3])),
            "v_com": float(np.linalg.norm(com[3:])),
            "r_half": float(r_half),
            "bh_offset_pc": float(1e3 * np.linalg.norm(
                result["bh"][0, :3] - com_s))}


def run(n_total, steps, device=None, out=OUT, save_snapshots=True,
        _stop_step=None):
    """Run (or resume, when ``out`` holds a restart file) the flagship for
    ``steps`` steps ending at t = 0; returns ``run_simulation``'s
    {species: (N_k, 6)}.  ``_stop_step``, a hook for the tests, ends this
    attempt at that step with its restart file written, as a stopped
    attempt would."""
    from ..ops import cuda_direct
    from ..potentials.mwlmc import load_mw_lmc_potential
    from ..sim import run_simulation

    device = _device(device)
    out = Path(out)
    resume = (out / "restart.npz").exists()
    if not resume:
        # a fresh run: the attempts of an earlier run do not count
        (out / ATTEMPTS).unlink(missing_ok=True)
    pot_ext, traj = load_mw_lmc_potential(device=device)
    print(f"MW+LMC evolving potential loaded (LMC table t = "
          f"{traj[0, 0]:.1f} .. {traj[-1, 0]:.1f})", flush=True)

    xv, species = build_ics(n_total, device=device)
    t_end = 0.0
    t_start = t_end - steps * DT

    start_step = _restart_step(out)
    branches = dict(cuda_direct.BRANCHES)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        result = run_simulation(
            xv, species, t_start, t_end, DT,
            architecture="gpu" if device.type == "cuda" else "cpu",
            method="direct",
            external_potential=pot_ext,
            dynamical_friction=True,
            df_M_sat=M_DARK + M_STAR + M_BH,
            df_coulomb_mode="variable",
            df_update_interval=10,
            output_dir=str(out),
            save_snapshots=save_snapshots,
            snapshots=4,
            restart_interval=50,
            continue_run=resume,
            overwrite=not resume,
            verbose=True,
            debug_energy=True,
            precision="float32_kahan",
            step_timeout_s=900.0,
            _stop_step=_stop_step,
        )
    finally:
        _record_attempt(out, start_step, time.perf_counter() - t0)
    took = {k: v - branches[k] for k, v in cuda_direct.BRANCHES.items()}
    window = (f"{took['window_rows'] / took['band_rows']:.3f}"
              if took["band_rows"] else "no sorted-path call")
    took = {k: took[k] for k in ("two_pass", "single_pass")}
    peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
            if device.type == "cuda" else "not measured (CPU)")
    tot = summary(out)
    done = _restart_step(out)
    wall = tot["wall_s"]
    head = ("FLAGSHIP 2M DONE" if done == steps
            else f"FLAGSHIP 2M STOPPED at step {done} of {steps}")
    print(f"\n{head}: {tot['steps']} steps x N={n_total:,} in {wall:.0f} s "
          f"over {tot['attempts']} attempt(s) "
          f"({wall / max(tot['steps'], 1):.1f} s/step, "
          f"{float(n_total) ** 2 * tot['steps'] / wall / 1e9:.1f} Gint/s "
          f"sustained incl. I/O); peak device memory of this attempt "
          f"{peak}; sorted-path branches of this attempt {took}; band "
          f"window over band width {window}",
          flush=True)
    sat = satellite(result, species)
    print(f"satellite at step {done}: r_CoM {sat['r_com']:.2f} kpc, v_CoM "
          f"{sat['v_com']:.1f} km/s, stellar r_half {sat['r_half']:.3f} "
          f"kpc, BH offset from the stars' CoM {sat['bh_offset_pc']:.1f} pc",
          flush=True)
    for k, v in result.items():
        print(f"  {k}: {v.shape}")
    return result


def figures(out=OUT, fig_dir=None, device=None):
    """SPH surface-density renders of the first and last snapshots in
    ``out``, splatted on ``device`` (the card by default), written to
    ``fig_dir`` (``<out>/figures`` by default).  Needs h5py and
    matplotlib."""
    missing = [m for m in ("h5py", "matplotlib")
               if importlib.util.find_spec(m) is None]
    if missing:
        raise ImportError(f"flagship2m.figures needs h5py and matplotlib; "
                          f"not installed: {', '.join(missing)}")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..nbody_io import ParticleReader
    from ..viz.sph import render_surface_density

    arch = "cpu" if _device(device).type == "cpu" else "gpu"
    fig_dir = Path(out) / "figures" if fig_dir is None else Path(fig_dir)
    fig_dir.mkdir(parents=True, exist_ok=True)
    reader = ParticleReader(f"{out}/snapshot*.h5")
    snaps = [int(s) for s in reader.Times.snap]
    times = np.asarray(reader.Times.time, float)
    print(f"snapshots {snaps} at t = {times}")
    written = []
    for tag, k in (("first", 0), ("last", len(snaps) - 1)):
        snap = reader.read_snapshot(snaps[k])
        fig, axes = plt.subplots(1, 2, figsize=(11, 5), dpi=110)
        for ax, name in zip(axes, ("dark", "stars")):
            pos = np.asarray(snap.species[name]["posvel"][:, :3], float)
            mass = np.asarray(snap.species[name]["mass"], float)
            com = np.average(pos, axis=0, weights=mass)
            half = 12.0 if name == "dark" else 4.0
            ext = (com[0] - half, com[0] + half,
                   com[1] - half, com[1] + half)
            img, ext_out = render_surface_density(pos, mass, extent=ext,
                                                  npix=384, arch=arch)
            img = np.asarray(img)
            floor = img[img > 0].min() if (img > 0).any() else 1.0
            ax.imshow(np.log10(img + floor), origin="lower",
                      extent=ext_out, cmap="magma")
            ax.set_title(f"{name}  t={snap.time:+.4f}")
            ax.set_xlabel("x [kpc]")
            ax.set_ylabel("y [kpc]")
        fig.tight_layout()
        path = fig_dir / f"sph_{tag}.png"
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
        print(f"wrote {path}", flush=True)
    return written


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    flags = [a for a in argv if a.startswith("--")]
    args = [a for a in argv if not a.startswith("--")]
    if set(flags) - {"--figures-only"} or len(args) > 2:
        raise SystemExit("usage: python -m nbody_streams_tpu_torch."
                         "benchmarks.flagship2m [N_total] [steps] "
                         "[--figures-only]")
    n_total = int(args[0]) if args else N_TOTAL
    steps = int(args[1]) if len(args) > 1 else STEPS
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("h5py", "matplotlib")}
    if "--figures-only" in flags:
        figures()
        return 0
    if not have["h5py"]:
        print("h5py is not installed: snapshots off, the state is in "
              f"{OUT}/restart.npz", flush=True)
    run(n_total, steps, save_snapshots=have["h5py"])
    if all(have.values()):
        figures()
    else:
        print("no figures: flagship2m.figures needs h5py and matplotlib "
              f"(installed: {have})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
