"""Generate and execute the narrative tutorial notebooks.

The reference ships executed .ipynb walkthroughs (reference:
examples/*.ipynb, 7 notebooks); this builds the two flagship ones
with nbody_streams_tpu_torch — a Plummer stability run and the MW+LMC
stream workflow — executes them (on the CPU: runnable anywhere, no card
required) and writes the executed notebooks with embedded figures.

Usage: python nbody_streams_tpu_torch/examples/notebooks/make_notebooks.py [--skip-execute]
"""
import sys
from pathlib import Path

import nbformat as nbf

HERE = Path(__file__).resolve().parent


def _nb(cells):
    nb = nbf.v4.new_notebook()
    nb.metadata.kernelspec = {
        "display_name": "Python 3", "language": "python", "name": "python3"}
    nb.cells = [
        nbf.v4.new_markdown_cell(src) if kind == "md"
        else nbf.v4.new_code_cell(src)
        for kind, src in cells
    ]
    return nb


PLUMMER = [
    ("md", """\
# Plummer-sphere stability

The canonical N-body validation: an isolated equilibrium Plummer sphere
must stay in virial balance with bounded energy drift.  Mirrors the
reference's stability notebooks (reference: `examples/
MW_gpu_tree_stability.ipynb` methodology at small N) through the unified
`run_simulation` API.

Everything below runs on the CPU so the notebook executes anywhere; on
a machine with an NVIDIA GPU pass `architecture='gpu'` (or the default
`'auto'`) and scale N up — the same call runs the hand-written CUDA
kernels."""),
    ("code", """\
import numpy as np
import matplotlib.pyplot as plt

import sys, pathlib
sys.path.insert(0, str(pathlib.Path.cwd().parents[2]))
from nbody_streams_tpu_torch import (
    Species, make_plummer_sphere, run_simulation, ParticleReader)"""),
    ("code", """\
N = 2048
M_TOT = 1e9          # Msun
A = 1.0              # kpc
xv, mass = make_plummer_sphere(N, M_total=M_TOT, a=A, seed=7)
species = [Species(name="dark", N=N, mass=mass, softening=0.05)]
print(f"sampled {N} particles, total mass {mass.sum():.3e} Msun")"""),
    ("code", """\
import tempfile
outdir = tempfile.mkdtemp(prefix="plummer_nb_")
out = run_simulation(
    xv, species, time_start=0.0, time_end=0.04, dt=2e-4,
    architecture="cpu", output_dir=outdir, snapshots=8,
    debug_energy=True, verbose=True)"""),
    ("md", """\
The `debug_energy` lines above print the virial ratio Q (-> 0.5 in
equilibrium) and the running |dE/E|.  Now read the snapshots back and
plot the conserved quantities and the density profile."""),
    ("code", """\
reader = ParticleReader(f"{outdir}/snapshot*.h5")
times = np.asarray(reader.Times.time, float)
snaps = [int(s) for s in reader.Times.snap]

from nbody_streams_tpu_torch import compute_potential_direct
E = []
for s in snaps:
    snap = reader.read_snapshot(s)
    pv = np.asarray(snap.species["dark"]["posvel"], float)
    m = np.asarray(snap.species["dark"]["mass"], float)
    ke = 0.5 * (m * (pv[:, 3:] ** 2).sum(1)).sum()
    phi = np.asarray(compute_potential_direct(
        pv[:, :3], m, 0.05, kernel="spline", device="cpu"), float)
    pe = 0.5 * (m * phi).sum()
    E.append((ke, pe))
E = np.array(E)
etot = E.sum(1)
fig, ax = plt.subplots(1, 2, figsize=(11, 4))
ax[0].plot(times, np.abs(etot / etot[0] - 1.0), "o-")
ax[0].set_yscale("log"); ax[0].set_xlabel("t"); ax[0].set_ylabel("|dE/E|")
ax[0].set_title("energy conservation")
ax[1].plot(times, E[:, 0] / -E[:, 1], "o-")
ax[1].axhline(0.5, color="k", ls="--", lw=0.8)
ax[1].set_xlabel("t"); ax[1].set_ylabel("Q = KE / |PE|")
ax[1].set_title("virial ratio")
plt.tight_layout()"""),
    ("code", """\
from nbody_streams_tpu_torch.utils import empirical_density_profile

snap0 = reader.read_snapshot(snaps[0])
snap1 = reader.read_snapshot(snaps[-1])
fig, ax = plt.subplots(figsize=(6, 4.5))
for snap, label in ((snap0, f"t={times[0]:.3f}"),
                    (snap1, f"t={times[-1]:.3f}")):
    pv = np.asarray(snap.species["dark"]["posvel"], float)
    m = np.asarray(snap.species["dark"]["mass"], float)
    r, rho = empirical_density_profile(pv[:, :3], m, bins=24)[:2]
    ax.loglog(r, rho, "o-", ms=3, label=label)
rr = np.geomspace(0.05, 10, 64)
rho_th = 3 * M_TOT / (4 * np.pi * A ** 3) * (1 + (rr / A) ** 2) ** -2.5
ax.loglog(rr, rho_th, "k--", lw=1, label="Plummer analytic")
ax.set_xlabel("r [kpc]"); ax.set_ylabel(r"$\\rho$ [Msun/kpc$^3$]")
ax.legend(); ax.set_title("density profile is stationary")
plt.tight_layout()"""),
    ("md", """\
An equilibrium model stays on the analytic profile over the run; the
same check at N = 100,000 on the card is
`nbody_streams_tpu_torch/examples/plummer_stability.py`."""),
]


MWLMC = [
    ("md", """\
# A stellar stream in the evolving MW + LMC potential

The reference's flagship stream workflow (reference:
`examples/MW_LMC_evolv.ipynb`): the Milky Way sits in a non-inertial
frame accelerated by the infalling LMC; a globular-cluster progenitor is
rewound in the combined time-dependent field and released as a
particle-spray stream along its orbit.  Everything here is
nbody_streams_tpu_torch — GalPot potentials, DP5(4) orbit integration,
Chen+2025 spray — with no Agama dependency, run on the CPU
(`device="cpu"`) so the notebook executes anywhere."""),
    ("code", """\
import numpy as np
import matplotlib.pyplot as plt

import sys, pathlib
sys.path.insert(0, str(pathlib.Path.cwd().parents[2]))
from nbody_streams_tpu_torch.potentials.mwlmc import load_mw_lmc_potential
from nbody_streams_tpu_torch.fast_sims.spray import create_particle_spray_stream"""),
    ("code", """\
pot, traj_lmc = load_mw_lmc_potential(device="cpu")
print(f"LMC trajectory table spans t = {traj_lmc[0,0]:.1f} .. "
      f"{traj_lmc[-1,0]:.1f} (time unit ~0.978 Gyr, t=0 = today)")"""),
    ("code", """\
# Sgr-like progenitor today (kpc, km/s)
sat_now = np.array([17.5, 2.5, -6.5, 237.9, -24.3, 209.0])
out = create_particle_spray_stream(
    pot_host=pot, initmass=1e8, sat_cen_present=sat_now,
    scaleradius=0.5, num_particles=2000, time_total=3.0,
    time_end=0.0, n_steps=1024, seed=3, verbose=True, device="cpu")
part = out["part_xv"]
prog_traj = out["prog_xv"]
print(f"stream: {part.shape[0]} particles")"""),
    ("code", """\
fig, ax = plt.subplots(1, 2, figsize=(12, 5))
ax[0].scatter(part[:, 0], part[:, 2], s=1, c="tab:blue", alpha=0.5,
              label="stream")
ax[0].plot(traj_lmc[:, 1], traj_lmc[:, 3], "r-", lw=1, label="LMC orbit")
ax[0].plot(sat_now[0], sat_now[2], "k*", ms=12, label="progenitor")
ax[0].set_xlabel("x [kpc]"); ax[0].set_ylabel("z [kpc]")
ax[0].legend(); ax[0].set_title("Galactocentric x-z")
ax[1].scatter(part[:, 0], part[:, 1], s=1, c="tab:blue", alpha=0.5)
ax[1].plot(traj_lmc[:, 1], traj_lmc[:, 2], "r-", lw=1)
ax[1].plot(sat_now[0], sat_now[1], "k*", ms=12)
ax[1].set_xlabel("x [kpc]"); ax[1].set_ylabel("y [kpc]")
ax[1].set_title("Galactocentric x-y")
plt.tight_layout()"""),
    ("code", """\
from nbody_streams_tpu_torch.coords import get_observed_stream_coords

prog_now = np.asarray(prog_traj, float)
prog_now = prog_now if prog_now.ndim == 1 else prog_now[-1]
obs = get_observed_stream_coords(part, xv_prog=prog_now)
fig, ax = plt.subplots(figsize=(8, 4.5))
sc = ax.scatter(obs["phi1"], obs["phi2"], s=2, c=obs["dist"],
                cmap="viridis")
plt.colorbar(sc, label="distance from observer [kpc]")
ax.set_xlabel(r"$\\phi_1$ [deg]"); ax.set_ylabel(r"$\\phi_2$ [deg]")
ax.set_title("stream-frame sky track + observables")
plt.tight_layout()"""),
    ("md", """\
The full pipeline — evolving two-galaxy potential, orbit rewind, spray
release, observable-frame projection — runs in one stack; the N-body
version of the same setup is `nbody_streams_tpu_torch/examples/
stream_nbody.py`."""),
]


def main():
    nbs = {
        "plummer_stability.ipynb": _nb(PLUMMER),
        "mw_lmc_stream.ipynb": _nb(MWLMC),
    }
    execute = "--skip-execute" not in sys.argv
    for name, nb in nbs.items():
        path = HERE / name
        if execute:
            from nbclient import NotebookClient

            print(f"executing {name} ...", flush=True)
            client = NotebookClient(nb, timeout=1800,
                                    resources={"metadata":
                                               {"path": str(HERE)}})
            client.execute()
        nbf.write(nb, path)
        print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
