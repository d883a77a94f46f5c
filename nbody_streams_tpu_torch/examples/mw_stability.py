"""Milky Way multi-species stability test — fully native IC generation.

Mirrors the reference's flagship `examples/MW_gpu_tree_stability.ipynb`
(three-component MW: Spheroid bulge + Disk + Spheroid halo, sampled from
distribution functions, integrated with `run_simulation(debug_energy=True)`
and analysed from snapshots) — but with NO Agama dependency: the potential
comes from the native GalPot builders (`potentials/galpot.py`) and the ICs
from the native DF samplers (`df.py`: Eddington quasispherical for
halo/bulge, epicyclic+vertical-Jeans warm disk).

Run:  python nbody_streams_tpu_torch/examples/mw_stability.py [N_total] [steps]
Defaults: N_total=40_000, steps=800, dt=2.5e-4 (~0.25 Myr — resolves the
bulge crossing time; ~1 rotation period at the solar circle in total).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import time

import numpy as np

from nbody_streams_tpu_torch import (
    ParticleReader,
    Species,
    run_simulation,
    sample_disk,
    sample_quasispherical,
)
from nbody_streams_tpu_torch.potentials import make_potential
from nbody_streams_tpu_torch.potentials.galpot import SpheroidDensity

N_TOTAL = int(sys.argv[1]) if len(sys.argv) > 1 else 40_000
STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 800
DT = 2.5e-4
OUT = "./output_mw_stability"

# ── Milky Way model (the reference notebook's parameters) ───────────────────
paramBulge = dict(type="Spheroid", mass=1.2e10, scaleRadius=0.2,
                  outerCutoffRadius=1.8, gamma=0.0, beta=1.8)
paramDisk = dict(type="Disk", mass=5.0e10, scaleRadius=3.0,
                 scaleHeight=-0.4)          # sech^2, b = 0.4 kpc
paramHalo = dict(type="Spheroid", densityNorm=1.35e7, scaleRadius=14.0,
                 outerCutoffRadius=300.0, cutoffStrength=4.0,
                 gamma=1.0, beta=3.0)

print("Building native GalPot potential (bulge + disk + halo) ...")
pot_bulge = make_potential(**paramBulge)
pot_disk = make_potential(**paramDisk)
pot_halo = make_potential(**paramHalo)
pot_mw = pot_bulge + pot_disk + pot_halo

dens_bulge = SpheroidDensity(**{k: v for k, v in paramBulge.items()
                                if k not in ("type", "mass")},
                             densityNorm=1.0)
dens_bulge.rho0 *= paramBulge["mass"] / dens_bulge.total_mass()
dens_halo = SpheroidDensity(**{k: v for k, v in paramHalo.items()
                               if k != "type"})

M_halo = dens_halo.total_mass()
M_bulge = paramBulge["mass"]
M_disk = paramDisk["mass"]
M_tot = M_halo + M_bulge + M_disk
N_halo = int(round(N_TOTAL * M_halo / M_tot))
N_bulge = int(round(N_TOTAL * M_bulge / M_tot))
N_disk = N_TOTAL - N_halo - N_bulge
print(f"M_halo={M_halo:.3e}  M_bulge={M_bulge:.3e}  M_disk={M_disk:.3e}")
print(f"N_halo={N_halo}  N_bulge={N_bulge}  N_disk={N_disk}")


# spherically averaged full potential for the Eddington DFs (the disk makes
# psi non-spherical; average over polar angle like an l=0 projection)
class _SphericalAvg:
    def __init__(self, pot, n_theta=8):
        x, w = np.polynomial.legendre.leggauss(n_theta)
        self.ct = 0.5 * (x + 1.0)           # cos(theta) in (0, 1), z-symmetry
        self.w = 0.5 * w
        self.pot = pot

    def potential(self, pts, t=0.0):
        r = np.linalg.norm(np.asarray(pts, float), axis=1)
        st = np.sqrt(1.0 - self.ct**2)
        p = np.stack([r[:, None] * st[None, :],
                      np.zeros((r.size, self.ct.size)),
                      r[:, None] * self.ct[None, :]], axis=-1)
        phi = self.pot.potential(p.reshape(-1, 3), t=t).cpu().numpy(
        ).astype(float).reshape(r.size, -1)
        return (phi * self.w[None, :]).sum(1)


pot_sph = _SphericalAvg(pot_mw)

# ── Sample ICs from the native DFs ───────────────────────────────────────────
print("Sampling halo / bulge (Eddington) and disk (quasi-isothermal) ...")
t0 = time.perf_counter()
xv_halo, m_halo = sample_quasispherical(
    dens_halo, pot_sph, N_halo, seed=1,
    r_grid=np.geomspace(3e-2, 700.0, 384))
xv_bulge, m_bulge = sample_quasispherical(
    dens_bulge, pot_sph, N_bulge, seed=2,
    r_grid=np.geomspace(3e-3, 60.0, 384))
xv_disk, m_disk = sample_disk(
    N_disk, pot_mw, mass=M_disk, scaleRadius=3.0, scaleHeight=-0.4,
    seed=3, toomre_Q=1.5)
print(f"  sampled in {time.perf_counter() - t0:.1f} s")

xv0 = np.concatenate([xv_halo, xv_bulge, xv_disk])
species = [
    Species.dark(N=N_halo, mass=float(m_halo[0]), softening=0.2),
    Species.star(N=N_bulge + N_disk,
                 mass=np.concatenate([m_bulge, m_disk]), softening=0.1),
]

# ── IC verification: rotation curve from disk particles ─────────────────────
sl_disk = slice(N_halo + N_bulge, None)
R = np.hypot(xv0[sl_disk, 0], xv0[sl_disk, 1])
vphi = (xv0[sl_disk, 0] * xv0[sl_disk, 4]
        - xv0[sl_disk, 1] * xv0[sl_disk, 3]) / R
for Rq in (4.0, 8.2, 15.0):
    sel = np.abs(R - Rq) < 1.0
    f = pot_mw.force(np.array([[Rq, 0.0, 0.0]])).cpu().numpy()
    vc = np.sqrt(-f[0, 0] * Rq)
    print(f"  R={Rq:5.1f} kpc: vc={vc:6.1f} km/s, "
          f"disk <v_phi>={vphi[sel].mean():6.1f} "
          f"(asym. drift {vc - vphi[sel].mean():5.1f})")

# ── Integrate ────────────────────────────────────────────────────────────────
# Hang recovery for long runs: the driver watchdog turns a wedged device
# dispatch into a saved emergency restart + fast failure, and a rerun of
# this script resumes from it (the ICs above are
# deterministic, so the analysis below is unaffected).
_restart = Path(OUT) / "restart.npz"
_resume = False
if _restart.exists():
    _step = int(np.load(_restart)["step"])
    _resume = 0 < _step < STEPS
    if _resume:
        print(f"resuming from restart.npz at step {_step}/{STEPS}")
t0 = time.perf_counter()
result = run_simulation(
    xv0, species, 0.0, STEPS * DT, DT,
    architecture="auto", method="direct",
    output_dir=OUT, snapshots=20, verbose=True, debug_energy=True,
    step_timeout_s=60, restart_interval=100,
    **({"continue_run": True} if _resume else {"overwrite": True}),
)
print(f"run: {time.perf_counter() - t0:.1f} s")

# ── Post-run analysis from snapshots (reference notebook's read-back) ───────
reader = ParticleReader(str(Path(OUT) / "snapshot*.h5"))
orbits = reader.extract_orbits("star")
print(f"snapshots read back: star orbits array {orbits.posvel.shape}")
star_final = result["star"]
R_fin = np.hypot(star_final[N_bulge:, 0], star_final[N_bulge:, 1])
# disk scale length from exponential fit of 2-D surface density
def scale_length(Rp):
    hist, edges = np.histogram(Rp, bins=np.linspace(1.0, 15.0, 24))
    mid = 0.5 * (edges[:-1] + edges[1:])
    sd = hist / (2 * np.pi * mid * np.diff(edges))
    ok = sd > 0
    return -1.0 / np.polyfit(mid[ok], np.log(sd[ok]), 1)[0]

print(f"disk scale length: {scale_length(R):.2f} -> "
      f"{scale_length(R_fin):.2f} kpc (input 3.0)")
hm0 = np.median(np.linalg.norm(xv_halo[:, :3], axis=1))
hm1 = np.median(np.linalg.norm(result["dark"][:, :3], axis=1))
print(f"halo half-mass radius: {hm0:.1f} -> {hm1:.1f} kpc")

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from nbody_streams_tpu_torch.viz import plot_density

    m_star = np.concatenate([m_bulge, m_disk])
    for axes, tag in (((0, 1), "faceon"), ((0, 2), "edgeon")):
        ax, _ = plot_density(star_final[:, :3], m_star,
                             method="sph", extent=20.0, axes=axes)
        out_png = Path(OUT) / f"mw_disk_{tag}.png"
        ax.figure.savefig(out_png, dpi=130)
        plt.close(ax.figure)
        print(f"wrote {out_png}")

    # rotation curve: initial analytic vc vs final disk <v_phi>(R)
    R_f = np.hypot(star_final[N_bulge:, 0], star_final[N_bulge:, 1])
    vphi_f = (star_final[N_bulge:, 0] * star_final[N_bulge:, 4]
              - star_final[N_bulge:, 1] * star_final[N_bulge:, 3]) / R_f
    bins = np.linspace(1.0, 18.0, 35)
    mid = 0.5 * (bins[:-1] + bins[1:])
    prof0 = np.full(mid.size, np.nan)
    prof1 = np.full(mid.size, np.nan)
    for i in range(mid.size):
        s0 = (R >= bins[i]) & (R < bins[i + 1])
        s1 = (R_f >= bins[i]) & (R_f < bins[i + 1])
        if s0.sum() > 20:
            prof0[i] = vphi[s0].mean()
        if s1.sum() > 20:
            prof1[i] = vphi_f[s1].mean()
    f = pot_mw.force(np.stack(
        [mid, np.zeros_like(mid), np.zeros_like(mid)], axis=1)).cpu().numpy()
    vc_mid = np.sqrt(np.maximum(-f[:, 0] * mid, 0.0))
    fig, axp = plt.subplots(figsize=(6, 4))
    axp.plot(mid, vc_mid, "k-", label="analytic $v_c$ (t=0 potential)")
    axp.plot(mid, prof0, "C0--", label=r"disk $\langle v_\phi\rangle$, t=0")
    axp.plot(mid, prof1, "C1-", label=(r"disk $\langle v_\phi\rangle$, "
                                       f"t={STEPS * DT * 0.978:.2f} Gyr"))
    axp.set_xlabel("R [kpc]"); axp.set_ylabel("v [km/s]")
    axp.legend(frameon=False); fig.tight_layout()
    out_png = Path(OUT) / "mw_rotation_curve.png"
    fig.savefig(out_png, dpi=130)
    plt.close(fig)
    print(f"wrote {out_png}")
except Exception as exc:  # pragma: no cover - plotting is best-effort
    print(f"(plot skipped: {exc})")
