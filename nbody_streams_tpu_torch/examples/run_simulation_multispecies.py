"""Multi-species simulation + output analysis round trip.

Native version of the reference's run_simulation notebook: a two-species
(dark + star) Plummer system with a central black-hole particle,
integrated with snapshots, then read back with ParticleReader and
profiled with the analysis utilities.

Usage:  python nbody_streams_tpu_torch/examples/run_simulation_multispecies.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import tempfile

import numpy as np

import nbody_streams_tpu_torch as nst
from nbody_streams_tpu_torch.utils import (
    empirical_density_profile,
    find_center,
    iterative_unbinding,
)


def main():
    n_dark, n_star = 6000, 2000
    xv_d, m_d = nst.make_plummer_sphere(n_dark, M_total=8e8, a=1.2, seed=1)
    xv_s, m_s = nst.make_plummer_sphere(n_star, M_total=2e8, a=0.6, seed=2)
    xv_bh = np.zeros((1, 6))
    xv = np.concatenate([xv_d, xv_s, xv_bh])

    species = [
        nst.Species.dark(N=n_dark, mass=float(m_d[0]), softening=0.08),
        nst.Species.star(N=n_star, mass=float(m_s[0]), softening=0.04),
        nst.Species(name="bh", N=1, mass=1e7, softening=0.01),
    ]

    with tempfile.TemporaryDirectory() as out:
        res = nst.run_simulation(
            xv, species, 0.0, 0.01, 2e-5,
            architecture="auto", output_dir=out,
            snapshots=5, debug_energy=True, verbose=True,
        )
        print({k: v.shape for k, v in res.items()})

        reader = nst.ParticleReader(f"{out}/snapshot.h5")
        print("snapshot times:", np.round(reader.Times.time, 5))
        snap = reader.read_snapshot(int(reader.Times.snap[-1]))
        stars = snap.species["star"]["posvel"]

        centre = find_center(stars[:, :3],
                             mass=np.full(n_star, float(m_s[0])))
        r, rho, _counts = empirical_density_profile(
            stars[:, :3], np.full(n_star, float(m_s[0])),
            center=centre, bins=15)
        print("star density profile (first 3 bins):",
              np.round(rho[:3], 1))

        keep, _info = iterative_unbinding(
            res["dark"][:, :3], res["dark"][:, 3:],
            np.full(n_dark, float(m_d[0])))
        print(f"bound dark fraction: {keep.mean():.3f}")
    print("OK")


if __name__ == "__main__":
    main()
