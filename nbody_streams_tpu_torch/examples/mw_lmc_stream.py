"""Stellar stream in the evolving MW + LMC potential.

Native version of the reference's flagship workflow
(reference: examples/MW_LMC_evolv.ipynb): the Milky Way sits in a
non-inertial frame accelerated by the infalling LMC; a globular-cluster
progenitor is rewound 3 time units (~2.9 Gyr) in the combined field and
a particle-spray stream is released along its orbit, on the card.

Usage:  python nbody_streams_tpu_torch/examples/mw_lmc_stream.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import time

import numpy as np

from nbody_streams_tpu_torch.fast_sims.spray import create_particle_spray_stream
from nbody_streams_tpu_torch.potentials.mwlmc import load_mw_lmc_potential


def main():
    t0 = time.time()
    pot, traj_lmc = load_mw_lmc_potential()
    print(f"MW+LMC potential built in {time.time() - t0:.1f} s "
          f"(LMC table spans t = {traj_lmc[0, 0]:.1f} .. "
          f"{traj_lmc[-1, 0]:.1f})")

    # Sgr-like progenitor today (position kpc, velocity km/s)
    sat_now = np.array([17.5, 2.5, -6.5, 237.9, -24.3, 209.0])

    t0 = time.time()
    out = create_particle_spray_stream(
        pot_host=pot,
        initmass=1e8,
        sat_cen_present=sat_now,
        scaleradius=0.5,
        num_particles=4000,
        time_total=3.0,      # rewind ~2.9 Gyr
        time_end=0.0,        # present day (table convention)
        n_steps=1024,
        seed=3,
        verbose=True,
    )
    part = out["part_xv"]
    print(f"stream generated in {time.time() - t0:.1f} s: "
          f"{part.shape[0]} particles")

    r = np.linalg.norm(part[:, :3], axis=1)
    print(f"stream galactocentric radius: median {np.median(r):.1f} kpc, "
          f"5-95% {np.percentile(r, 5):.1f}..{np.percentile(r, 95):.1f}")
    spread = np.ptp(np.linalg.norm(part[:, :3]
                                   - out["prog_xv"][None, :3], axis=1))
    print(f"stream extent around progenitor: {spread:.1f} kpc")
    assert np.isfinite(part).all()
    print("OK")


if __name__ == "__main__":
    main()
