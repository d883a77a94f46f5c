"""Dynamical-friction tutorial: satellite orbital decay.

Native version of the reference's dynamical_friction_tutorial notebook:
a compact satellite orbits inside an NFW host; with Chandrasekhar
friction enabled its orbit decays, without it the orbit persists.  The
DF force runs *inside* the scanned KDK step (no host round-trips).

Usage:  python nbody_streams_tpu_torch/examples/dynamical_friction_tutorial.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

import nbody_streams_tpu_torch as nst
from nbody_streams_tpu_torch.potentials import NFWPotential


def run(dynamical_friction: bool, tmp: str):
    host = NFWPotential(mass=1e12, scaleRadius=20.0)
    n = 2000
    xv, m = nst.make_plummer_sphere(n, M_total=5e9, a=0.5, seed=4)
    xv[:, 0] += 40.0                    # start 40 kpc out
    xv[:, 4] += 120.0                   # mildly eccentric tangential orbit
    species = [nst.Species.dark(N=n, mass=float(m[0]), softening=0.05)]
    df_kw = dict(df_M_sat=5e9, df_sigma_method="jeans",
                 df_update_interval=10) if dynamical_friction else {}
    res = nst.run_simulation(
        xv, species, 0.0, 1.5, 2e-3,
        architecture="auto",
        external_potential=host,
        dynamical_friction=dynamical_friction,
        output_dir=tmp, save_snapshots=False, verbose=False,
        **df_kw,
    )
    com = np.average(res["dark"][:, :3], axis=0,
                     weights=np.full(n, float(m[0])))
    return float(np.linalg.norm(com))


def main():
    import tempfile

    with tempfile.TemporaryDirectory() as d1:
        r_df = run(True, d1)
    with tempfile.TemporaryDirectory() as d2:
        r_free = run(False, d2)
    print(f"final galactocentric radius: with DF {r_df:.1f} kpc, "
          f"without {r_free:.1f} kpc")
    assert r_df < r_free, "friction should shrink the orbit"
    print("OK: dynamical friction decays the satellite orbit")


if __name__ == "__main__":
    main()
