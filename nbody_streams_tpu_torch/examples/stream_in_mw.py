"""Generate and plot a stellar stream in the Milky Way potential
(the reference's stream-generation workflow, without Agama).

Run:  python nbody_streams_tpu_torch/examples/stream_in_mw.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

from nbody_streams_tpu_torch.fast_sims import create_particle_spray_stream
from nbody_streams_tpu_torch.potentials import make_potential
from nbody_streams_tpu_torch.viz import plot_stream_sky

DATA = Path(__file__).resolve().parent.parent / \
    "data/potentials/MWPotential22.ini"

mw = make_potential(file=str(DATA))

# A Pal5-like progenitor: 2e4 Msun King cluster on an eccentric orbit
sat_present = np.array([8.3, 0.2, 16.9, -52.0, -96.0, -8.0])
res = create_particle_spray_stream(
    mw, initmass=2e4, sat_cen_present=sat_present, scaleradius=0.02,
    num_particles=4000, prog_pot_kind="King", W0=4.0,
    time_total=2.0, time_end=0.0, n_steps=2000, verbose=True,
)

stream = res["part_xv"]
print(f"stream particles: {stream.shape}, "
      f"extent {np.ptp(stream[:, 0]):.1f} x {np.ptp(stream[:, 2]):.1f} kpc")

ax, obs = plot_stream_sky(stream, res["prog_xv"],
                          color_by="dist", s=0.5)
ax.figure.savefig("stream_sky.png", dpi=150)
print("wrote stream_sky.png; phi1 span:",
      float(obs["phi1"].max() - obs["phi1"].min()), "deg")
