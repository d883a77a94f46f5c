"""Surface-density rendering methods compared.

Native version of the reference's pretty_density_methods notebook:
renders the same star cluster with the three `plot_density` methods
(SPH splatting, Gaussian smoothing, plain histogram) side by side and
saves a PNG.

Usage:  python nbody_streams_tpu_torch/examples/density_methods.py [out.png]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from nbody_streams_tpu_torch import make_plummer_sphere
from nbody_streams_tpu_torch.viz.plots import plot_density


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "density_methods.png"
    xv, m = make_plummer_sphere(40_000, M_total=1e9, a=1.0, seed=7)
    # make it visually interesting: add an off-centre satellite clump
    xv2, m2 = make_plummer_sphere(8_000, M_total=1e8, a=0.3, seed=8)
    xv2[:, 0] += 2.5
    pos = np.concatenate([xv[:, :3], xv2[:, :3]])
    mass = np.concatenate([m, m2])

    fig, axes = plt.subplots(1, 3, figsize=(14, 4.4))
    for ax, method in zip(axes, ("sph", "gauss_smooth", "histogram")):
        plot_density(pos, mass, method=method, npix=256, ax=ax,
                     extent=(-4.0, 4.0, -4.0, 4.0))
        ax.set_title(method)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
