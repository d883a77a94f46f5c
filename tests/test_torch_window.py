"""The sorted path's band-window counters (``cuda_direct.BRANCHES``'s
``window_rows`` and ``band_rows``) on the CPU.

Every ``_self_sorted`` call adds its widest band window and its band width
``nb``, in source rows, on both branches; the branch follows from the two.
At N = 4,096 with 64-target tiles and 128-source rows the band is 12 of 32
rows (its floor), so a cluster overflows it only where its core is no
wider than the softening: the King cluster here has r_c = h = 0.02.  A
Plummer sphere (a = 1, h = 0.05) of the same N fits.
"""
import numpy as np
import pytest
import torch

from nbody_streams_tpu_torch.fast_sims.king import sample_king
from nbody_streams_tpu_torch.ic import make_plummer_sphere
from nbody_streams_tpu_torch.ops import cuda_direct as cd

torch.set_num_threads(2)

N = 4096
GEOM = {"tm": 64, "tn": 128}
G = 4.300917270069976e-06


def _king():
    xv, m = sample_king(N, mass=5e6, r_core=0.02, W0=5.0, seed=2)
    return xv[:, :3], m, 0.02


def _plummer():
    xv, m = make_plummer_sphere(N, M_total=1e9, a=1.0, seed=3)
    return np.asarray(xv)[:, :3], np.asarray(m), 0.05


CASES = {"king": (_king, "single_pass"), "plummer": (_plummer, "two_pass")}


def _case(name):
    pos, m, h = CASES[name][0]()
    f32 = dict(dtype=torch.float32)
    return (torch.as_tensor(pos, **f32), torch.as_tensor(G * m, **f32),
            torch.full((N,), h, **f32))


def _window(pos, soft):
    """(widest window, band width) in source rows, as the call finds them."""
    order = cd.slab_sort_key(pos)
    _, width, rows = cd.band_window(pos[order, 0], soft.max(), **GEOM)
    return int(width), cd.band_rows(rows)


@pytest.mark.parametrize("name", list(CASES))
def test_the_branch_follows_the_window(name):
    pos, gm, soft = _case(name)
    width, nb = _window(pos, soft)
    before = dict(cd.BRANCHES)
    cd._self_sorted(pos, gm, soft, "spline", True, "acc", 1e-15, **GEOM)
    took = {k: cd.BRANCHES[k] - before[k] for k in before}
    branch = CASES[name][1]
    assert (width > nb) is (branch == "single_pass"), (width, nb)
    assert took[branch] == 1
    assert took["two_pass"] + took["single_pass"] == 1
    assert (took["window_rows"] > took["band_rows"]) is (name == "king")


@pytest.mark.parametrize("mode", ["acc", "pot"])
@pytest.mark.parametrize("name", list(CASES))
def test_each_call_adds_its_width_and_band(name, mode):
    pos, gm, soft = _case(name)
    width, nb = _window(pos, soft)
    before = dict(cd.BRANCHES)
    for _ in range(2):
        cd._self_sorted(pos, gm, soft, "spline", True, mode, 1e-15, **GEOM)
    assert cd.BRANCHES["window_rows"] - before["window_rows"] == 2 * width
    assert cd.BRANCHES["band_rows"] - before["band_rows"] == 2 * nb
