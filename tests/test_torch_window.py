"""The sorted path's band and its counters (``cuda_direct.BRANCHES``'s
``widened``, ``window_rows`` and ``band_rows``) on the CPU.

Every ``_self_sorted`` call adds its widest band window and the band width
``nb`` it ran, in source rows, on both branches.  The band is the static
``band_rows`` where the window fits it, the window itself where it is
wider but at most ``BAND_MAX_SHARE`` of the rows (a widened band, still
the two passes), and the static band again on the single pass beyond.  At
N = 4,096 with 64-target tiles and 128-source rows the static band is 12
of 32 rows (its floor), so a cluster outgrows it only where its core is no
wider than the softening: the King cluster here has r_c = h = 0.02, and
its widest window is 19 rows.  A Plummer sphere (a = 1, h = 0.05) of the
same N fits the static band; the King cluster with h = 5, softening
larger than the system, spans every row and takes the single pass.
"""
import inspect

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


def _king(h=0.02):
    xv, m = sample_king(N, mass=5e6, r_core=0.02, W0=5.0, seed=2)
    return xv[:, :3], m, h


def _plummer():
    xv, m = make_plummer_sphere(N, M_total=1e9, a=1.0, seed=3)
    return np.asarray(xv)[:, :3], np.asarray(m), 0.05


#: (case, the branch it takes, the band it runs: the window or the static)
CASES = {"king": (_king, "two_pass", "window"),
         "plummer": (_plummer, "two_pass", "static"),
         "wide": (lambda: _king(5.0), "single_pass", "static")}


def _case(name):
    pos, m, h = CASES[name][0]()
    f32 = dict(dtype=torch.float32)
    return (torch.as_tensor(pos, **f32), torch.as_tensor(G * m, **f32),
            torch.full((N,), h, **f32))


def _window(pos, soft):
    """(widest window, static band, source rows), as the call finds them."""
    order = cd.slab_sort_key(pos)
    _, width, rows = cd.band_window(pos[order, 0], soft.max(), **GEOM)
    return int(width), cd.band_rows(rows), rows


def _band_of(name, width, static):
    return width if CASES[name][2] == "window" else static


@pytest.mark.parametrize("name", list(CASES))
def test_the_branch_follows_the_window(name):
    pos, gm, soft = _case(name)
    width, static, rows = _window(pos, soft)
    before = dict(cd.BRANCHES)
    cd._self_sorted(pos, gm, soft, "spline", True, "acc", 1e-15, **GEOM)
    took = {k: cd.BRANCHES[k] - before[k] for k in before}
    _, branch, band = CASES[name]
    fits = width <= static
    widened = not fits and width <= cd.BAND_MAX_SHARE * rows
    assert (fits or widened) is (branch == "two_pass"), (width, static)
    assert widened is (band == "window"), (width, static, rows)
    assert took[branch] == 1
    assert took["two_pass"] + took["single_pass"] == 1
    assert took["widened"] == int(widened)
    assert took["band_rows"] == _band_of(name, width, static)
    assert (took["window_rows"] > took["band_rows"]) is (name == "wide")


@pytest.mark.parametrize("mode", ["acc", "pot"])
@pytest.mark.parametrize("name", list(CASES))
def test_each_call_adds_its_width_and_band(name, mode):
    pos, gm, soft = _case(name)
    width, static, _ = _window(pos, soft)
    before = dict(cd.BRANCHES)
    for _ in range(2):
        cd._self_sorted(pos, gm, soft, "spline", True, mode, 1e-15, **GEOM)
    assert cd.BRANCHES["window_rows"] - before["window_rows"] == 2 * width
    assert (cd.BRANCHES["band_rows"] - before["band_rows"]
            == 2 * _band_of(name, width, static))


@pytest.mark.parametrize("name", list(CASES))
def test_the_passes_run_the_band_the_call_counts(name, monkeypatch):
    """Both passes take the counted band: the widened one on the King
    cluster, the static one on the Plummer sphere; the single pass skips
    none (``nb`` = 0)."""
    pos, gm, soft = _case(name)
    width, static, _ = _window(pos, soft)
    calls = []
    for fn in ("_direct_tile", "_band"):
        real = getattr(cd, fn)
        sig = inspect.signature(real)

        def spy(*a, _fn=fn, _real=real, _sig=sig, **kw):
            nb = _sig.bind(*a, **kw).arguments.get("nb", 0)
            calls.append((_fn, nb))
            return _real(*a, **kw)

        monkeypatch.setattr(cd, fn, spy)
    cd._self_sorted(pos, gm, soft, "spline", True, "acc", 1e-15, **GEOM)
    if CASES[name][1] == "single_pass":
        assert calls == [("_direct_tile", 0)]
    else:
        nb = _band_of(name, width, static)
        assert calls == [("_direct_tile", nb), ("_band", nb)]


@pytest.mark.parametrize("mode", ["acc", "pot"])
def test_a_window_that_fits_keeps_the_static_band_bitwise(mode):
    """Where the widest window fits the static band, the call runs that
    band from the same start rows as before the band could widen: its
    output is bit for bit the explicit base and band passes at
    ``band_rows(rows)``."""
    pos, gm, soft = _case("plummer")
    got = cd._self_sorted(pos, gm, soft, "spline", True, mode, 1e-15, **GEOM)
    order = cd.slab_sort_key(pos)
    ps, gs, hs = pos[order], gm[order], soft[order]
    hinv = cd._soft_pre("spline", hs)
    first, width, rows = cd.band_window(ps[:, 0], hs.max(), **GEOM)
    nb = cd.band_rows(rows)
    assert int(width) <= nb
    start = first.clamp(0, rows - nb).to(torch.int32).contiguous()
    tgt, src = cd._targets(ps, hinv), cd._sources(ps, gs, hinv, GEOM["tn"])
    mask = mode == "pot"
    out_s = (cd._direct_tile(tgt, src, "newtonian", mode, True, 1e-15, mask,
                             nb, start, **GEOM)
             + cd._band(tgt, src, start, mode, True, 1e-15, mask, nb=nb,
                        **GEOM))
    want = torch.empty_like(out_s)
    want[order] = out_s
    assert torch.equal(got, want)
