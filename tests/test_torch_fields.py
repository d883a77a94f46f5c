"""The port's composite fields against the JAX package's, on the CPU:
the stacked evolving Multipole and CylSpline paths, GalPot (McMillan17 and
the builders) and the MW+LMC evolving field, plus the float32 error of the
four fields of chip_smoke.py phase (i) against the card's tolerances.

Inputs are made from a seed with numpy (or read from ``tests/data`` and
the packages' data directories) and go through both packages.
Tolerances (max |port - JAX| / max |JAX|): built tables equal; float64
potential, force and Hessian 1e-10; float32 against float64 within
``chip_smoke.FIELD_TOL``, which is four times the JAX package's own
float32 error at the same points.
"""
import copy
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_streams_tpu.potentials as J
import nbody_streams_tpu_torch.potentials as T
from nbody_streams_tpu.potentials import mwlmc as jmwlmc
from nbody_streams_tpu_torch import make_plummer_sphere

import chip_smoke
from nbody_streams_tpu_torch.benchmarks.fields import (
    field_builders, field_points)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "data"
JDATA = ROOT / "nbody_streams_tpu" / "data" / "potentials"
TDATA = ROOT / "nbody_streams_tpu_torch" / "data" / "potentials"
MULT = ["100.LMC.none_8.coef_mult", "600.dark.none_8.coef_mul_DR"]
CYL = "600.bar.none_8.coef_cylsp_DR"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, want):
    got, want = _np(got).astype(float), _np(want).astype(float)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _evals(pot, x, t=0.0, hess=False):
    out = [pot.potential(x, t), pot.force(x, t)]
    if hess:
        out.append(pot.forceDeriv(x, t)[1])
    return tuple(_np(v) for v in out)


def _jax_evals(pot, x, times, hess=False):
    """The JAX package's (phi, force[, -hess6]) at each time, through one
    jit of its evaluators (eager calls retrace the whole field)."""
    fn = jax.jit(lambda x, t: _evals_jax(pot, x, t, hess))
    return [tuple(np.asarray(v) for v in fn(x, t)) for t in times]


def _evals_jax(pot, x, t, hess):
    out = [pot.potential(x, t), pot.force(x, t)]
    if hess:
        out.append(pot.forceDeriv(x, t)[1])
    return out


def _assert_parity(tp, jp, x, times=(0.0,), tol=1e-10, hess=False):
    """Port vs JAX, float64: potential, force (and the Hessian) within
    ``tol`` of their max at every time."""
    for t, want in zip(times, _jax_evals(jp, x, times, hess)):
        for g, w in zip(_evals(tp, x, t, hess), want):
            assert g.shape == w.shape
            assert _rel(g, w) < tol


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(17)
    r = 10.0 ** rng.uniform(-1.0, 2.5, 96)
    v = rng.normal(size=(96, 3))
    x = r[:, None] * v / np.linalg.norm(v, axis=1)[:, None]
    x[:3] = [[2.0, 0.0, 0.0], [0.0, 0.0, 7.0], [-8.0, 3.0, -2.0]]
    return x


# ---------------------------------------------------------------------------
# stacked evolving paths
# ---------------------------------------------------------------------------

def _nfw_mult(pkg, mass, rs):
    p = pkg.NFWPotential(mass=mass, scaleRadius=rs)
    return pkg.MultipolePotential.from_projection(
        lambda q: _np(p.potential(q)), np.geomspace(0.1, 50.0, 40), lmax=0)


def test_evolving_multipole_stacked_matches_jax():
    """The stacked Multipole path (3+ homogeneous snapshots) against the
    JAX package's, inside and beyond the radial grid; 2 snapshots take
    the bracketing path."""
    specs = [(1e12, 16.0), (1.5e12, 18.0), (2e12, 20.0)]
    times = [0.0, 1.0, 2.0]
    jev = J.EvolvingPotential([_nfw_mult(J, *s) for s in specs], times)
    tev = T.EvolvingPotential([_nfw_mult(T, *s) for s in specs], times)
    assert tev._stacked == "multipole" and jev._stacked is not None
    x = np.array([[120.0, 0.0, 0.0], [0.03, 0.0, 0.0], [30.0, 5.0, -2.0]])
    _assert_parity(tev, jev, x, (0.5, 1.7, 5.0))
    slow = T.EvolvingPotential(list(tev.pots)[:2], times[:2])
    assert slow._stacked is None
    jslow = J.EvolvingPotential(list(jev.pots)[:2], times[:2])
    _assert_parity(slow, jslow, x, (0.5,))


def test_evolving_cylspline_stacked_matches_jax():
    def make(pkg, mass):
        mn = pkg.MiyamotoNagaiPotential(mass=mass, scaleRadius=3.0,
                                        scaleHeight=0.4)
        r_grid = np.concatenate([[0.0], np.geomspace(0.1, 60.0, 24)])
        zp = np.geomspace(0.05, 12.0, 12)
        z_grid = np.concatenate([-zp[::-1], [0.0], zp])
        rr, zz = np.meshgrid(r_grid, z_grid, indexing="ij")
        p = np.column_stack([rr.ravel(), np.zeros(rr.size), zz.ravel()])
        tab = _np(mn.potential(p)).reshape(rr.shape)
        return pkg.CylSplinePotential(pkg.CylSplineCoefs(
            R_grid=r_grid, z_grid=z_grid, m_values=[0], phi=tab[None]))

    times = np.linspace(0, 7, 4)
    masses = np.linspace(4e10, 6e10, 4)
    jev = J.EvolvingPotential([make(J, m) for m in masses], times)
    tev = T.EvolvingPotential([make(T, m) for m in masses], times)
    assert tev._stacked == "cylspline"
    x = np.array([[8.0, 2.0, 0.5], [20.0, 0.0, 3.0], [90.0, 0.0, 40.0]])
    _assert_parity(tev, jev, x, (2.6, 7.5))


# ---------------------------------------------------------------------------
# galpot / mwlmc
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mcmillan():
    return (J.make_potential(file=JDATA / "McMillan17.ini"),
            T.make_potential(file=TDATA / "McMillan17.ini", device="cpu"))


def test_galpot_mcmillan17_matches_jax(mcmillan, pts):
    jp, tp = mcmillan
    assert len(tp) == len(jp)
    for jc, tc in zip(jp.components, tp.components):
        for jm, tm in zip(getattr(jc, "components", [jc]),
                          getattr(tc, "components", [tc])):
            assert type(tm).__name__ == type(jm).__name__
            if type(tm).__name__ == "MultipolePotential":
                np.testing.assert_array_equal(_np(tm.coeffs),
                                              np.asarray(jm.coeffs))
    _assert_parity(tp, jp, pts[:48])
    f = _np(tp.force([[8.21, 0.0, 0.0]]))[0]
    assert np.sqrt(-f[0] * 8.21) == pytest.approx(233.1, rel=0.01)
    fz = _np(tp.force([[8.2, 0, 0.5], [8.2, 0, -0.5]]))
    assert fz[0, 2] < 0 < fz[1, 2]


def test_galpot_builders_match_jax(pts):
    from nbody_streams_tpu.potentials import galpot as jg
    from nbody_streams_tpu_torch.potentials import galpot as tg

    for name, kw in (("build_spheroid", dict(mass=1e10, scaleRadius=2.0,
                                             axisRatioZ=0.6,
                                             outerCutoffRadius=30.0,
                                             lmax=6, gridSizeR=24)),
                     ("build_sersic", dict(mass=1e10, scaleRadius=2.0,
                                           sersicIndex=2.0, gridSizeR=24)),
                     ("build_disk", dict(mass=3e10, scaleRadius=2.5,
                                         scaleHeight=-0.2, lmax=8,
                                         gridSizeR=24, n_theta=64)),
                     ("build_king", dict(mass=1e5, scaleRadius=0.01,
                                         W0=5.0))):
        _assert_parity(getattr(tg, name)(**kw), getattr(jg, name)(**kw),
                       pts[:32])
    king = T.make_potential(type="King", mass=1e5, scaleRadius=0.01, W0=5,
                            device="cpu")
    _assert_parity(king, jg.build_king(mass=1e5, scaleRadius=0.01, W0=5.0),
                   pts[:32])


@pytest.fixture(scope="module")
def mwlmc():
    return (jmwlmc.load_mw_lmc_potential(),
            T.load_mw_lmc_potential(device="cpu"))


def test_mwlmc_matches_jax(mwlmc, pts):
    """The evolving MW + LMC field at three times, one a table node,
    from the port's own copy of the fixture directory."""
    (jp, jtraj), (tp, ttraj) = mwlmc
    base = T.mw_lmc_data_dir()
    assert base.is_relative_to(ROOT / "nbody_streams_tpu_torch")
    for name in ("McMillan17_streams.ini", "LMC_vasiliev21.ini",
                 "trajLMC_McM17streams", "accMW_McM17streams"):
        assert (base / name).read_bytes() == \
            (jmwlmc.mw_lmc_data_dir() / name).read_bytes()
    np.testing.assert_array_equal(ttraj, jtraj)
    assert tp.time_dependent
    x = pts[:40]
    _assert_parity(tp, jp, x, (-1.0, -0.4137, -4.0))
    f = _np(tp.force([[8.2, 0.0, 0.0]], t=0.0))
    assert 220.0 < np.sqrt(-f[0, 0] * 8.2) < 245.0


# ---------------------------------------------------------------------------
# float32 error of the card's fields
# ---------------------------------------------------------------------------

JAX_FIELDS = {
    "MWPotential22": lambda: J.load_potential_ini(JDATA / "MWPotential22.ini"),
    "McMillan17_streams": lambda: J.make_potential(
        file=JDATA / "MW_LMC_evolv" / "McMillan17_streams.ini"),
    "MW+LMC": lambda: jmwlmc.load_mw_lmc_potential()[0],
    "FIRE BFE": lambda: J.CompositePotential([
        J.MultipolePotential(FIX / "600.dark.none_8.coef_mul_DR"),
        J.CylSplinePotential(FIX / CYL)]),
}


@pytest.mark.parametrize("name", sorted(chip_smoke.FIELD_TOL))
def test_field_fp32_error_within_chip_tolerance(name):
    """chip_smoke.FIELD_TOL is four times the JAX package's own float32
    vs float64 error (force, potential) at the first 2,048 of phase (i)'s
    points, rounded up by less than a quarter; the port's float32 on the
    CPU stays within it too.  The
    float64 reference is the port's (each field's float64 parity with the
    JAX package is held above and in test_torch_bfe.py /
    test_torch_potentials.py), so the JAX side compiles once."""
    build, times = field_builders()[name]
    t = times[0]
    x32 = field_points(chip_smoke.N_BENCH)[:2048]
    with jax.enable_x64(False):
        jp = JAX_FIELDS[name]()
        j32 = jax.jit(lambda q: (jp.potential(q, t), jp.force(q, t)))(
            jnp.asarray(x32))
        j32 = tuple(np.asarray(v) for v in j32)
    assert j32[1].dtype == np.float32
    p64 = build()
    p32 = copy.deepcopy(p64).to(torch.float32)
    t64 = _evals(p64, torch.tensor(x32.astype(np.float64)), t)
    t32 = _evals(p32, torch.tensor(x32), t)
    tol_f, tol_p = chip_smoke.FIELD_TOL[name]
    for k, tol in ((1, tol_f), (0, tol_p)):
        own = _rel(j32[k], t64[k])
        assert 4 * own <= tol <= 5 * own
        assert _rel(t32[k], t64[k]) <= tol


def test_fields_benchmark_needs_the_card():
    """benchmarks.fields times the card and refuses to run without one."""
    from nbody_streams_tpu_torch.benchmarks import fields

    with pytest.raises(SystemExit, match="no CUDA device"):
        fields.main()
