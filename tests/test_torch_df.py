"""The port's DF samplers (df.py) and King models (fast_sims/king.py)
against the JAX package's.

Both packages draw from ``default_rng(seed)`` in the same order and
evaluate the same potentials, so the samples agree to round-off: the
Eddington tables to 1e-10 of their largest value, positions and
velocities to 1e-12 of their largest value (every rejection decision
comes out the same; measured ~2e-13).  The King model's ODE tables,
potential and samples agree with the JAX package's, and ``type=King``
builds through ``make_potential``.  The JAX package's property tests
(tests/test_df.py) are mirrored on the port.
"""
import numpy as np
import pytest
import torch

import nbody_streams_tpu as jst
import nbody_streams_tpu_torch as tst
from nbody_streams_tpu import potentials as JP
from nbody_streams_tpu.fast_sims import king as jking
from nbody_streams_tpu_torch import potentials as TP
from nbody_streams_tpu_torch.fast_sims import king as tking

torch.set_num_threads(2)

G = tst.G_DEFAULT


def _plummer_density(M, a):
    return lambda pts: (3 * M / (4 * np.pi * a**3)) * (
        1 + (np.linalg.norm(np.asarray(pts, float), axis=1) / a) ** 2
    ) ** -2.5


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = np.abs(want).max(axis=0)
    assert (np.abs(got - want).max(axis=0) <= tol * scale).all()


def _tracer_case(pkg):
    kw = {} if pkg is JP else dict(device="cpu")
    host = pkg.make_potential(type="NFW", mass=8e11, scaleRadius=16.0, **kw)
    bulge = pkg.make_potential(type="Hernquist", mass=1e10,
                               scaleRadius=0.6, **kw)
    return bulge, host + bulge


def _mw(pkg):
    kw = {} if pkg is JP else dict(device="cpu")
    return (pkg.make_potential(type="NFW", mass=1e12, scaleRadius=16.0, **kw)
            + pkg.make_potential(type="MiyamotoNagai", mass=5e10,
                                 scaleRadius=3.0, scaleHeight=0.3, **kw))


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plummer", "tracer"])
def test_eddington_tables_match_jax(case):
    if case == "plummer":
        args = {pkg: (_plummer_density(1e9, 1.0),
                      pkg.PlummerPotential(mass=1e9, scaleRadius=1.0))
                for pkg in (JP, TP)}
        grid = np.geomspace(0.3, 10, 64)
    else:
        args = {pkg: (lambda b, p: (b.density, p))(*_tracer_case(pkg))
                for pkg in (JP, TP)}
        grid = np.geomspace(1e-3, 5e2, 128)
    want = jst.eddington_df(*args[JP], r_grid=grid)
    got = tst.eddington_df(*args[TP], r_grid=grid)
    # relative to each table's largest value: f(E) falls ~20 orders of
    # magnitude into the tracer's outskirts, where d2rho/dpsi2 from psi
    # ~ 0 differs at 2e-7 of its own tiny size between the packages
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())


@pytest.mark.parametrize("case", ["plummer", "tracer"])
def test_sample_quasispherical_matches_jax(case):
    out = {}
    for pkg, mod in ((JP, jst), (TP, tst)):
        if case == "plummer":
            dens = _plummer_density(1e9, 1.0)
            pot = pkg.PlummerPotential(mass=1e9, scaleRadius=1.0)
            grid, seed = np.geomspace(1e-3, 1e3, 256), 1
        else:
            bulge, pot = _tracer_case(pkg)
            dens, grid, seed = bulge.density, np.geomspace(1e-3, 5e2, 256), 11
        out[pkg] = mod.sample_quasispherical(dens, pot, 3000, seed=seed,
                                             r_grid=grid)
    _close(out[TP][0], out[JP][0])
    np.testing.assert_allclose(out[TP][1], out[JP][1], rtol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(mass=5e10, scaleHeight=-0.4, seed=2),
    dict(mass=5e10, scaleHeight=0.3, seed=5),
    dict(surfaceDensity=8e8, scaleHeight=0.3, sigma_r0=80.0, Rsigma=6.0,
         seed=4)])
def test_sample_disk_matches_jax(kw):
    want = jst.sample_disk(3000, _mw(JP), scaleRadius=3.0, **kw)
    got = tst.sample_disk(3000, _mw(TP), scaleRadius=3.0, **kw)
    _close(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)


@pytest.mark.parametrize("W0", [3.0, 7.0])
def test_king_model_matches_jax(W0):
    want = jking.KingModel(W0, 1e5, 0.01)
    got = tking.KingModel(W0, 1e5, 0.01)
    for k in ("r_grid", "rho_grid", "m_grid", "w_grid", "psi_grid",
              "phi_grid", "dphi_grid"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-12, err_msg=k)
    for k in ("r_tidal", "concentration", "sigma2"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-12)
    xv_j, m_j = jking.sample_king(3000, 1e5, 0.01, W0=W0, seed=3)
    xv_t, m_t = tking.sample_king(3000, 1e5, 0.01, W0=W0, seed=3)
    _close(xv_t, xv_j)
    np.testing.assert_array_equal(m_t, m_j)
    x = np.random.default_rng(0).normal(0, 0.05, (64, 3))
    pj = jking.make_king_potential(1e5, 0.01, W0=W0)
    pt = tking.make_king_potential(1e5, 0.01, W0=W0, device="cpu")
    _close(pt.potential(x).numpy(), np.asarray(pj.potential(x)), 1e-10)
    _close(pt.force(x).numpy(), np.asarray(pj.force(x)), 1e-10)


def test_king_through_make_potential_matches_jax():
    x = np.random.default_rng(1).normal(0, 0.05, (64, 3))
    kw = dict(type="King", mass=1e5, scaleRadius=0.01, W0=5.0)
    pj = JP.make_potential(**kw)
    pt = TP.make_potential(**kw, device="cpu")
    _close(pt.potential(x).numpy(), np.asarray(pj.potential(x)), 1e-10)
    _close(pt.force(x).numpy(), np.asarray(pj.force(x)), 1e-10)
    with pytest.warns(UserWarning, match="trunc"):
        TP.make_potential(**kw, trunc=2.0, device="cpu")


def test_king_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tking.make_king_potential(1e5, 0.01)
    pot = tking.KingModel(3.0, 1e5, 0.01).potential()
    assert pot.coefs.metadata["model"] == "King W0=3.0"


def test_samplers_take_tensors_from_the_card_or_cpu():
    """A potential whose results are tensors (possibly on the card, here a
    float32 copy) is read back to the host in float64: the radii, drawn
    from the density alone, come out the same."""
    import copy

    pot64 = TP.PlummerPotential(mass=1e9, scaleRadius=1.0)
    pot32 = copy.deepcopy(pot64).to(torch.float32)
    a = tst.sample_quasispherical(_plummer_density(1e9, 1.0), pot64, 500,
                                  seed=2)[0]
    b = tst.sample_quasispherical(_plummer_density(1e9, 1.0), pot32, 500,
                                  seed=2)[0]
    assert np.abs(a[:, :3] - b[:, :3]).max() < 1e-12 * np.abs(a).max()


# ---------------------------------------------------------------------------
# the JAX package's property tests (tests/test_df.py), mirrored
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plummer_sample():
    M, a = 1e9, 1.0
    pot = TP.PlummerPotential(mass=M, scaleRadius=a, G=G)
    xv, m = tst.sample_quasispherical(
        _plummer_density(M, a), pot, 30000, seed=1,
        r_grid=np.geomspace(1e-3, 1e3, 256))
    return xv, m, pot


def test_plummer_sigma_matches_analytic(plummer_sample):
    xv, m, _ = plummer_sample
    M, a = 1e9, 1.0
    assert np.isfinite(xv).all()
    assert m.sum() == pytest.approx(M, rel=1e-4)
    r = np.linalg.norm(xv[:, :3], axis=1)
    bins = np.geomspace(0.3, 4.0, 6)
    for lo, hi in zip(bins[:-1], bins[1:]):
        sel = (r >= lo) & (r < hi)
        vr = (xv[sel, :3] * xv[sel, 3:]).sum(1) / r[sel]
        rm = np.sqrt(lo * hi)
        assert vr.std() == pytest.approx(
            np.sqrt(G * M / (6 * np.sqrt(rm**2 + a**2))), rel=0.06)


def test_plummer_virial_ratio(plummer_sample):
    xv, m, pot = plummer_sample
    ke = 0.5 * (m * (xv[:, 3:] ** 2).sum(1)).sum()
    pe = 0.5 * (m * pot.potential(xv[:, :3]).numpy()).sum()
    assert ke / abs(pe) == pytest.approx(0.5, abs=0.02)


def test_radial_profile_matches_density():
    M, a = 5e8, 2.0
    pot = TP.PlummerPotential(mass=M, scaleRadius=a, G=G)
    xv, _ = tst.sample_quasispherical(
        _plummer_density(M, a), pot, 40000, seed=7,
        r_grid=np.geomspace(1e-3, 1e3, 256))
    r = np.linalg.norm(xv[:, :3], axis=1)
    for rq in (a, 3 * a):
        assert (r < rq).mean() == pytest.approx(
            rq**3 / (rq**2 + a**2) ** 1.5, abs=0.01)


def test_tracer_in_deeper_host_agrees_with_sigma_module():
    from nbody_streams_tpu_torch.friction import compute_sigma_r

    bulge, pot = _tracer_case(TP)
    xv, _ = tst.sample_quasispherical(bulge.density, pot, 30000, seed=11,
                                      r_grid=np.geomspace(1e-3, 5e2, 256))

    class _Tracer:
        def density(self, pts, t=0.0):
            return bulge.density(pts)

        def potential(self, pts, t=0.0):
            return pot.potential(pts)

        def force(self, pts, t=0.0):
            return pot.force(pts)

    sigma = compute_sigma_r(_Tracer(), method="quasispherical",
                            grid_r=np.geomspace(1e-3, 5e2, 200))
    r = np.linalg.norm(xv[:, :3], axis=1)
    for lo, hi in [(0.3, 0.6), (0.6, 1.2), (1.2, 2.5)]:
        sel = (r >= lo) & (r < hi)
        vr = (xv[sel, :3] * xv[sel, 3:]).sum(1) / r[sel]
        rm = np.sqrt(lo * hi)
        assert vr.std() == pytest.approx(
            float(sigma(np.array([rm]))[0]), rel=0.10)


@pytest.mark.parametrize("potential,match", [
    ("sin", None), ("log", "vanishes at infinity")])
def test_eddington_rejects_bad_potentials(potential, match):
    class _Bad:
        def potential(self, pts, t=0.0):
            return np.sin(np.linalg.norm(np.asarray(pts, float), axis=1))

    pot = (_Bad() if potential == "sin" else TP.make_potential(
        type="Logarithmic", v0=220.0, coreRadius=1.0, device="cpu"))
    grid = np.geomspace(0.1, 10, 64) if potential == "sin" else None
    with pytest.raises(ValueError, match=match):
        tst.eddington_df(_plummer_density(1e9, 1.0), pot, r_grid=grid)


@pytest.fixture(scope="module")
def mw():
    return _mw(TP)


@pytest.mark.parametrize("hz,seed,std", [
    (-0.4, 2, 0.4 * np.pi / np.sqrt(3)), (0.3, 5, 0.3 * np.sqrt(2))])
def test_vertical_structure(mw, hz, seed, std):
    xv, m = tst.sample_disk(30000, mw, mass=5e10, scaleRadius=3.0,
                            scaleHeight=hz, seed=seed)
    assert xv[:, 2].std() == pytest.approx(std, rel=0.03)
    assert m.sum() == pytest.approx(5e10, rel=1e-3)
    if hz > 0:
        assert np.abs(np.median(xv[:, 2])) < 0.02


def test_rotation_support_and_drift(mw):
    xv, _ = tst.sample_disk(30000, mw, mass=5e10, scaleRadius=3.0,
                            scaleHeight=-0.4, seed=2)
    R = np.hypot(xv[:, 0], xv[:, 1])
    vphi = (xv[:, 0] * xv[:, 4] - xv[:, 1] * xv[:, 3]) / R
    for Rl, Rh in [(4, 5), (7, 9), (11, 14)]:
        sel = (R >= Rl) & (R < Rh)
        Rm = np.sqrt(Rl * Rh)
        f = mw.force(np.array([[Rm, 0.0, 0.0]])).numpy()
        vc = np.sqrt(-Rm * f[0, 0])
        lag = vc - vphi[sel].mean()
        assert 0.0 < lag < 0.25 * vc
        assert vphi[sel].std() < 0.35 * vc


def test_radial_profile(mw):
    xv, _ = tst.sample_disk(50000, mw, mass=5e10, scaleRadius=3.0,
                            scaleHeight=-0.4, seed=9)
    R = np.hypot(xv[:, 0], xv[:, 1])
    for rq in (3.0, 6.0, 12.0):
        x = rq / 3.0
        assert (R < rq).mean() == pytest.approx(1.0 - (1.0 + x) * np.exp(-x),
                                                abs=0.015)


def test_explicit_sigma_r0(mw):
    xv, _ = tst.sample_disk(20000, mw, mass=5e10, scaleRadius=3.0,
                            scaleHeight=-0.4, sigma_r0=80.0, Rsigma=6.0,
                            seed=4)
    R = np.hypot(xv[:, 0], xv[:, 1])
    vR = (xv[:, 0] * xv[:, 3] + xv[:, 1] * xv[:, 4]) / R
    sel = (R > 5.5) & (R < 6.5)
    assert vR[sel].std() == pytest.approx(80.0 * np.exp(-1.0), rel=0.08)


def test_sample_disk_surface_density_wins_and_zero_height_raises():
    halo = TP.make_potential(type="NFW", mass=1e12, scaleRadius=16.0,
                             device="cpu")
    sigma0, Rd = 800.0 * 1e6, 3.0
    _, m_both = tst.sample_disk(2000, halo, surfaceDensity=sigma0, mass=5e10,
                                scaleRadius=Rd, scaleHeight=0.3, seed=1)
    assert m_both.sum() == pytest.approx(2.0 * np.pi * sigma0 * Rd**2,
                                         rel=0.01)
    _, m_only = tst.sample_disk(2000, halo, surfaceDensity=sigma0,
                                scaleRadius=Rd, scaleHeight=0.3, seed=1)
    np.testing.assert_allclose(m_both, m_only)
    with pytest.raises(ValueError, match="scaleHeight"):
        tst.sample_disk(100, halo, mass=5e9, scaleHeight=0.0)


def test_eddington_truncated_grid_no_extrapolation_bias():
    M, a = 1e9, 1.0
    pot = TP.PlummerPotential(mass=M, scaleRadius=a)
    e, f, r, psi = tst.eddington_df(_plummer_density(M, a), pot,
                                    r_grid=np.geomspace(0.3, 10, 64))
    f_an = (24 * np.sqrt(2) / (7 * np.pi**3) * a**2 / (G**5 * M**4)
            * e**3.5)
    sel = (f > 0) & (r[::-1] <= 10.0)
    np.testing.assert_allclose(f[sel], f_an[sel], rtol=5e-3)


def test_quasispherical_short_nbody_stays_in_equilibrium(tmp_path):
    M, a = 1e9, 1.0
    pot = TP.PlummerPotential(mass=M, scaleRadius=a, G=G)
    xv, m = tst.sample_quasispherical(
        _plummer_density(M, a), pot, 2000, seed=13,
        r_grid=np.geomspace(1e-3, 1e3, 200))
    sp = tst.Species(name="star", N=2000, mass=float(m[0]), softening=0.05)
    r0 = np.median(np.linalg.norm(xv[:, :3], axis=1))
    t_dyn = np.sqrt(a**3 / (G * M))
    out = tst.run_simulation(xv, [sp], 0.0, 0.25 * t_dyn, dt=0.005 * t_dyn,
                             architecture="cpu", save_snapshots=False,
                             verbose=False, output_dir=str(tmp_path))
    r1 = np.median(np.linalg.norm(out["star"][:, :3], axis=1))
    assert r1 == pytest.approx(r0, rel=0.08)
