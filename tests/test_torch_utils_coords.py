"""The port's analysis toolkit (utils/main.py) and coordinate frames
(coords/) against the JAX package's, on the CPU.

Both are the JAX package's numpy/scipy code, so every profile, fit,
grid, centre finder and transform is held to the JAX package's output on
the same inputs exactly (rtol 1e-12 where scipy optimisers iterate),
and the property tests of tests/test_utils_coords_viz.py (viz left out)
and tests/test_compat.py's reference call forms are mirrored at N <=
4,096.  Unbinding's self-potential is the port's own: the direct forms
run the CUDA kernel's potential form (on the CPU its plain version) and
the 'bfe' forms the port's Multipole.  Both call forms agree with the
JAX package's bound masks exactly in float64, and in float32 + Kahan
except where |E| is within 1e-5 of |phi| (the two packages' float32
potentials differ by ~1e-7 relative).
"""
import warnings

import numpy as np
import pytest
import torch

import nbody_streams_tpu.coords as JC
import nbody_streams_tpu.utils as JU
import nbody_streams_tpu_torch.coords as TC
import nbody_streams_tpu_torch.utils as TU
from nbody_streams_tpu_torch import G_DEFAULT, make_plummer_sphere

torch.set_num_threads(2)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def plummer():
    return make_plummer_sphere(4096, M_total=1e8, a=0.5, seed=7)


def _same(got, want, rtol=0.0):
    """Nested outputs equal (NaN where NaN), to ``rtol``."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], rtol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rtol)
    elif callable(want):
        return
    else:
        np.testing.assert_allclose(np.asarray(got, float),
                                   np.asarray(want, float), rtol=rtol,
                                   atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# the numpy toolkit: the JAX package's output on the same input
# ---------------------------------------------------------------------------

def _toolkit_cases(xv, m):
    pos, vel = xv[:, :3], xv[:, 3:]
    rng = np.random.default_rng(3)
    blob = rng.normal(size=(3000, 3)) * np.array([1.0, 0.6, 0.3])
    r, rho, _ = JU.empirical_density_profile(pos, m, bins=20, r_min=0.05,
                                             r_max=5.0)
    return {
        "density": ("empirical_density_profile", (pos, m),
                    dict(bins=20, r_min=0.05, r_max=5.0)),
        "density_ref": ("empirical_density_profile", (pos, m),
                        dict(nbins=20, rmin=0.1, rmax=5.0)),
        "vcirc": ("empirical_circular_velocity_profile", (pos, m),
                  dict(bins=15, r_min=0.1, r_max=5.0)),
        "dispersion": ("empirical_velocity_dispersion_profile", (pos, vel),
                       dict(bins=10, r_min=0.1, r_max=3.0)),
        "rms": ("empirical_velocity_rms_profile", (pos, vel),
                dict(nbins=10, rmin=0.1, rmax=3.0)),
        "anisotropy": ("empirical_velocity_anisotropy_profile", (pos, vel),
                       dict(bins=10, r_min=0.1, r_max=3.0)),
        "fit_plummer": ("fit_plummer_profile", (r[rho > 0], rho[rho > 0]),
                        {}),
        "fit_plummer_particles": ("fit_plummer_profile", (pos, m),
                                  dict(bins=20)),
        "fit_dehnen": ("fit_dehnen_profile", (r[rho > 0], rho[rho > 0]),
                       {}),
        "ellipsoid": ("fit_iterative_ellipsoid", (blob,),
                      dict(reduced=False, r_max=3.0)),
        "ellipsoid_ref": ("fit_iterative_ellipsoid", (blob,),
                          dict(Rmax=3.0, reduced_structure=False,
                               orient_with_momentum=False)),
        "shrinking_sphere": ("find_center", (pos + 1.0, m),
                             dict(method="shrinking_sphere")),
        "kde": ("find_center", (pos[:1000], m[:1000]),
                dict(method="kde")),
        "uneven_grid": ("make_uneven_grid", (0.1, 100.0, 20), {}),
        "fibonacci": ("fibonacci_sphere_grid", (200,),
                      dict(radius=2.0, proj="sph")),
        "uniform_sphere": ("uniform_spherical_grid", (100,),
                           dict(radius=1.5, seed=3)),
    }


CASES = sorted(_toolkit_cases(*make_plummer_sphere(64, 1.0, 1.0)))


@pytest.mark.parametrize("name", CASES)
def test_toolkit_matches_jax(plummer, name):
    fn, args, kw = _toolkit_cases(*plummer)[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(JU, fn)(*args, **kw)
        got = getattr(TU, fn)(*args, **kw)
    _same(got, want, rtol=1e-12)


def test_toolkit_physics(plummer):
    """The JAX package's property checks, on the port at N = 4,096."""
    xv, m = plummer
    r, rho, counts = TU.empirical_density_profile(xv[:, :3], m, bins=15,
                                                  r_min=0.05, r_max=5.0)
    expected = 3e8 / (4 * np.pi * 0.5**3) * (1 + (r / 0.5) ** 2) ** -2.5
    sel = counts > 200
    assert sel.sum() >= 5
    np.testing.assert_allclose(rho[sel], expected[sel], rtol=0.25)
    r, vc = TU.empirical_circular_velocity_profile(
        xv[:, :3], m, bins=12, r_min=0.2, r_max=5.0)
    np.testing.assert_allclose(
        vc, np.sqrt(G_DEFAULT * 1e8 * r**2 / (r**2 + 0.25) ** 1.5),
        rtol=0.1)
    _, beta = TU.empirical_velocity_anisotropy_profile(
        xv[:, :3], xv[:, 3:], bins=8, r_min=0.1, r_max=3.0)
    assert np.abs(np.nanmedian(beta)) < 0.15
    g = TU.make_uneven_grid(0.1, 100.0, 20)
    assert g[0] == 0.0 and g[-1] == pytest.approx(100.0, rel=1e-9)
    pts = TU.fibonacci_sphere_grid(500)
    np.testing.assert_allclose(np.linalg.norm(pts, axis=1), 1.0,
                               rtol=1e-12)
    res = TU.fit_iterative_ellipsoid(np.random.default_rng(5).normal(
        size=(500, 3)), n_iter=0)
    assert res["iterations"] == 0 and not res["converged"]
    with pytest.raises(ValueError, match="selects no particles"):
        TU.find_center(xv[:, :3] + 5.0, vel=xv[:, 3:], mass=m,
                       method="shrinking_sphere", vel_aperture=1e-12)
    with pytest.warns(DeprecationWarning):
        c = TU.find_center_position(xv[:, :3], m, "shrinking_sphere")
    np.testing.assert_array_equal(
        c, TU.find_center(xv[:, :3], m, method="shrinking_sphere"))


@pytest.mark.parametrize("solver", ["direct", "bfe"])
def test_find_center_density_peak_matches_jax(plummer, solver):
    xv, m = plummer
    shift = np.array([5.0, -2.0, 1.0])
    got = TU.find_center(xv[:, :3] + shift, mass=m, method="density_peak",
                         potential_solver=solver, **CPU)
    want = JU.find_center(xv[:, :3] + shift, mass=m, method="density_peak",
                          potential_solver=solver)
    assert np.linalg.norm(got - shift) < 0.2
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# unbinding, both call forms
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def contaminated(plummer):
    """The Plummer sphere with 10% fast interlopers (seeded)."""
    xv, m = plummer
    rng = np.random.default_rng(0)
    n_out = 400
    pos = np.vstack([xv[:, :3], rng.normal(0, 2.0, (n_out, 3))])
    vel = np.vstack([xv[:, 3:], rng.normal(0, 500.0, (n_out, 3))])
    return pos, vel, np.concatenate([m, np.full(n_out, m[0])]), n_out


def _energy(pos, vel, mass, softening, v0):
    from tests.numpy_oracle import oracle_potential

    phi = oracle_potential(pos, mass, np.full(len(mass), softening),
                           G_DEFAULT, kind="plummer")
    return phi, phi + 0.5 * ((vel - v0) ** 2).sum(1)


@pytest.mark.parametrize("precision", ["float64", "float32_kahan"])
def test_iterative_unbinding_matches_jax(contaminated, precision):
    pos, vel, mass, n_out = contaminated
    kw = dict(solver="direct", softening=0.01, precision=precision)
    got, info = TU.iterative_unbinding(pos, vel, mass, **kw, **CPU)
    want, jinfo = JU.iterative_unbinding(pos, vel, mass, **kw)
    assert got.dtype == bool and got[-n_out:].mean() < 0.05
    assert got[:-n_out].mean() > 0.8
    if precision == "float64":
        np.testing.assert_array_equal(got, want)
        assert info == jinfo
    else:
        v0 = (vel[got] * mass[got, None]).sum(0) / mass[got].sum()
        phi, e = _energy(pos[got], vel[got], mass[got], 0.01, v0)
        differ = got != want
        assert differ.sum() <= 2
        assert (np.abs(e[differ[got]]) < 1e-5 * np.abs(phi[differ[got]])
                ).all()


def test_iterative_unbinding_bfe_matches_jax(contaminated):
    pos, vel, mass, n_out = contaminated
    got, info = TU.iterative_unbinding(pos, vel, mass, solver="bfe", **CPU)
    want, jinfo = JU.iterative_unbinding(pos, vel, mass, solver="bfe")
    np.testing.assert_array_equal(got, want)
    assert info == jinfo and got[-n_out:].mean() < 0.05


@pytest.mark.parametrize("method", ["direct", "tree", "bfe"])
def test_unbinding_reference_form_matches_jax(contaminated, method):
    """The reference contract: int masks, the centre found from the
    lowest-phi particles, 'tree' the exact direct sum."""
    pos, vel, mass, n_out = contaminated
    kw = dict(potential_compute_method=method, softening=0.01,
              verbose=False, precision="float64", theta=0.4)
    if method == "bfe":
        kw.update(lmax=2)
        del kw["precision"]
    (got,), cp, cv = TU.iterative_unbinding(pos, vel, mass, **kw, **CPU)
    (want,), jcp, jcv = JU.iterative_unbinding(pos, vel, mass, **kw)
    assert got.dtype != bool and set(np.unique(got)) <= {0, 1}
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(cp, jcp, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(cv, jcv, rtol=1e-12, atol=1e-14)
    assert got[-n_out:].mean() < 0.05 and np.all(np.abs(cp) < 0.5)


def test_unbinding_reference_two_species_history_and_aliases(contaminated):
    pos, vel, mass, n_out = contaminated
    kw = dict(potential_compute_method="direct", softening=0.01,
              verbose=False, return_history=True, precision="float64")
    sp = dict(pos_star=pos[-n_out:], vel_star=vel[-n_out:],
              mass_star=mass[-n_out:])
    got, cp, _ = TU.iterative_unbinding(pos[:-n_out], vel[:-n_out],
                                        mass[:-n_out], **sp, **kw, **CPU)
    want, jcp, _ = JU.iterative_unbinding(pos[:-n_out], vel[:-n_out],
                                          mass[:-n_out], **sp, **kw)
    bound_dark, bound_star, hist_d, hist_s = got
    for g, w in zip((bound_dark, bound_star), want[:2]):
        np.testing.assert_array_equal(g, w)
    assert len(hist_d) == len(hist_s) == len(want[2]) >= 1
    assert hist_d[0].dtype == bool and bound_star.mean() < 0.05
    np.testing.assert_allclose(cp, jcp, rtol=1e-12, atol=1e-14)
    with pytest.warns(DeprecationWarning):
        res, _, _ = TU.compute_iterative_boundness(
            pos, vel, mass, potential_compute_method="direct",
            softening=0.01, verbose=False, **CPU)
    assert res[0][-n_out:].mean() < 0.05
    with pytest.raises(ValueError, match="potential_compute_method"):
        TU.iterative_unbinding(pos, vel, mass,
                               potential_compute_method="fmm", **CPU)


def test_self_potential_is_the_kernels_plain_version(plummer):
    """'direct' unbinding reads DirectGravity's potential (the CUDA
    kernel's single-pass potential form; on the CPU its plain version),
    within 2e-6 of the fp64 oracle."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.utils.main import _self_potential
    from tests.numpy_oracle import oracle_potential

    xv, m = plummer
    before = cd.LAUNCHES["single"]
    phi = _self_potential(xv[:, :3], m, softening=0.01, **CPU)
    # the CPU tensor runs the plain version, which counts no launch
    assert cd.LAUNCHES["single"] == before
    want = oracle_potential(xv[:, :3], m, np.full(len(m), 0.01), G_DEFAULT,
                            kind="plummer")
    assert np.abs(phi - want).max() / np.abs(want).max() < 2e-6


# ---------------------------------------------------------------------------
# coords
# ---------------------------------------------------------------------------

def _coords_cases():
    rng = np.random.default_rng(9)
    pts = rng.normal(0, 10, (100, 3))
    vec = rng.normal(0, 50, (100, 3))
    ang = np.linspace(-0.3, 0.3, 30)
    pos = 20.0 * np.column_stack([np.cos(ang), np.sin(ang), 0.1 * ang])
    vel = 100.0 * np.column_stack([-np.sin(ang), np.cos(ang),
                                   0.05 * np.ones_like(ang)])
    xv = np.hstack([pos, vel])
    batch = rng.normal(size=(2, 5, 3))
    return {
        "cart_sph": ("convert_coords", (pts, "cart", "sph"), {}),
        "cart_cyl": ("convert_coords", (pts, "cart", "cyl"), {}),
        "sph_cyl": ("convert_coords",
                    (JC.convert_coords(pts, "cart", "sph"), "sph", "cyl"),
                    {}),
        "batched": ("convert_coords", (batch, "cart", "sph"), {}),
        "vectors_ref": ("convert_vectors", (pts, vec, "cart", "sph"), {}),
        "vectors_kw": ("convert_vectors", (),
                       dict(vectors=vec, positions=pts, from_sys="cart",
                            to_sys="cyl")),
        "vel_los": ("convert_to_vel_los", (pts, vec), {}),
        "stream": ("generate_stream_coords", (xv, xv[15]),
                   dict(return_rotation=True)),
        "to_stream": ("to_stream_coords", (xv, np.eye(3)),
                      dict(return_proper_motions=True)),
        "observed": ("get_observed_stream_coords", (xv, xv[15]),
                     dict(observer=[-8.2, 0.0, 0.02, 11.0, 245.0, 7.0])),
        "observed_ref": ("get_observed_stream_coords", (xv, xv[15]),
                         dict(galcen_distance=8.122, z_sun=0.0208)),
    }


@pytest.mark.parametrize("name", sorted(_coords_cases()))
def test_coords_match_jax(name):
    fn, args, kw = _coords_cases()[name]
    _same(getattr(TC, fn)(*args, **kw), getattr(JC, fn)(*args, **kw))


def test_coords_properties():
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 10, (100, 3))
    for sys in ("sph", "cyl"):
        out = TC.convert_coords(TC.convert_coords(pts, "cart", sys), sys,
                                "cart")
        np.testing.assert_allclose(out, pts, atol=1e-10)
    out = TC.convert_coords(np.array([[1.0, 2.0, 3.0], [np.nan, 1, 1]]),
                            "cart", "sph")
    assert np.isfinite(out[0]).all() and np.isnan(out[1]).all()
    r = np.linalg.norm(pts, axis=1, keepdims=True)
    v_sph = TC.convert_vectors(vectors=42.0 * pts / r, positions=pts,
                               from_sys="cart", to_sys="sph")
    np.testing.assert_allclose(v_sph[:, 0], 42.0, atol=1e-10)
    np.testing.assert_allclose(v_sph[:, 1:], 0.0, atol=1e-10)
    assert TC.convert_to_vel_los(np.array([[10.0, 0, 0]]),
                                 np.array([[-30.0, 40.0, 0]]))[0] \
        == pytest.approx(-30.0)
    ang = np.linspace(-0.5, 0.5, 50)
    xv = np.hstack([20.0 * np.column_stack([np.cos(ang), np.sin(ang),
                                            0 * ang]),
                    100.0 * np.column_stack([-np.sin(ang), np.cos(ang),
                                             0 * ang])])
    phi1, phi2, rot = TC.generate_stream_coords(xv, xv[25],
                                                return_rotation=True)
    np.testing.assert_allclose(phi2, 0.0, atol=1e-8)
    assert phi1.max() - phi1.min() > 50.0
    nan_rows = xv.copy()
    nan_rows[30:] = np.nan
    p1b, _ = TC.generate_stream_coords(nan_rows)
    assert np.isnan(p1b[30:]).all()
    with pytest.raises(ValueError, match="no finite particle rows"):
        TC.generate_stream_coords(np.full((5, 6), np.nan))
    with pytest.raises(TypeError, match="not both"):
        TC.convert_coords(pts, "cart", "sph", data=pts)
