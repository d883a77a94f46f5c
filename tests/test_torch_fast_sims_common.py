"""The port's Jacobi radius, spray IC generators and shared fast_sims
builders (fast_sims/spray.py's tidal tensor and ICs, fast_sims/_common.py)
against the JAX package's, on the CPU.

The same numpy inputs and seeds go through both packages in float64 (the
JAX side under tests/conftest.py's ``jax_enable_x64``, the port with
``dtype=torch.float64, device='cpu'``).  Tolerances, max |port - JAX| /
max |JAX|: Jacobi radii and rotations 1e-10; IC generators equal (the
same numpy streams); potentials of the builders 1e-12 (the windowed
perturber, whose orbit is integrated, 1e-10); the DF acceleration and
an orbit under it 1e-10.  The spray and restricted runs are held by
tests/test_torch_fast_sims.py.
"""
import numpy as np
import pytest
import torch

import nbody_streams_tpu.fast_sims as J
import nbody_streams_tpu.potentials as JP
import nbody_streams_tpu_torch.fast_sims as T
import nbody_streams_tpu_torch.potentials as TP
from nbody_streams_tpu.fast_sims import _common as jcom
from nbody_streams_tpu_torch.constants import G_DEFAULT
from nbody_streams_tpu_torch.fast_sims import _common as tcom

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _close_xv(got, want, tol):
    for sl in (slice(0, 3), slice(3, 6)):
        assert _rel(np.asarray(got)[..., sl],
                    np.asarray(want)[..., sl]) < tol


@pytest.fixture(scope="module")
def hosts():
    return (JP.NFWPotential(mass=1e12, scaleRadius=20.0),
            TP.NFWPotential(mass=1e12, scaleRadius=20.0))


# ---------------------------------------------------------------------------
# Jacobi radius and the IC generators
# ---------------------------------------------------------------------------

def _orbit_points(n=16, seed=5):
    rng = np.random.default_rng(seed)
    return np.hstack([rng.normal(0, 30.0, (n, 3)),
                      rng.normal(0, 120.0, (n, 3))])


@pytest.mark.parametrize("eig", [True, False])
def test_jacobi_radius_matches_jax(eig):
    """Scalar t and per-point t agree with the JAX package's scalar branch
    and its vmapped branch, on a static host and on an evolving one (the
    host carried along a trajectory: the port groups the points by time,
    one batched Hessian a group)."""
    orb = _orbit_points()
    jpot = JP.NFWPotential(mass=1e12, scaleRadius=16.0)
    tpot = TP.NFWPotential(mass=1e12, scaleRadius=16.0)
    t_pts = np.repeat(np.linspace(-1.0, 0.0, 4), 4)
    track = (np.linspace(-1.0, 0.0, 8),
             np.column_stack([np.linspace(0, 3, 8)] * 3 + [np.full(8, 3.0)]
                             * 3))
    jmov = jcom.moving_potential(jpot, *track)
    tmov = tcom.moving_potential(tpot, *track)
    for jp, tp, t in ((jpot, tpot, 0.0), (jpot, tpot, np.zeros(16)),
                      (jmov, tmov, t_pts)):
        want = J.get_jacobi_radius(jp, orb, 1e8, t=t, eigenvalue_method=eig)
        got = T.get_jacobi_radius(tp, orb, 1e8, t=t, eigenvalue_method=eig,
                                  dtype=torch.float64)
        for g, w in zip(got, want):
            assert _rel(g, w) < 1e-10


def test_jacobi_radius_kepler_closed_form():
    """Circular orbit about a point-mass-like host: r_J^3 = m r^3 / (3 M),
    through the scalar and the per-point t branches."""
    M, R = 1e12, 120.0
    pot = TP.PlummerPotential(mass=M, scaleRadius=0.01)
    vc = np.sqrt(G_DEFAULT * M / R)
    orb = np.array([[R, 0, 0, 0, vc, 0]])
    for t in (0.0, np.array([0.0])):
        rj, _, rot = T.get_jacobi_radius(pot, orb, 1e8, t=t,
                                         dtype=torch.float64)
        np.testing.assert_allclose(rj[0], R * (1e8 / (3.0 * M)) ** (1 / 3),
                                   rtol=1e-3)
        np.testing.assert_allclose(rot[0] @ rot[0].T, np.eye(3), atol=1e-12)


def test_ic_generators_match_jax_and_take_R():
    orbit = _orbit_points(8, 3)
    rj = np.full(8, 2.0)
    vj = np.full(8, 5.0)
    rots = np.tile(np.eye(3), (8, 1, 1))
    a = T.create_ic_particle_spray_chen2025(orbit, 1e9, rj, rots, seed=1)
    np.testing.assert_array_equal(a, J.create_ic_particle_spray_chen2025(
        orbit, 1e9, rj, rots, seed=1))
    np.testing.assert_array_equal(a, T.create_ic_particle_spray_chen2025(
        orbit, 1e9, rj, R=rots, G=None, seed=1))
    c = T.create_ic_particle_spray_fardal2015(orbit, rj, vj, rots, seed=2)
    np.testing.assert_array_equal(c, J.create_ic_particle_spray_fardal2015(
        orbit, rj, vj, rots, seed=2))
    with pytest.raises(TypeError, match="not both"):
        T.create_ic_particle_spray_fardal2015(orbit, rj, vj, rots, R=rots)


# ---------------------------------------------------------------------------
# The shared builders
# ---------------------------------------------------------------------------

def test_spherical_refit_matches_jax_and_plummer():
    from nbody_streams_tpu_torch import make_plummer_sphere

    xv, m = make_plummer_sphere(4096, M_total=1e8, a=0.5, seed=3)
    pot = T.spherical_potential_from_particles(xv[:, :3], m, device="cpu")
    jpot = J.spherical_potential_from_particles(xv[:, :3], m)
    pts = np.array([[1.0, 0, 0], [0, 3.0, 0], [0, 0, 10.0], [0.1, 0.2, 0]])
    got = pot.potential(pts).numpy()
    assert _rel(got, np.asarray(jpot.potential(pts))) < 1e-12
    np.testing.assert_allclose(
        got[:3], TP.PlummerPotential(mass=1e8, scaleRadius=0.5)
        .potential(pts[:3]).numpy(), rtol=0.05)


@pytest.mark.parametrize("kind", ["Plummer", "Plummer_withRcut", "King"])
def test_progenitor_potentials_and_samples_match_jax(kind):
    pts = np.array([[0.05, 0, 0], [0.3, 0.2, 0.1], [2.0, 0, 1.0]])
    tp = T.make_progenitor_potential(kind, 1e7, 0.3, W0=4.0, device="cpu")
    jp = J.make_progenitor_potential(kind, 1e7, 0.3, W0=4.0)
    for f in ("potential", "force"):
        assert _rel(getattr(tp, f)(pts).numpy(),
                    np.asarray(getattr(jp, f)(pts))) < 1e-12
    for a, b in zip(T.sample_progenitor(kind, 64, 1e7, 0.3, seed=4, W0=4.0),
                    J.sample_progenitor(kind, 64, 1e7, 0.3, seed=4, W0=4.0)):
        np.testing.assert_array_equal(a, b)


def test_perturber_and_dissolving_schedule_match_jax(hosts):
    """The windowed perturber (on, ramping, off; a window closed before
    the run; one open past the end) and the dissolving schedule follow the
    JAX package's at every time, amplitude bounded by [0, 1]."""
    jh, th = hosts
    x = np.array([[10.0, 0.0, 0.0], [60.0, 5.0, 0.0]])
    w = np.array([30.0, 0, 0, 0, 150.0, 0])
    for spec, t0, t1 in (
            ({"time_window": 0.5, "time_impact": -2.0}, -4.0, 0.0),
            ({"time_window": 2.0, "time_impact": -5.0}, 0.0, 3.0),
            ({"time_window": 200.0, "time_impact": 0.5}, 0.0, 1.0)):
        spec = {"mass": 5e10, "scaleRadius": 5.0, "w_subhalo_impact": w,
                **spec}
        tp = tcom.make_perturber_potential(spec, th, t0, t1, n_steps=256,
                                           **F64)
        jp = jcom.make_perturber_potential(spec, jh, t0, t1, n_steps=256)
        for t in np.linspace(t0 - 0.5, t1 + 0.5, 9):
            assert _rel(tp.potential(x, t=t).numpy(),
                        np.asarray(jp.potential(x, t=t))) < 1e-10
    base = TP.PlummerPotential(mass=1e9, scaleRadius=1.0)
    tdis = tcom.dissolving_schedule(base, -1.0, 0.0)
    jdis = jcom.dissolving_schedule(
        JP.PlummerPotential(mass=1e9, scaleRadius=1.0), -1.0, 0.0)
    for t in (-1.5, -0.6, -0.1, 0.5):
        assert _rel(tdis.potential(x, t=t).numpy(),
                    np.asarray(jdis.potential(x, t=t))) < 1e-12


def test_df_accel_matches_jax(hosts):
    """make_df_accel on the progenitor orbit, a single state and a batch,
    float64 (friction.chandrasekhar_accel and the Jeans sigma are held
    by tests/test_torch_friction.py)."""
    import jax

    jh, th = hosts
    xv = np.array([[25.0, 3.0, -2.0, 40.0, 150.0, -30.0],
                   [8.0, 0.0, 1.0, -60.0, 200.0, 10.0]])
    ja = jcom.make_df_accel(jh, 1e10)
    ta = tcom.make_df_accel(th, 1e10)
    got = ta(torch.tensor(xv), 0.0).numpy()
    assert _rel(got, np.asarray(jax.jit(ja)(xv, 0.0))) < 1e-10
    _, back_j = J.integrate_orbit(jh, xv[0], 0.0, -0.5, n_steps=20,
                                  extra_accel=ja)
    _, back_t = T.integrate_orbit(th, xv[0], 0.0, -0.5, n_steps=20,
                                  extra_accel=ta, **F64)
    _close_xv(back_t, back_j, 1e-10)
