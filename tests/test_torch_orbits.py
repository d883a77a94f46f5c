"""The port's orbit integrators (fast_sims/orbits.py) against the JAX
package's, on the CPU.

The same numpy inputs go through both packages in float64 (the JAX side
under tests/conftest.py's ``jax_enable_x64``, the port with
``dtype=torch.float64, device='cpu'``).  Tolerances, max |port - JAX| /
max |JAX| of positions and of velocities: RK4 and DP5(4) trajectories and
released ensembles 1e-12 (the same arithmetic; the DP5(4) step control
takes the same accept/reject path).  The JAX package's property tests of
the integrators (tests/test_fast_sims.py) are mirrored on the port: the
cusp round trip, the NaN-poisoning, the interval clip, the release
freeze forward and backward and the in-loop decimation.
"""
import numpy as np
import pytest
import torch

import nbody_streams_tpu.fast_sims as J
import nbody_streams_tpu.potentials as JP
import nbody_streams_tpu_torch.fast_sims as T
import nbody_streams_tpu_torch.potentials as TP
from nbody_streams_tpu.fast_sims import orbits as jorb
from nbody_streams_tpu_torch.fast_sims import orbits as torb

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


def circular_state(host, r):
    vc = np.sqrt(-r * host.force(np.array([r, 0.0, 0.0])).numpy()[0])
    return np.array([r, 0, 0, 0, vc, 0]), vc


# ---------------------------------------------------------------------------
# Fixed-step RK4 and the released ensemble
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t0,t1", [(0.0, 1.0), (1.0, -0.5)])
def test_integrate_orbit_matches_jax(hosts, t0, t1):
    jh, th = hosts
    xv0 = np.array([[25.0, 0, 0, 30.0, 180.0, 10.0],
                    [8.0, 3.0, -2.0, -50.0, 120.0, 60.0]])
    tj, a = J.integrate_orbit(jh, xv0, t0, t1, n_steps=300)
    tt, b = T.integrate_orbit(th, xv0, t0, t1, n_steps=300, **F64)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-15)
    assert b.shape == (301, 2, 6) and b.dtype == np.float64
    _close_xv(b, a, 1e-12)


def test_circular_orbit_stays_circular(hosts):
    th = hosts[1]
    xv0, vc = circular_state(th, 30.0)
    period = 2 * np.pi * 30.0 / vc
    _, traj = T.integrate_orbit(th, xv0, 0.0, period, n_steps=1000, **F64)
    r = np.linalg.norm(traj[:, :3], axis=1)
    np.testing.assert_allclose(r, 30.0, rtol=1e-5)
    np.testing.assert_allclose(traj[-1], xv0, atol=0.05)


def test_rewind_forward_roundtrip(hosts):
    th = hosts[1]
    xv0, _ = circular_state(th, 25.0)
    xv0[3] += 30.0  # eccentric
    _, back = T.integrate_orbit(th, xv0, 1.0, 0.0, n_steps=500, **F64)
    _, fwd = T.integrate_orbit(th, back[-1], 0.0, 1.0, n_steps=500, **F64)
    np.testing.assert_allclose(fwd[-1], xv0, atol=1e-4)


def test_energy_conservation_orbit(hosts):
    th = hosts[1]
    xv0, _ = circular_state(th, 15.0)
    xv0[3] += 80.0
    _, traj = T.integrate_orbit(th, xv0, 0.0, 2.0, n_steps=1000, **F64)
    phi = th.potential(traj[:, :3]).numpy()
    e = phi + 0.5 * (traj[:, 3:] ** 2).sum(1)
    assert abs(e[-1] - e[0]) / abs(e[0]) < 1e-8


@pytest.mark.parametrize("t0,t1,t_rel,further", [
    (0.0, 1.0, [0.0, 0.25, 0.5, 1.01], 2),    # last never releases
    (1.0, 0.0, [1.0, 0.5, -0.01], 1),         # backward run
])
def test_released_ensemble_matches_jax_and_freezes(hosts, t0, t1, t_rel,
                                                   further):
    """Particles hold their IC until the clock passes their release time,
    in the integration's direction; an earlier release (in run time)
    carries a particle further along the orbit."""
    jh, th = hosts
    xv0, _ = circular_state(th, 30.0)
    ics = np.tile(xv0, (len(t_rel), 1))
    t_rel = np.array(t_rel)
    _, a = J.integrate_orbits_released(jh, ics, t_rel, t0, t1, 1000)
    _, b = T.integrate_orbits_released(th, ics, t_rel, t0, t1, 1000, **F64)
    _close_xv(b, a, 1e-12)
    assert np.abs(b[0] - xv0).max() > 1.0
    np.testing.assert_array_equal(b[-1], xv0)
    assert np.abs(b[0, 1] - xv0[1]) > np.abs(b[further, 1] - xv0[1])


def test_released_save_every_matches_jax_and_full_trajectory(hosts):
    """In-loop decimation reproduces the dense trajectory's snapshots,
    including a non-divisible tail, and the JAX package's."""
    jh, th = hosts
    rng = np.random.default_rng(2)
    ics = rng.normal(size=(16, 6)) * np.array([20, 20, 20, 80, 80, 80.])
    t_rel = rng.uniform(0.0, 0.5, 16)
    n_steps = 50
    td, full = T.integrate_orbits_released(th, ics, t_rel, 0.0, 1.0,
                                           n_steps, save_every=1, **F64)
    for k in (7, 10, 50, 64):
        ts, traj = T.integrate_orbits_released(th, ics, t_rel, 0.0, 1.0,
                                               n_steps, save_every=k, **F64)
        sel = np.arange(0, n_steps + 1, k)
        if sel[-1] != n_steps:
            sel = np.append(sel, n_steps)
        np.testing.assert_array_equal(ts, td[sel])
        np.testing.assert_array_equal(traj, full[sel])
        tj, jt = J.integrate_orbits_released(jh, ics, t_rel, 0.0, 1.0,
                                             n_steps, save_every=k)
        np.testing.assert_allclose(ts, tj, rtol=0, atol=1e-15)
        _close_xv(traj, jt, 1e-12)


# ---------------------------------------------------------------------------
# DP5(4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t1", [4.0, -3.0])
def test_adaptive_matches_jax(hosts, t1):
    jh, th = hosts
    xv0 = np.array([[30.0, 0.0, 10.0, 0.0, 150.0, 30.0],
                    [12.0, -4.0, 2.0, 80.0, 60.0, -20.0]])
    kw = dict(n_out=64, rtol=1e-10, atol=1e-10)
    tj, a = jorb.integrate_orbit_adaptive(jh, xv0, 0.0, t1, **kw)
    tt, b = torb.integrate_orbit_adaptive(th, xv0, 0.0, t1, **kw, **F64)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-15)
    _close_xv(b, a, 1e-12)


def test_adaptive_orbit_cusp_round_trip():
    """DP5(4) round-trips a cusp-plunging orbit in a Dehnen gamma = 1.5
    potential to ~1e-7, where fixed-step RK4 at comparable output
    resolution fails by orders of magnitude."""
    pot = TP.DehnenPotential(mass=1e11, scaleRadius=5.0, gamma=1.5)
    xv0 = np.array([8.0, 0.0, 0.0, 5.0, 12.0, 3.0])
    kw = dict(n_out=128, rtol=1e-11, atol=1e-10, **F64)
    _, back = torb.integrate_orbit_adaptive(pot, xv0, 0.0, -3.0, **kw)
    _, fwd = torb.integrate_orbit_adaptive(pot, back[-1], -3.0, 0.0, **kw)
    rel = np.abs(fwd[-1] - xv0).max() / np.abs(xv0).max()
    assert rel < 1e-7
    _, b2 = T.integrate_orbit(pot, xv0, 0.0, -3.0, n_steps=2048, **F64)
    _, f2 = T.integrate_orbit(pot, b2[-1], -3.0, 0.0, n_steps=2048, **F64)
    rel_rk4 = np.abs(f2[-1] - xv0).max() / np.abs(xv0).max()
    assert rel_rk4 > 100 * rel


def test_adaptive_orbit_energy_conservation(hosts):
    th = hosts[1]
    xv0 = np.array([30.0, 0.0, 10.0, 0.0, 150.0, 30.0])
    _, traj = torb.integrate_orbit_adaptive(th, xv0, 0.0, 10.0, n_out=64,
                                            rtol=1e-10, atol=1e-10, **F64)
    e = [0.5 * np.sum(traj[k, 3:] ** 2)
         + float(th.potential(traj[k, :3])) for k in (0, 32, 64)]
    assert abs(e[2] - e[0]) / abs(e[0]) < 1e-8
    assert abs(e[1] - e[0]) / abs(e[0]) < 1e-8


class _NaNCorePot:
    """Kepler point mass whose force is NaN inside r < 0.05 (a duck-typed
    field: tensors in, tensors out)."""

    def force(self, pos, t=0.0):
        r2 = (pos ** 2).sum(-1, keepdim=True)
        f = -4.3e-6 * 1e10 * pos / torch.clamp_min(r2, 1e-30) ** 1.5
        return torch.where(r2 < 0.05 ** 2, torch.nan, f)


def test_adaptive_orbit_nan_force_poisons_not_freezes():
    """A NaN force evaluation shrinks the step (never grows it) and, when
    the interval cannot be completed, NaN-poisons the output instead of
    returning a silently-truncated finite trajectory."""
    xv0 = np.array([1.0, 0.0, 0.0, -1.0, 0.0, 0.0])
    _, traj = torb.integrate_orbit_adaptive(
        _NaNCorePot(), xv0, 0.0, 5.0, n_out=32, rtol=1e-8, atol=1e-8,
        max_substeps=3000, **F64)
    assert np.isfinite(traj[0]).all()
    assert np.isnan(traj[-1]).any()
    finite = traj[np.isfinite(traj).all(axis=1)]
    assert (np.linalg.norm(finite[:, :3], axis=1) > 0.049).all()


def test_adaptive_orbit_interval_clip_keeps_cruise_step(hosts):
    """The carried step does not collapse to the end-of-interval sliver:
    the round trip stays exact at a small substep budget."""
    th = hosts[1]
    xv0 = np.array([30.0, 0.0, 0.0, 0.0, 180.0, 0.0])
    kw = dict(n_out=64, rtol=1e-9, atol=1e-9, **F64)
    _, traj = torb.integrate_orbit_adaptive(th, xv0, 0.0, 2.0, **kw)
    _, back = torb.integrate_orbit_adaptive(th, traj[-1], 2.0, 0.0,
                                            max_substeps=64, **kw)
    assert np.abs(back[-1] - xv0).max() / np.abs(xv0).max() < 1e-5
