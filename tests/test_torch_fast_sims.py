"""The port's particle spray and restricted N-body (fast_sims/spray.py,
restricted.py) against the JAX package's, on the CPU.

The same numpy inputs and seeds go through both packages in float64 (the
JAX side under tests/conftest.py's ``jax_enable_x64``, the port with
``dtype=torch.float64, device='cpu'``).  Tolerances, max |port - JAX| /
max |JAX| (positions and velocities apart where a phase-space state is
compared): spray and restricted runs 1e-10 (measured ~1e-14: the same
arithmetic in another order).  The orbit integrators are held by
tests/test_torch_orbits.py, the Jacobi radius, the IC generators and the
shared builders by tests/test_torch_fast_sims_common.py and the King
cases by tests/test_torch_df.py.  The JAX package's property tests
(tests/test_fast_sims.py) are mirrored on the port, and
``chip_smoke.SPRAY_TOL`` is pinned to the JAX package's own float32
error on the card's spray case.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import nbody_streams_tpu.fast_sims as J
import nbody_streams_tpu.potentials as JP
import nbody_streams_tpu_torch.fast_sims as T
import nbody_streams_tpu_torch.potentials as TP

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
# the JAX package's copy of chip_smoke.MW22
MW22_JAX = "nbody_streams_tpu/data/potentials/MWPotential22.ini"


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
    f = host.force(np.array([r, 0.0, 0.0]))
    f = f.numpy() if isinstance(f, torch.Tensor) else np.asarray(f)
    vc = np.sqrt(-r * f[0])
    return np.array([r, 0, 0, 0, vc, 0]), vc


# ---------------------------------------------------------------------------
# Spray and restricted N-body end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,save_rate", [
    ("chen2025", 1), ("fardal2015", 4)])
def test_spray_stream_matches_jax(hosts, method, save_rate):
    jh, th = hosts
    sat_now = np.array([40.0, 0, 0, 0, 140.0, 30.0])
    kw = dict(initmass=1e8, sat_cen_present=sat_now, scaleradius=0.3,
              num_particles=200, prog_pot_kind="Plummer", time_total=1.0,
              time_end=0.0, n_steps=300, save_rate=save_rate, seed=3)
    name = f"create_ic_particle_spray_{method}"
    want = J.create_particle_spray_stream(
        jh, create_ic_method=getattr(J, name), **kw)
    got = T.create_particle_spray_stream(
        th, create_ic_method=getattr(T, name), **kw, **F64)
    np.testing.assert_array_equal(got["times"], want["times"])
    nan = np.isnan(want["part_xv"])
    np.testing.assert_array_equal(np.isnan(got["part_xv"]), nan)
    _close_xv(np.where(nan, 0, got["part_xv"]),
              np.where(nan, 0, want["part_xv"]), 1e-10)
    _close_xv(got["prog_xv"], want["prog_xv"], 1e-10)
    part = got["part_xv"]
    if save_rate == 1:
        assert part.shape == (200, 6) and np.isfinite(part).all()
        spread = np.linalg.norm(part[:, :3] - part[:, :3].mean(0), axis=1)
        assert spread.max() > 2.0
        np.testing.assert_allclose(got["prog_xv"], sat_now, atol=0.5)
    else:
        assert part.ndim == 3 and part.shape[0] == 200
        assert np.isnan(part[:, 0, :]).any()
        assert np.isfinite(part[:, -1, :]).all()


def test_spray_validation(hosts):
    th = hosts[1]
    with pytest.raises(ValueError):
        T.create_particle_spray_stream(th, initmass=-1,
                                       sat_cen_present=np.zeros(6),
                                       scaleradius=0.3, **F64)
    with pytest.raises(ValueError, match="non-decreasing"):
        T.create_particle_spray_stream(
            th, initmass=1e8, sat_cen_present=np.zeros(6) + 30,
            scaleradius=0.3, num_particles=10, time_total=1.0,
            time_end=0.0, time_stripping=np.array([0.0, -0.5, -0.2, -0.8,
                                                   -0.1]), **F64)
    xv0, _ = circular_state(th, 40.0)
    common = dict(initmass=1e6, sat_cen_present=xv0, scaleradius=0.05,
                  prog_pot_kind="Plummer", time_total=0.2, time_end=0.0,
                  n_steps=100, seed=1, **F64)
    with pytest.warns(UserWarning, match="odd"):
        res = T.create_particle_spray_stream(th, num_particles=11, **common)
    assert res["part_xv"].shape[0] == 10
    with pytest.raises(ValueError, match=">= 2"):
        T.create_particle_spray_stream(th, num_particles=1, **common)


def test_restricted_nbody_matches_jax(hosts):
    jh, th = hosts
    kw = dict(initmass=1e7, sat_cen_present=np.array([25.0, 0, 0, 0, 120.0,
                                                      0.0]),
              scaleradius=0.5, num_particles=300, prog_pot_kind="Plummer",
              time_total=1.0, time_end=0.0, n_steps=60, step_size=20,
              save_rate=5, seed=2)
    want = J.run_restricted_nbody(jh, **kw)
    got = T.run_restricted_nbody(th, **kw, **F64)
    np.testing.assert_allclose(got["times"], want["times"], rtol=0,
                               atol=1e-14)
    np.testing.assert_array_equal(got["bound_mass"], want["bound_mass"])
    _close_xv(got["part_xv"], want["part_xv"], 1e-10)
    _close_xv(got["prog_xv"], want["prog_xv"], 1e-10)
    assert got["part_xv"].shape[1] == 300 and np.isfinite(
        got["part_xv"]).all()
    assert got["bound_mass"][-1] <= 1e7 + 1e-6


# ---------------------------------------------------------------------------
# The float32 error behind chip_smoke.SPRAY_TOL
# ---------------------------------------------------------------------------

def test_spray_fp32_error_within_chip_tolerance():
    """chip_smoke.SPRAY_TOL is 4-5 times the JAX package's own float32 vs
    float64 error on the card's spray window (examples/stream_in_mw.py's
    case, cut to its first SPRAY_WINDOW output nodes and forward steps,
    every step saved) at 400 particles: the rewound orbit (max over the
    window's nodes) and the released stream at the window's end (max over
    the particles), positions and velocities apart; the port's float32 on
    the CPU stays within it too."""
    import jax

    from nbody_streams_tpu.potentials import load_potential_ini as jini
    from nbody_streams_tpu_torch.potentials import load_potential_ini

    case = chip_smoke.spray_window(num_particles=400)
    jmw = jini(MW22_JAX)
    tmw = load_potential_ini(chip_smoke.MW22, device="cpu")

    def run(fs, pot, **kw):
        res = fs.create_particle_spray_stream(pot, **case, **kw)
        return res["prog_xv"], res["part_xv"][:, -1]

    j64 = run(J, jmw)
    with jax.enable_x64(False):
        j32 = run(J, jmw)
    assert jax.config.jax_enable_x64
    t64 = run(T, tmw, dtype=torch.float64, device="cpu")
    t32 = run(T, tmw, dtype=torch.float32, device="cpu")
    for k, key in enumerate(("rewind", "stream")):
        assert np.isfinite(t64[k]).all() and np.isfinite(j32[k]).all()
        _close_xv(t64[k], j64[k], 1e-10)
        for c, sl in enumerate((slice(0, 3), slice(3, 6))):
            own = _rel(j32[k][..., sl], j64[k][..., sl])
            tol = chip_smoke.SPRAY_TOL[key][c]
            assert 4 * own <= tol <= 5 * own, (key, c, own)
            assert _rel(t32[k][..., sl], t64[k][..., sl]) <= tol
