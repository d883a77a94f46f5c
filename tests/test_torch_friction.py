"""The port's dynamical friction (friction.py) against the JAX package's.

The same numpy inputs go through both packages (float64 unless stated):
sigma(r) for every method on an NFW and a Hernquist host (rtol 1e-10), the
two centre finders and the Chandrasekhar formula (1e-12), the friction term
stepped from a state carried across by ``from_jax_state(extra_state=)``
(1e-12), and ``run_simulation`` with friction for both centre methods
(1e-6 * max |x|, as tests/test_torch_sim.py; measured ~3e-13 in float64.
In float32 + Kahan the two packages drift apart by ~1e-5 of max |x| over
these 200 steps with or without friction: the 64-particle cluster's own
chaos, not the friction term).  The JAX package's property tests are
mirrored below, and ``chip_smoke.DF_TOL`` is pinned to its own float32
error.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import nbody_streams_tpu as jst
import nbody_streams_tpu_torch as tst
from nbody_streams_tpu import friction as jf
from nbody_streams_tpu import integrate as ji
from nbody_streams_tpu.ops.dispatch import DirectGravity as JDirectGravity
from nbody_streams_tpu.potentials import (
    HernquistPotential as JHernquist,
    NFWPotential as JNFW,
)
from nbody_streams_tpu_torch import friction as tf
from nbody_streams_tpu_torch import integrate as ti
from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
from nbody_streams_tpu_torch.potentials import (
    HernquistPotential as THernquist,
    NFWPotential as TNFW,
)

torch.set_num_threads(2)

G = tst.G_DEFAULT
HOSTS = {"nfw": (JNFW, TNFW), "hernquist": (JHernquist, THernquist)}


def _host(pkg="t", kind="nfw"):
    cls = HOSTS[kind][0 if pkg == "j" else 1]
    return cls(mass=1e12, scaleRadius=20.0)


def _np(x):
    return (x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, float))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _satellite(n, seed, offset=(40.0, 0.0, 0.0), vbulk=(0.0, 120.0, 0.0),
               mass=5e9, a=0.5):
    xv, m = tst.make_plummer_sphere(n, M_total=mass, a=a, seed=seed)
    xv[:, :3] += offset
    xv[:, 3:] += vbulk
    return xv, m


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(HOSTS))
@pytest.mark.parametrize("method", ["jeans", "quasispherical",
                                    "local_circular"])
def test_sigma_r_matches_jax(kind, method):
    r = np.geomspace(0.5, 300, 12)
    want = jf.compute_sigma_r(_host("j", kind), method=method)(jnp.asarray(r))
    got = tf.compute_sigma_r(_host("t", kind), method=method)(torch.tensor(r))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10)


def test_shrinking_sphere_matches_jax():
    xv, m = _satellite(500, 4, (30.0, -10.0, 5.0), (50.0, 120.0, -30.0),
                       mass=1e8, a=0.3)
    for n_iter, frac in ((5, 0.5), (8, 0.7)):
        want = jf.shrinking_sphere_com(jnp.asarray(xv[:, :3]),
                                       jnp.asarray(xv[:, 3:]),
                                       jnp.asarray(m), n_iter, frac)
        got = tf.shrinking_sphere_com(torch.tensor(xv[:, :3]),
                                      torch.tensor(xv[:, 3:]),
                                      torch.tensor(m), n_iter, frac)
        for g, w in zip(got, want):
            assert _rel(g, w) < 1e-12


def _phi_case(n_sat, n_out, seed):
    """A Plummer satellite plus unbound interlopers, with the fp64
    self-potential (the JAX package's test_bound_center_phi case)."""
    rng = np.random.default_rng(seed)
    xv, m = _satellite(n_sat, 8, (20.0, 5.0, -3.0), (80.0, -40.0, 10.0),
                       mass=1e8, a=0.3)
    pos = np.vstack([xv[:, :3], rng.normal(0, 30, (n_out, 3)) + xv[0, :3]])
    vel = np.vstack([xv[:, 3:], rng.normal(0, 500, (n_out, 3))])
    mass = np.concatenate([m, np.full(n_out, m[0])])
    phi = tst.compute_potential_direct(pos, mass, 0.01, precision="float64",
                                       device="cpu").numpy()
    return pos, vel, mass, phi


@pytest.mark.parametrize("n_sat,n_out", [(400, 100), (401, 100)])
def test_bound_center_phi_matches_jax(n_sat, n_out):
    """Both parities of the bound count; the even one needs the
    two-middle-values median of jnp.nanmedian."""
    pos, vel, mass, phi = _phi_case(n_sat, n_out, 3)
    r0, v0 = pos[:n_sat].mean(0) + 1.0, vel[:n_sat].mean(0)
    want = jf.bound_center_phi(*map(jnp.asarray, (pos, vel, mass, phi, r0,
                                                  v0)), 2e-3)
    got = tf.bound_center_phi(*map(torch.tensor, (pos, vel, mass, phi, r0,
                                                  v0)), 2e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w, float), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(w)).max())


def test_nanmedian_averages_the_two_middle_values():
    """jnp.nanmedian averages the middle pair of an even count, and
    torch.nanmedian returns the lower: the friction's median is the
    former, per column and ignoring NaN."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(10, 6))
    x[rng.random((10, 6)) < 0.3] = np.nan
    x[:, 0] = np.nan
    x[0, 0], x[1, 0] = 1.0, 2.0                   # an even count of 2
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=0))
    got = tf._nanmedian0(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15)
    assert got[0] == 1.5
    assert torch.nanmedian(torch.tensor(x), 0).values[0] == 1.0


def test_bound_center_even_count_is_not_the_lower_median():
    """Four bound particles among six: the centre is the mean of the two
    middle phase-space values, as the JAX package finds it; with
    torch.nanmedian's lower middle value in its place the centre moves."""
    rng = np.random.default_rng(7)
    pos = rng.normal(0, 1.0, (6, 3))
    vel = rng.normal(0, 5.0, (6, 3))
    mass = np.full(6, 1e6)
    phi = np.array([-1e6, -1e6, -1e6, -1e6, 1.0, 1.0])
    args = (pos, vel, mass, phi, np.zeros(3), np.zeros(3))
    want = jf.bound_center_phi(*map(jnp.asarray, args), 0.0, r_max=100.0)
    got = tf.bound_center_phi(*map(torch.tensor, args), 0.0, r_max=100.0)
    assert int(got[2].sum()) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w, float), rtol=1e-12)
    real = tf._nanmedian0
    try:
        tf._nanmedian0 = lambda x: torch.nanmedian(x, 0).values
        lower = tf.bound_center_phi(*map(torch.tensor, args), 0.0,
                                    r_max=100.0)[0]
    finally:
        tf._nanmedian0 = real
    assert np.abs(_np(lower) - np.asarray(want[0])).max() > 1e-3


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("coulomb", ["variable", "fixed"])
@pytest.mark.parametrize("core_gamma", [0.0, 1.5])
def test_chandrasekhar_accel_matches_jax(batched, coulomb, core_gamma):
    rng = np.random.default_rng(1)
    if batched:
        r = rng.normal(0, 30, (7, 3))
        v = rng.normal(0, 150, (7, 3))
        v[0] = 0.0                                 # at rest: zero
        rho, sig = rng.uniform(1e5, 1e7, 7), rng.uniform(50, 200, 7)
    else:
        r, v = np.array([30.0, 0.0, 0.0]), np.array([0.0, 150.0, 0.0])
        rho, sig = 3e6, 120.0
    kw = dict(G=G, coulomb_mode=coulomb, fixed_ln_lambda=2.5,
              core_gamma=core_gamma, r_core=40.0)
    want = jf.chandrasekhar_accel(jnp.asarray(r), jnp.asarray(v), 1e10,
                                  jnp.asarray(rho), jnp.asarray(sig), 0.0,
                                  **kw)
    got = tf.chandrasekhar_accel(*(torch.as_tensor(np.asarray(x, float))
                                   for x in (r, v, 1e10, rho, sig)), 0.0,
                                 **kw)
    assert got.shape == tuple(np.shape(want))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12,
                               atol=1e-14)


def test_host_form_matches_jax():
    sig_j = jf.compute_sigma_r(_host("j"), method="jeans")
    sig_t = tf.compute_sigma_r(_host("t"), method="jeans")
    args = ([30.0, 4.0, 0.0], [10.0, 150.0, 5.0], 1e10)
    want = jf.chandrasekhar_friction(*args, _host("j"), sig_j, 0.0)
    got = tf.chandrasekhar_friction(*args, _host("t"), sig_t, 0.0)
    assert isinstance(got, np.ndarray) and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-12)


STATE = ("pos", "vel", "pos_c", "vel_c", "acc", "ext_acc", "step")


@pytest.mark.parametrize("com_method", ["shrinking_sphere", "bound_phi"])
def test_friction_steps_match_jax_from_carried_state(com_method):
    """Three KDK steps in the JAX package, the state (friction dict
    included) carried across, then 12 more steps in each package (full
    updates at steps 5, 10 and 15, the predictor between)."""
    xv, m = _satellite(64, 5, mass=1e6, a=0.2)
    kw = dict(M_sat=5e10, update_interval=5, com_method=com_method,
              t_start=0.0, t_end=0.1)
    dt = 2e-3
    jfx = jf.ChandrasekharFriction(_host("j"), **kw)
    jsol = JDirectGravity(m, np.full(64, 0.05), precision="float64",
                          impl="jnp")
    jacc = ji.make_accel_fn(jsol, jsol.mass, _host("j"), 1, jfx)
    jstep = ji.make_kdk_step(jacc, dt, 0.0, compensated=False)
    s = ji.init_state(xv[:, :3], xv[:, 3:], jacc, jsol.mass, 0.0,
                      dtype=jnp.float64, force_extra=jfx)
    s3 = ji.run_chunk(jstep, jax.tree.map(jnp.copy, s), 3)
    arrays = {k: np.asarray(getattr(s3, k)) for k in STATE}
    extra = jax.tree.map(np.asarray, s3.extra_state)

    state = ti.from_jax_state(arrays, extra_state=extra, device="cpu")
    assert isinstance(state.extra_state["t_prev"], float)
    back = ti.to_numpy_state(state)["extra_state"]
    for k, v in extra.items():
        np.testing.assert_array_equal(back[k], v)

    tfx = tf.ChandrasekharFriction(_host("t"), **kw).to("cpu",
                                                        torch.float64)
    tsol = DirectGravity(m, np.full(64, 0.05), precision="float64",
                         device="cpu")
    tstep = ti.make_kdk_step(
        ti.make_accel_fn(tsol, tsol.mass, _host("t"), 1, tfx), dt, 0.0,
        compensated=False)
    got = ti.run_chunk(tstep, state, 12)
    want = ji.run_chunk(jstep, s3, 12)
    assert got.step == 15
    for k in ("pos", "vel", "acc"):
        assert _rel(getattr(got, k), getattr(want, k)) < 1e-12, k
    for k, v in want.extra_state.items():
        if k == "t_prev":
            assert abs(got.extra_state[k] - float(v)) < 1e-15
        else:
            assert _rel(got.extra_state[k], v) < 1e-12, k


@pytest.mark.parametrize("com_method", ["shrinking_sphere", "bound_phi"])
def test_run_simulation_with_friction_matches_jax(com_method):
    n = 64
    xv, m = tst.make_plummer_sphere(n, M_total=1e6, a=0.2, seed=5)
    xv = tst.place_on_orbit(xv, r_peri=28.0, r_apo=32.0,
                            potential=_host("t"))
    runs = {}
    for pkg, which in ((jst, "j"), (tst, "t")):
        sp = [pkg.Species.dark(N=n, mass=float(m[0]), softening=0.05)]
        with tempfile.TemporaryDirectory() as d:
            runs[which] = pkg.run_simulation(
                xv, sp, 0.0, 200 * 2e-3, 2e-3, architecture="cpu",
                external_potential=_host(which), dynamical_friction=True,
                df_M_sat=5e10, df_com_method=com_method,
                df_update_interval=5, output_dir=d, save_snapshots=False,
                verbose=False, precision="float64")["dark"]
    got, want = runs["t"], runs["j"]
    for sl in (slice(0, 3), slice(3, 6)):
        scale = np.abs(want[:, sl]).max()
        assert np.abs(got[:, sl] - want[:, sl]).max() < 1e-6 * scale
    # the orbit decayed from ~30 kpc
    assert np.linalg.norm(got[:, :3].mean(0)) < 31.0


def test_df_fp32_error_within_chip_tolerance():
    """chip_smoke.DF_TOL is 4-5 times the JAX package's own float32 vs
    float64 error of the friction vector a_df (|da| / |a|) at a full
    bound_phi update of the DF case's satellite (N = 65,536, M = 5e9,
    a = 0.5 at +40 kpc, +120 km/s in the NFW host; the Plummer
    self-potential as phi); the port's float32 on the CPU stays within it
    too.  The float64 reference is the port's (parity above)."""
    n = chip_smoke.N_BENCH
    xv, m = tst.make_plummer_sphere(n, M_total=5e9, a=0.5, seed=4)
    r = np.linalg.norm(xv[:, :3], axis=1)
    phi = -G * 5e9 / np.sqrt(r ** 2 + 0.25)
    xv[:, 0] += 40.0
    xv[:, 4] += 120.0
    kw = dict(M_sat=5e9, sigma_method="jeans", update_interval=10,
              com_method="bound_phi", t_start=0.0, t_end=1.5)
    t0, t1 = 0.2, 0.2 + 2e-3

    def port(dtype):
        fx = tf.ChandrasekharFriction(_host("t"), **kw).to("cpu", dtype)
        p, v, mm, ph = (torch.tensor(a, dtype=dtype)
                        for a in (xv[:, :3], xv[:, 3:], m, phi))
        st = fx.init_state(p, v, mm, t0)
        return fx(st, p, v, mm, t1, phi=ph, step=10)[1]

    s64, s32 = port(torch.float64), port(torch.float32)
    with jax.enable_x64(False):
        jfx = jf.ChandrasekharFriction(_host("j"), **kw)
        p, v, mm, ph = (jnp.asarray(a, jnp.float32)
                        for a in (xv[:, :3], xv[:, 3:], m, phi))
        st = jfx.init_state(p, v, mm, jnp.float32(t0))
        sj = jax.jit(lambda s, p, v, mm, ph: jfx(
            s, p, v, mm, jnp.float32(t1), phi=ph, step=10)[1])(
                st, p, v, mm, ph)
        a_j = np.asarray(sj["a_df"], float)
    a64 = s64["a_df"].numpy()

    def err(a):
        return np.linalg.norm(_np(a) - a64) / np.linalg.norm(a64)

    own = err(a_j)
    assert 4 * own <= chip_smoke.DF_TOL <= 5 * own
    assert err(s32["a_df"]) <= chip_smoke.DF_TOL
    assert bool((s32["bound"] == s64["bound"]).all())


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------

def test_to_copies_the_potential_to_the_run():
    host = _host("t")
    fx = tf.make_df_force_extra(host, M_sat=1e9)
    before = host._where.dtype
    moved = fx.to("cpu", torch.float64)
    assert moved is not fx and moved.pot is not host
    assert moved.pot._where.dtype == torch.float64
    assert host._where.dtype == before != torch.float64
    circ = tf.make_df_force_extra(host, M_sat=1e9,
                                  sigma_method="local_circular")
    r = torch.tensor(20.0, dtype=torch.float32)
    assert circ.to("cpu", torch.float32).sigma(r).dtype == torch.float32


def _mwlmc_friction(**kw):
    from nbody_streams_tpu_torch.potentials.mwlmc import (
        load_mw_lmc_potential)

    field = load_mw_lmc_potential(device="cpu")[0]
    return tf.make_df_force_extra(field, M_sat=2.25e9, G=G, t_start=-0.02,
                                  t_end=0.0, **kw).to("cpu", torch.float32)


@pytest.mark.parametrize("com_method", ["shrinking_sphere", "bound_phi"])
def test_cpu_friction_captures_nothing_and_is_the_eager_form(monkeypatch,
                                                             com_method):
    """On the CPU no call tries a CUDA graph, and 12 calls in the MW + LMC
    field (refreshes at 0 and 10, the predictor between) give, bit for
    bit, the density, sigma and eq. 8.13 at each call's centre."""
    tried = []
    monkeypatch.setattr(tf, "_CentreGraph",
                        lambda *args: tried.append(args))
    before = dict(tf.GRAPHS)
    fx = _mwlmc_friction(com_method=com_method, update_interval=10)
    xv, m = _satellite(256, 8, offset=(52.0, 0.0, 35.0),
                       vbulk=(-35.0, 95.0, -40.0))
    p, v, mm = (torch.tensor(a, dtype=torch.float32)
                for a in (xv[:, :3], xv[:, 3:], m))
    phi = -G * 5e9 / torch.sqrt(((p - p.mean(0)) ** 2).sum(1) + 0.25)
    st = fx.init_state(p, v, mm, -0.02)
    for k in range(12):
        t = -0.02 + (k + 1) * 1e-3
        _, st = fx(st, p, v, mm, t, phi=phi, step=k)
        m_eff = (torch.clamp_min(st["m_bound"], 1e-4 * fx.M_sat)
                 if com_method == "bound_phi" else fx.M_sat)
        r = torch.linalg.norm(st["r_com"])
        want = tf.chandrasekhar_accel(
            st["r_com"], st["v_com"], m_eff,
            fx.pot.density(st["r_com"], t=t), fx.sigma(r, t=t), t, G=G)
        assert torch.equal(st["a_df"], want.to(torch.float32)), k
    assert not tried and fx._graph is None and tf.GRAPHS == before


@pytest.mark.parametrize("sigma_method", ["jeans", "local_circular"])
def test_centre_term_with_a_device_time_reads_nothing_back(sigma_method):
    """What the CUDA graph captures: the centre term in the MW + LMC field
    with the time as a 0-dim float64 tensor reads no device value back
    (no ``_local_scalar_dense``) and agrees with the host-time form within
    float32 rounding, on either side of one of the LMC table's
    breakpoints (-0.015625)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoHostRead(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            assert func is not torch.ops.aten._local_scalar_dense.default
            return func(*args, **(kwargs or {}))

    fx = _mwlmc_friction(sigma_method=sigma_method)
    r = torch.tensor([52.0, 0.0, 35.0])
    v = torch.tensor([-35.0, 95.0, -40.0])
    for t in (-0.0157, -0.015625, -0.0155):
        want = fx._centre_term(r, v, fx.M_sat, t)
        with NoHostRead():
            got = fx._centre_term(r, v, fx.M_sat,
                                  torch.tensor(t, dtype=torch.float64))
        assert got.shape == want.shape == (3,)
        assert float((got - want).norm() / want.norm()) < 1e-6


def test_run_simulation_df_routing(tmp_path, monkeypatch):
    """df_M_sat defaults to the total mass; df_* without friction and
    friction without a field are refused; DF without a card at the
    default architecture raises, naming the CPU option."""
    xv, m = tst.make_plummer_sphere(20, M_total=1e6, a=0.2, seed=6)
    sp = [tst.Species.dark(N=20, mass=float(m[0]), softening=0.05)]
    seen = {}
    real = tf.make_df_force_extra

    def spy(pot, M_sat, **kw):
        seen["M_sat"] = M_sat
        seen.update(kw)
        return real(pot, M_sat, **kw)

    monkeypatch.setattr(tf, "make_df_force_extra", spy)
    run = dict(time_start=0.0, time_end=4e-3, dt=2e-3,
               output_dir=str(tmp_path), save_snapshots=False,
               verbose=False)
    tst.run_simulation(xv, sp, architecture="cpu", external_potential=_host(),
                       dynamical_friction=True, df_update_interval=3, **run)
    assert seen["M_sat"] == pytest.approx(m.sum(), rel=1e-12)
    assert seen["update_interval"] == 3 and seen["t_end"] == 4e-3
    with pytest.raises(TypeError, match="df_"):
        tst.run_simulation(xv, sp, architecture="cpu", df_M_sat=1e9, **run)
    with pytest.raises(ValueError, match="external_potential"):
        tst.run_simulation(xv, sp, architecture="cpu",
                           dynamical_friction=True, **run)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="architecture='cpu'"):
            tst.run_simulation(xv, sp, external_potential=_host(),
                               dynamical_friction=True, **run)


# ---------------------------------------------------------------------------
# the JAX package's property tests (tests/test_friction.py), mirrored
# ---------------------------------------------------------------------------

def test_sigma_methods_agree_roughly():
    s_jeans = tf.compute_sigma_r(_host(), method="jeans")
    s_circ = tf.compute_sigma_r(_host(), method="local_circular")
    for r in (5.0, 20.0, 80.0):
        a = float(s_jeans(torch.tensor(r)))
        b = float(s_circ(torch.tensor(r)))
        assert 0.4 < a / b < 2.5
        assert 20.0 < a < 300.0
    assert float(tf.compute_sigma_r(_host(), method="quasispherical")(
        torch.tensor([10.0]))[0]) > 0


def test_quasispherical_sigma_matches_jeans_for_isotropic():
    pot = _host("t", "hernquist")
    r = torch.tensor(np.geomspace(0.5, 300, 12))
    np.testing.assert_allclose(
        tf.compute_sigma_r(pot, method="quasispherical")(r).numpy(),
        tf.compute_sigma_r(pot, method="jeans")(r).numpy(), rtol=8e-3)
    with pytest.raises(ValueError):
        tf.compute_sigma_r(pot, method="nope")


def test_shrinking_sphere_finds_offset_cluster():
    offset, vbulk = np.array([30.0, -10.0, 5.0]), np.array([50., 120, -30])
    xv, m = _satellite(500, 4, offset, vbulk, mass=1e8, a=0.3)
    com, v_com, r_sph = tf.shrinking_sphere_com(
        *map(torch.tensor, (xv[:, :3], xv[:, 3:], m)))
    assert np.linalg.norm(com.numpy() - offset) < 0.5
    assert np.linalg.norm(v_com.numpy() - vbulk) < 10.0
    assert float(r_sph) > 0


def test_friction_opposes_motion_and_vanishes_at_rest():
    host = _host()
    r_com = torch.tensor([30.0, 0.0, 0.0], dtype=torch.float64)
    v_com = torch.tensor([0.0, 150.0, 0.0], dtype=torch.float64)
    rho = host.density(r_com)
    sig = tf.compute_sigma_r(host, method="jeans")(torch.tensor(30.0))
    a = tf.chandrasekhar_accel(r_com, v_com, 1e10, rho, sig, 0.0).numpy()
    assert a[1] < 0
    np.testing.assert_allclose(a[[0, 2]], 0.0, atol=abs(a[1]) * 1e-10)
    a2 = tf.chandrasekhar_accel(r_com, v_com, 1e11, rho, sig, 0.0).numpy()
    assert abs(a2[1]) > abs(a[1])
    rest = tf.chandrasekhar_accel(r_com, torch.zeros(3, dtype=torch.float64),
                                  1e10, rho, torch.tensor(100.0), 0.0)
    np.testing.assert_allclose(rest.numpy(), 0.0)


@pytest.mark.parametrize("kw,match", [
    (dict(M_sat=-1.0), "M_sat"),
    (dict(M_sat=1e9, update_interval=0), "update_interval"),
    (dict(M_sat=1e9, com_method="median"), "com_method")])
def test_factory_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        tf.make_df_force_extra(_host(), **kw)


def test_bound_center_phi_finds_cluster():
    pos, vel, mass, phi = _phi_case(400, 100, 12345)
    offset = np.array([20.0, 5.0, -3.0])
    vbulk = np.array([80.0, -40.0, 10.0])
    r_com, v_com, bound, m_b = tf.bound_center_phi(
        *map(torch.tensor, (pos, vel, mass, phi, offset + 1.0, vbulk)), 0.0)
    assert np.linalg.norm(r_com.numpy() - offset) < 0.5
    assert np.linalg.norm(v_com.numpy() - vbulk) < 15.0
    assert bound.numpy()[-100:].mean() < 0.2
    assert float(m_b) < mass.sum()


def test_orbit_decay_behavioral(tmp_path):
    """A massive satellite's orbit decays; an ultralight one's does not."""
    n = 60
    xv, m = tst.make_plummer_sphere(n, M_total=1e6, a=0.2, seed=5)
    xv = tst.place_on_orbit(xv, r_peri=28.0, r_apo=32.0, potential=_host())
    sp = [tst.Species.dark(N=n, mass=float(m[0]), softening=0.05)]
    common = dict(time_start=0.0, time_end=0.4, dt=2e-3, architecture="cpu",
                  external_potential=_host(), save_snapshots=False,
                  verbose=False, precision="float64", df_update_interval=5)
    r = {}
    for tag, m_sat in (("heavy", 5e10), ("light", 1e4)):
        res = tst.run_simulation(xv, sp, dynamical_friction=True,
                                 df_M_sat=m_sat,
                                 output_dir=str(tmp_path / tag), **common)
        r[tag] = np.linalg.norm(res["dark"][:, :3].mean(0))
    assert abs(r["light"] - 30.0) < 3.0
    assert r["heavy"] < r["light"] - 1.0


def test_df_bound_phi_end_to_end(tmp_path):
    n = 50
    xv, m = tst.make_plummer_sphere(n, M_total=1e6, a=0.2, seed=9)
    xv = tst.place_on_orbit(xv, r_peri=28.0, r_apo=32.0, potential=_host())
    sp = [tst.Species.dark(N=n, mass=float(m[0]), softening=0.05)]
    res = tst.run_simulation(
        xv, sp, 0.0, 0.2, 2e-3, architecture="cpu", external_potential=_host(),
        dynamical_friction=True, df_M_sat=5e10, df_com_method="bound_phi",
        df_update_interval=5, output_dir=str(tmp_path), save_snapshots=False,
        verbose=False, precision="float64")
    assert np.isfinite(res["dark"]).all()
    assert np.linalg.norm(res["dark"][:, :3].mean(0)) < 31.0
