"""The port's SCF tier (ops/scf.py) against the JAX package's.

The same numpy inputs go through both packages: the radial norms exactly;
coefficients, potential and accelerations for ``center=None``, ``'com'``
(an off-centre sample, ``a`` passed explicitly: the default scale is
ROADMAP Queue 3's), the symmetry label sets, ``field`` and the composite
to 1e-10 of max in float64 (measured ~2e-15); float32 within
``chip_smoke.SCF_TOL``, four times the JAX package's own float32 error;
``run_simulation(method='scf')`` single-centre and with ``scf_groups``
(N = 2,048, 20 steps, float32 + Kahan) within 1e-6 * max |x| (measured
~1e-7), and every guard of ``sim.py``.  The JAX package's property tests
(tests/test_scf.py) are mirrored on the port, but for the GSPMD sharding
test.
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
from nbody_streams_tpu.ops import scf as js
from nbody_streams_tpu_torch.ops import scf as ts
from nbody_streams_tpu_torch.potentials.fit import _symmetry_labels
from nbody_streams_tpu_torch.species import PerformanceWarning

torch.set_num_threads(2)

G = 4.300917270069976e-06
CPU = dict(device="cpu")


def _np(x):
    return (x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, float))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _offcentre(n=2048, seed=8):
    xv, m = tst.make_plummer_sphere(n, M_total=1e9, a=1.0, seed=seed)
    pos = xv[:, :3].copy()
    pos[:, 0] += 0.5
    return pos, m


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_radial_norms_and_mask_exact():
    for nmax, lmax in ((0, 0), (3, 1), (8, 4)):
        np.testing.assert_array_equal(ts._radial_norms(nmax, lmax),
                                      js._radial_norms(nmax, lmax))
        labels = _symmetry_labels(lmax, lmax, "none")
        np.testing.assert_array_equal(ts._l_mask(nmax, lmax, labels),
                                      js._l_mask(nmax, lmax, labels))


@pytest.mark.parametrize("kw", [
    dict(center=None), dict(center="com"), dict(center=(0.3, -0.2, 0.1)),
    dict(symmetry="spherical"), dict(symmetry="axisymmetric"),
    dict(symmetry="triaxial", mmax=2), dict(symmetry="bisymmetric")],
    ids=["origin", "com", "static", "spherical", "axisym", "triaxial",
         "bisym"])
def test_scf_matches_jax_float64(kw):
    pos, m = _offcentre()
    J = js.SCFGravity(m, nmax=8, lmax=4, a=1.0, G=G, precision="float64",
                      **kw)
    T = ts.SCFGravity(m, nmax=8, lmax=4, a=1.0, G=G, precision="float64",
                      **kw, **CPU)
    assert T.labels == J.labels and T.terms == J.terms
    pj, pt = jnp.asarray(pos), torch.tensor(pos)
    assert _rel(T._coefs(T._frame(pt)), J._coefs(pj)) < 1e-10
    assert _rel(T.potential(pt), J.potential(pj)) < 1e-10
    assert _rel(T.accel(pt), J.accel(pj)) < 1e-10


def test_field_and_composite_match_jax():
    pos, m = _offcentre(768)
    pts = np.random.default_rng(2).normal(0, 2.0, (64, 3))
    J = js.SCFGravity(m, nmax=4, lmax=2, a=1.0, G=G, precision="float64")
    T = ts.SCFGravity(m, nmax=4, lmax=2, a=1.0, G=G, precision="float64",
                      **CPU)
    for g, w in zip(T.field(pos, pts), J.field(jnp.asarray(pos),
                                               jnp.asarray(pts))):
        assert _rel(g, w) < 1e-10
    groups = [(slice(0, 512), {"a": 1.0}),
              (slice(512, None), {"a": 0.3, "center": "com"})]
    pos[512:] = 0.3 * pos[512:] + (6.0, 0.0, 0.0)
    J = js.CompositeSCFGravity(m, groups=groups, G=G, precision="float64",
                               nmax=4, lmax=2)
    T = ts.CompositeSCFGravity(m, groups=groups, G=G, precision="float64",
                               nmax=4, lmax=2, **CPU)
    assert T.terms == J.terms
    pj, pt = jnp.asarray(pos), torch.tensor(pos)
    assert _rel(T.accel(pt), J.accel(pj)) < 1e-10
    assert _rel(T.potential(pt), J.potential(pj)) < 1e-10


def test_force_holds_coefficients_and_centre_fixed():
    """The force is -grad Phi at fixed coefficients and fixed centre of
    mass: differentiating through either (all positions as one leaf)
    gives another force, which the JAX package's does not match."""
    pos, m = _offcentre()
    J = js.SCFGravity(m, nmax=6, lmax=3, a=1.0, G=G, precision="float64",
                      center="com")
    T = ts.SCFGravity(m, nmax=6, lmax=3, a=1.0, G=G, precision="float64",
                      center="com", **CPU)
    want = np.asarray(J.accel(jnp.asarray(pos)))
    assert _rel(T.accel(torch.tensor(pos)), want) < 1e-10
    x = torch.tensor(pos, requires_grad=True)
    com = (T.mass[:, None] * x).sum(0) / T.mass.sum()
    p = x - com
    A = ts.scf_coefficients(p, T.mass, T.a, T.nmax, T.lmax, T.labels,
                            T._K_flat, T._mask)
    phi = ts._phi_of(p, A, T.a, T.G, T.nmax, T.lmax, T.labels)
    (g,) = torch.autograd.grad(phi.sum(), x)
    assert _rel(-g, want) > 1e-3


def test_scf_fp32_error_within_chip_tolerance():
    """chip_smoke.SCF_TOL is four to five times the JAX package's own
    float32 vs float64 error (accelerations, potential) of SCFGravity(8, 4,
    a=1) on the 65,536-particle Plummer sphere; the port's float32 on the
    CPU stays within it too."""
    n = chip_smoke.N_BENCH
    xv, m = tst.make_plummer_sphere(n, M_total=1e9, a=1.0, seed=7)
    pos = xv[:, :3]
    t64 = ts.SCFGravity(m, nmax=8, lmax=4, a=1.0, G=G, precision="float64",
                        **CPU)
    want = (t64.accel(torch.tensor(pos)), t64.potential(torch.tensor(pos)))
    with jax.enable_x64(False):
        j32 = js.SCFGravity(m, nmax=8, lmax=4, a=1.0, G=G)
        jax32 = jax.jit(lambda q: (j32.accel(q), j32.potential(q)))(
            jnp.asarray(pos, jnp.float32))
        jax32 = tuple(np.asarray(v) for v in jax32)
    assert jax32[0].dtype == np.float32
    t32 = ts.SCFGravity(m, nmax=8, lmax=4, a=1.0, G=G, **CPU)
    p32 = torch.tensor(pos, dtype=torch.float32)
    port = (t32.accel(p32), t32.potential(p32))
    for k, tol in enumerate(chip_smoke.SCF_TOL):
        own = _rel(jax32[k], want[k])
        assert 4 * own <= tol <= 5 * own
        assert _rel(port[k], want[k]) <= tol


@pytest.mark.parametrize("how", ["allow_tf32", "precision_high"])
def test_contractions_pin_ieee_fp32(how):
    """Inside the SCF contractions TF32 is off whatever the caller set (a
    card would otherwise run the fp32 matmuls in TF32); the caller's
    settings come back afterwards.  The card test with TF32 on is
    tests/test_torch_cuda.py::test_scf_fp32_with_tf32_on."""
    mm = torch.backends.cuda.matmul
    before = torch.get_float32_matmul_precision()
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return real(a, b)

    try:
        if how == "allow_tf32":
            mm.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        torch.matmul = spy
        pos, m = _offcentre(256)
        ts.SCFGravity(m, nmax=2, lmax=1, a=1.0, **CPU).accel(
            torch.tensor(pos, dtype=torch.float32))
        torch.matmul = real
        assert seen and set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "high"
        assert mm.allow_tf32
    finally:
        torch.matmul = real
        torch.set_float32_matmul_precision(before)
        mm.allow_tf32 = before != "highest"


def _two_species():
    xv_mw, m_mw = tst.make_plummer_sphere(1536, 1e9, 1.0, seed=5)
    xv_sat, m_sat = tst.make_plummer_sphere(512, 1e8, 0.3, seed=6)
    xv_sat[:, 0] += 6.0
    xv_sat[:, 4] += 150.0
    return np.concatenate([xv_mw, xv_sat]), m_mw, m_sat


@pytest.mark.parametrize("groups", [None, {"mw": {"a": 1.0},
                                           "sat": {"a": 0.3,
                                                   "center": "com"}}],
                         ids=["single", "groups"])
def test_run_simulation_scf_matches_jax(groups):
    xv, m_mw, m_sat = _two_species()
    kw = dict(scf_nmax=4, scf_lmax=2)
    kw.update(dict(scf_groups=groups) if groups else dict(scf_a=1.0))
    out = {}
    for pkg in (jst, tst):
        sp = [pkg.Species(name="mw", N=1536, mass=m_mw, softening=0.05),
              pkg.Species(name="sat", N=512, mass=m_sat, softening=0.05)]
        with tempfile.TemporaryDirectory() as d:
            res = pkg.run_simulation(xv, sp, 0.0, 20 * 1e-4, 1e-4,
                                     architecture="cpu", method="scf",
                                     output_dir=d, save_snapshots=False,
                                     verbose=False, **kw)
        out[pkg] = np.concatenate([res["mw"], res["sat"]])
    for sl in (slice(0, 3), slice(3, 6)):
        scale = np.abs(out[jst][:, sl]).max()
        assert np.abs(out[tst][:, sl] - out[jst][:, sl]).max() < 1e-6 * scale


def test_scf_guards_match_jax(tmp_path):
    xv, m = tst.make_plummer_sphere(256, 1e9, 1.0, seed=7)
    sp = [tst.Species(name="dark", N=256, mass=float(m[0]), softening=0.05)]
    run = dict(output_dir=str(tmp_path), save_snapshots=False, verbose=False)

    def sim(**kw):
        kw.setdefault("architecture", "cpu")
        return tst.run_simulation(xv, sp, 0.0, 2e-4, 1e-4, **run, **kw)

    for bad in (dict(impl="cuda"), dict(block_size=64),
                dict(kernel="plummer"), dict(devices=["cuda:0"]),
                dict(target_drift=1e-8)):
        with pytest.raises(TypeError, match=next(iter(bad))):
            sim(method="scf", **bad)
    with pytest.raises(TypeError, match="scf_"):
        sim(method="direct", scf_nmax=4)
    with pytest.warns(PerformanceWarning, match="float32_fast"):
        sim(method="scf", precision="float32_fast", scf_nmax=2, scf_lmax=0)
    with pytest.raises(ValueError, match="unknown species"):
        sim(method="scf", scf_groups={"nope": {"a": 1.0}})
    with pytest.raises(NotImplementedError, match="item 6"):
        sim(method="tree", devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="method"):
        sim(method="fmm")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="architecture='cpu'"):
            sim(method="scf", architecture="auto", scf_a=1.0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.SCFGravity(m, a=1.0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.CompositeSCFGravity(m, groups=[(slice(0, 256), {"a": 1.0})])


def test_float32_kahan_runs_scf_in_float32(tmp_path, monkeypatch):
    """float32_kahan runs the SCF solver in float32 under the compensated
    state; float64 in float64."""
    from nbody_streams_tpu_torch import run as trun

    xv, m = tst.make_plummer_sphere(256, 1e9, 1.0, seed=7)
    sp = [tst.Species(name="dark", N=256, mass=float(m[0]), softening=0.05)]
    built = []
    real = ts.SCFGravity.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        built.append((self.dtype, str(self.device)))

    monkeypatch.setattr(ts.SCFGravity, "__init__", spy)
    seen = []
    real_step = trun.make_kdk_step

    def step_spy(accel_fn, dt, t0, compensated=True):
        seen.append(compensated)
        return real_step(accel_fn, dt, t0, compensated)

    monkeypatch.setattr(trun, "make_kdk_step", step_spy)
    for precision in ("float32_kahan", "float64"):
        tst.run_simulation(xv, sp, 0.0, 2e-4, 1e-4, architecture="cpu",
                           method="scf", scf_a=1.0, precision=precision,
                           output_dir=str(tmp_path), save_snapshots=False,
                           verbose=False)
    assert built == [(torch.float32, "cpu"), (torch.float64, "cpu")]
    assert seen == [True, False]


# ---------------------------------------------------------------------------
# the JAX package's property tests (tests/test_scf.py), mirrored
# ---------------------------------------------------------------------------

def _quad_grid(n_r=64, n_th=24, n_ph=16, rmax_xi=0.999):
    xi, wxi = np.polynomial.legendre.leggauss(n_r)
    xi = (xi + 1) / 2 * (rmax_xi + 1) - 1
    wxi = wxi / 2 * (rmax_xi + 1)
    r = (1 + xi) / (1 - xi)
    dr = 2 / (1 - xi) ** 2
    ct, wct = np.polynomial.legendre.leggauss(n_th)
    ph = np.linspace(0, 2 * np.pi, n_ph, endpoint=False)
    wph = np.full(n_ph, 2 * np.pi / n_ph)
    R, CT, PH = np.meshgrid(r, ct, ph, indexing="ij")
    W = ((wxi * dr * r**2)[:, None, None] * wct[None, :, None]
         * wph[None, None, :])
    ST = np.sqrt(1 - CT**2)
    pos = np.stack([R * ST * np.cos(PH), R * ST * np.sin(PH), R * CT],
                   -1).reshape(-1, 3)
    return pos, W.reshape(-1)


def test_radial_norms_analytic():
    from scipy.integrate import quad
    from scipy.special import gegenbauer

    K = ts._radial_norms(3, 1)
    np.testing.assert_allclose(K[0, 0], 1.0 / 3.0, rtol=1e-12)
    l, n = 1, 2
    C = gegenbauer(n, 2 * l + 1.5)
    dC = C.deriv()

    def phi(s):
        return -(s**l) / (1 + s) ** (2 * l + 1) * C((s - 1) / (s + 1))

    def dphi(s):
        xi = (s - 1) / (s + 1)
        base = s**l / (1 + s) ** (2 * l + 1)
        return -(base * (l / s - (2 * l + 1) / (1 + s)) * C(xi)
                 + base * dC(xi) * 2 / (1 + s) ** 2)

    val, _ = quad(lambda s: (dphi(s) ** 2
                             + l * (l + 1) * (phi(s) / s) ** 2) * s**2,
                  0, np.inf, limit=400)
    np.testing.assert_allclose(K[n, l], val, rtol=1e-9)


def test_biorthogonality_roundtrip_via_autograd_laplacian():
    """rho = lap(Phi) / 4 pi G by autograd (independent of the norm
    quadrature) projects back to the input coefficients."""
    nmax, lmax = 3, 2
    labels = tuple(_symmetry_labels(lmax, lmax, "none"))
    P = (nmax + 1) * (lmax + 1)
    K_flat = torch.tensor(ts._radial_norms(nmax, lmax).T.reshape(-1))
    mask = torch.tensor(ts._l_mask(nmax, lmax, labels), dtype=torch.float64)
    rng = np.random.default_rng(3)
    A_in = torch.tensor(rng.normal(0, 1, (P, len(labels)))) * mask
    pos_q, w = _quad_grid(n_r=80, n_th=32, n_ph=24)
    x = torch.tensor(pos_q, requires_grad=True)
    phi = ts._phi_of(x, A_in, 1.0, G, nmax, lmax, labels)
    (g,) = torch.autograd.grad(phi.sum(), x, create_graph=True)
    lap = sum(torch.autograd.grad(g[:, k].sum(), x, retain_graph=True)[0][:, k]
              for k in range(3))
    mq = (lap / (4 * np.pi * G)).detach() * torch.tensor(w)
    A_rec = ts.scf_coefficients(torch.tensor(pos_q), mq, 1.0, nmax, lmax,
                                labels, K_flat, mask)
    assert _rel(A_rec, A_in) < 1e-4


def test_hernquist_monopole_exact():
    rng = np.random.default_rng(0)
    N = 200_000
    u = rng.uniform(0, 1, N)
    s = np.clip(np.sqrt(u) / (1 - np.sqrt(u)), 0, 1e4)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a_true, M = 2.0, 1e9
    pos = (s * a_true)[:, None] * d
    solver = ts.SCFGravity(np.full(N, M / N), nmax=0, lmax=0, a=a_true, G=G,
                           precision="float64", **CPU)
    r_eval = np.geomspace(0.1, 50, 12)
    pts = np.column_stack([r_eval, np.zeros(12), np.zeros(12)])
    phi, acc = solver.field(pos, pts)
    assert np.abs(_np(phi) / (-G * M / (r_eval + a_true)) - 1).max() < 6e-3
    assert np.abs(_np(acc)[:, 0] / (-G * M / (r_eval + a_true) ** 2)
                  - 1).max() < 6e-3


def test_plummer_quadrature_convergence_ladder():
    M, ap = 1e9, 1.3
    pos, w = _quad_grid()
    m = w * 3 * M / (4 * np.pi * ap**3) * (
        1 + (np.linalg.norm(pos, axis=1) / ap) ** 2) ** -2.5
    pts_r = np.geomspace(0.05, 30, 16)
    pts = np.column_stack([pts_r * 0.6, pts_r * 0.48, pts_r * 0.64])
    rr = np.linalg.norm(pts, axis=1)
    phi_true = -G * M / np.sqrt(rr**2 + ap**2)
    acc_true = (-G * M * (rr**2 + ap**2) ** -1.5)[:, None] * pts
    errs = []
    for nmax in (2, 8, 16):
        sol = ts.SCFGravity(m, nmax=nmax, lmax=0, a=1.0, G=G,
                            precision="float64", **CPU)
        phi, acc = sol.field(pos, pts)
        errs.append((np.abs(_np(phi) / phi_true - 1).max(),
                     (np.linalg.norm(_np(acc) - acc_true, axis=1)
                      / np.linalg.norm(acc_true, axis=1)).max()))
    assert errs[0][0] > 30 * errs[1][0] > 900 * errs[2][0]
    assert errs[2][0] < 1e-6 and errs[2][1] < 1e-3


def test_flattened_needs_l_terms():
    rng = np.random.default_rng(1)
    N = 60_000
    u = rng.uniform(0, 1, N)
    s = np.clip(np.sqrt(u) / (1 - np.sqrt(u)), 0, 100)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = s[:, None] * d
    pos[:, 2] *= 0.5
    m = np.full(N, 1e9 / N)
    pts_r = np.geomspace(0.3, 8, 10)
    pts = np.column_stack([pts_r * 0.37, pts_r * 0.21, pts_r * 0.9])
    # the direct Plummer-law potential (h = 1e-6) at the 10 points only
    r2 = ((pts[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    phi_ref = -G * (m[None, :] / np.sqrt(r2 + 1e-12 + 1e-15)).sum(1)

    def field_err(lmax):
        sol = ts.SCFGravity(m, nmax=10, lmax=lmax, a=1.0, G=G,
                            precision="float64", symmetry="axisymmetric",
                            **CPU)
        return np.abs(_np(sol.field(pos, pts)[0]) / phi_ref - 1).max()

    e0, e4 = field_err(0), field_err(4)
    assert e4 < 0.5 * e0 and e4 < 0.02


def test_symmetry_and_com_options():
    rng = np.random.default_rng(2)
    pos = rng.normal(0, 1, (5000, 3))
    m = np.full(5000, 1e9 / 5000)
    assert ts.SCFGravity(m, nmax=4, lmax=4, a=1.0, G=G, symmetry="spherical",
                         **CPU).labels == ((0, 0),)
    sol2 = ts.SCFGravity(m, nmax=4, lmax=2, a=1.0, G=G, center="com", **CPU)
    a0 = _np(sol2.accel(torch.tensor(pos, dtype=torch.float32)))
    a1 = _np(sol2.accel(torch.tensor(pos + 37.5, dtype=torch.float32)))
    np.testing.assert_allclose(a1, a0, atol=1e-3 * np.abs(a0).max())
    sol3 = ts.SCFGravity(m, nmax=2, lmax=0, G=G,
                         phase_space=np.hstack([pos, 0 * pos]), **CPU)
    np.testing.assert_allclose(
        sol3.a, np.median(np.linalg.norm(pos, axis=1)), rtol=1e-12)
    with pytest.raises(ValueError, match="phase_space"):
        ts.SCFGravity(m, nmax=2, lmax=0, G=G, **CPU)


def test_run_simulation_scf_end_to_end(tmp_path):
    xv, m = tst.make_plummer_sphere(4000, 1e9, 1.0, seed=7)
    sp = [tst.Species(name="dark", N=4000, mass=float(m[0]), softening=0.05)]
    out = tst.run_simulation(xv, sp, 0.0, 0.01, 1e-4, architecture="cpu",
                             method="scf", scf_nmax=6, scf_lmax=2,
                             output_dir=str(tmp_path), save_snapshots=False,
                             debug_energy=True, verbose=False)
    assert out["dark"].shape == (4000, 6)
    sol = ts.SCFGravity(m, nmax=6, lmax=2, a=1.0, G=G, precision="float64",
                        **CPU)

    def energy(arr):
        phi = _np(sol.potential(torch.tensor(arr[:, :3])))
        return (0.5 * (m * (arr[:, 3:] ** 2).sum(1)).sum()
                + 0.5 * (m * phi).sum())

    e0, e1 = energy(xv), energy(out["dark"])
    assert abs((e1 - e0) / e0) < 1e-4


def test_scf_momentum_near_conservation():
    xv, m = tst.make_plummer_sphere(20000, 1e9, 1.0, seed=9)
    sol = ts.SCFGravity(m, nmax=8, lmax=4, a=1.0, G=G, precision="float64",
                        **CPU)
    acc = _np(sol.accel(torch.tensor(xv[:, :3])))
    net = np.abs((m[:, None] * acc).sum(0)).max()
    assert net < 2e-3 * np.abs(m[:, None] * acc).sum(0).max()


def _hernquist_sample(rng, n, a, m_tot, center):
    u = rng.uniform(0, 1, n)
    s = np.clip(np.sqrt(u) / (1 - np.sqrt(u)), 0, 50)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return a * s[:, None] * d + np.asarray(center), np.full(n, m_tot / n)


def _plummer_direct(pos, m, h=1e-6):
    """Float64 direct sums of the Plummer law (softening h, eps2 = 1e-15,
    self pair left out): (accelerations, potential), in blocks of 1024
    targets."""
    xs = [torch.tensor(np.ascontiguousarray(pos[:, k])) for k in range(3)]
    mm = torch.tensor(m)
    acc, phi = [], []
    for i0 in range(0, len(pos), 1024):
        d = [x[None, :] - x[i0:i0 + 1024, None] for x in xs]
        inv = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
               + (1e-15 + h * h)).rsqrt_()
        w = mm * inv
        rows = torch.arange(w.shape[0])
        w[rows, rows + i0] = 0.0
        phi.append(-G * w.sum(1))
        w.mul_(inv).mul_(inv)
        acc.append(G * torch.stack([(w * dk).sum(1) for dk in d], 1))
    return torch.cat(acc).numpy(), torch.cat(phi).numpy()


def _median_rel_force_err(acc, acc_ref, sel=slice(None)):
    num = np.linalg.norm(_np(acc)[sel] - acc_ref[sel], axis=1)
    return float(np.median(num / np.linalg.norm(acc_ref[sel], axis=1)))


@pytest.mark.parametrize("case", ["lmc", "progenitor"])
def test_composite_restores_accuracy(case):
    """Two-centre geometry: the single-centre expansion leaves the 1-5%
    class on the satellite's particles, the composite at the same
    truncation restores it (MW+LMC-like 10:1 at 8 a; a 1:100
    progenitor clump at 5 a)."""
    rng = np.random.default_rng(11 if case == "lmc" else 12)
    n_mw, n_sat, ratio, d_sat, a_sat, tol = (
        (12000, 4000, 0.1, 8.0, 0.3, 0.055) if case == "lmc"
        else (12000, 3000, 0.01, 5.0, 0.1, 0.07))
    p1, m1 = _hernquist_sample(rng, n_mw, 1.0, 1e9, (0, 0, 0))
    p2, m2 = _hernquist_sample(rng, n_sat, a_sat, ratio * 1e9, (d_sat, 0, 0))
    pos, m = np.vstack([p1, p2]), np.concatenate([m1, m2])
    pt = torch.tensor(pos)
    acc_ref, phi_ref = _plummer_direct(pos, m)
    sat = slice(n_mw, None)
    single = ts.SCFGravity(m, nmax=8, lmax=4, a=1.0, G=G,
                           precision="float64", **CPU)
    assert _median_rel_force_err(single.accel(pt), acc_ref, sat) > 0.05
    comp = ts.CompositeSCFGravity(
        m, groups=[(slice(0, n_mw), {"a": 1.0}),
                   (sat, {"a": a_sat, "center": "com"})],
        G=G, precision="float64", nmax=8, lmax=4, **CPU)
    acc_c = comp.accel(pt)
    assert _median_rel_force_err(acc_c, acc_ref, sat) < tol
    if case == "lmc":
        assert _median_rel_force_err(acc_c, acc_ref) < 0.05
        phi = _np(comp.potential(pt))
        assert float(np.median(np.abs(phi / phi_ref - 1))) < 0.02


@pytest.mark.parametrize("groups,match", [
    ([(slice(0, 60), {"a": 1.0}), (slice(50, 100), {"a": 1.0})], "overlap"),
    ([(slice(0, 60), {"a": 1.0})], "no group"),
    ([(slice(0, 0), {"a": 1.0}), (slice(0, 100), {"a": 1.0})],
     "no particles")])
def test_composite_group_validation(groups, match):
    ps = np.random.default_rng(0).normal(size=(100, 6))
    with pytest.raises(ValueError, match=match):
        ts.CompositeSCFGravity(np.full(100, 1.0), groups=groups,
                               phase_space=ps, **CPU)


def test_run_simulation_scf_groups_end_to_end(tmp_path):
    xv_mw, m_mw = tst.make_plummer_sphere(3000, 1e9, 1.0, seed=5)
    xv_sat, m_sat = tst.make_plummer_sphere(1000, 1e8, 0.3, seed=6)
    xv_sat[:, 0] += 6.0
    xv_sat[:, 4] += 150.0
    xv = np.concatenate([xv_mw, xv_sat])
    sp = [tst.Species(name="mw", N=3000, mass=m_mw, softening=0.05),
          tst.Species(name="sat", N=1000, mass=m_sat, softening=0.05)]
    out = tst.run_simulation(
        xv, sp, 0.0, 5e-3, 1e-4, architecture="cpu", method="scf",
        scf_nmax=4, scf_lmax=2,
        scf_groups={"mw": {"a": 1.0}, "sat": {"a": 0.3, "center": "com"}},
        output_dir=str(tmp_path), save_snapshots=False, verbose=False)
    assert out["mw"].shape == (3000, 6) and out["sat"].shape == (1000, 6)
    assert np.isfinite(out["sat"]).all()
    com = out["sat"][:, :3].mean(0)
    assert np.median(np.linalg.norm(out["sat"][:, :3] - com, axis=1)) < 2.0


def test_scf_benchmark_needs_the_card():
    """benchmarks.scf times the card and refuses to run without one."""
    from nbody_streams_tpu_torch.benchmarks import scf as bench

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (bench.run_speed, bench.run_ladder, bench.run_drift):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
