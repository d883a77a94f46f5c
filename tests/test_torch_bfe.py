"""The port's BFE stack against the JAX package's, on the CPU: coefs, io,
multipole, cylspline, load, fire and fit (GalPot, MW+LMC and the stacked
evolving paths are in test_torch_fields.py).

Inputs are made from a seed with numpy (or read from ``tests/data`` and
the packages' data directories) and go through both packages.
Tolerances (max |port - JAX| / max |JAX|): built tables equal; float64
potential, force and Hessian 1e-10; float32 port vs float32 JAX 1e-5 of
max |F|, except for the CylSpline: the JAX package's own float32 force
near its centre is further than that from its float64, so there the
port's float32 is held to float64 within 2e-5 of max |F|, and below the
JAX package's own float32 error.  The CylSpline fit's grid runs through the
two-set potential kernel's plain version in float32 with Kahan; the JAX
package's CPU path sums in float64, so its tables agree to 2e-6 of
max |Phi|.
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


def _fp32(build_jax, port, x, t=0.0):
    """(port float32 force, JAX float32 force, JAX float64 force)."""
    x32 = x.astype(np.float32)
    with jax.enable_x64(False):
        pot = build_jax()
        fj = np.asarray(jax.jit(lambda q: pot.force(q, t))(
            jnp.asarray(x32)))
    f64 = _jax_evals(build_jax(), x32.astype(np.float64), (t,))[0][1]
    ft = copy.deepcopy(port).to(torch.float32).force(torch.tensor(x32), t)
    assert ft.dtype == torch.float32 and torch.isfinite(ft).all()
    assert fj.dtype == np.float32 and np.isfinite(fj).all()
    return _np(ft), fj, f64


# ---------------------------------------------------------------------------
# coefs / io
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MULT + [CYL])
def test_coefs_parse_and_serialise_as_jax(name):
    jc, tc = J.read_coefs(FIX / name), T.read_coefs(FIX / name)
    assert type(tc).__name__ == type(jc).__name__
    np.testing.assert_array_equal(np.asarray(tc.phi), np.asarray(jc.phi))
    assert tc.to_coef_string() == jc.to_coef_string()
    if name in MULT:
        assert tc.lm_labels == jc.lm_labels
        keep = [(0, 0), (2, 0), (2, 2)]
        np.testing.assert_array_equal(tc.zeroed(keep).phi,
                                      jc.zeroed(keep).phi)
    else:
        np.testing.assert_array_equal(tc.zeroed([0, 2]).phi,
                                      jc.zeroed([0, 2]).phi)


def test_h5_archives_cross_read(tmp_path):
    """Archives written by either package read back in the other."""
    pytest.importorskip("h5py")
    strings = [(FIX / n).read_text() for n in MULT]
    T.write_snapshot_coefs_to_h5(tmp_path / "t.h5", strings, [0.0, 1.0])
    J.write_snapshot_coefs_to_h5(tmp_path / "j.h5", strings, [0.0, 1.0])
    for f in ("t.h5", "j.h5"):
        for g in ("snap_000", "snap_001"):
            assert (J.read_coef_string(tmp_path / f, g)
                    == T.read_coef_string(tmp_path / f, g))
    T.write_coef_to_h5(tmp_path / "one.h5", strings[1], "g")
    assert J.read_coef_string(tmp_path / "one.h5", "g") == strings[1]


# ---------------------------------------------------------------------------
# multipole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MULT)
def test_multipole_matches_jax(name, pts):
    jp, tp = J.MultipolePotential(FIX / name), T.MultipolePotential(FIX / name)
    assert tp.labels == jp.labels and tp._i_log == jp._i_log
    assert tp._mono == jp._mono
    for k in ("x_grid", "coeffs", "f_in", "v_in", "f_out", "v_out"):
        np.testing.assert_array_equal(_np(getattr(tp, k)),
                                      np.asarray(getattr(jp, k)))
    # grid nodes, inside and beyond the grid, and the radial extremes
    r = np.asarray(tp.coefs.R_grid)
    x = np.concatenate([pts, np.column_stack([r, 0 * r, 0 * r]),
                        [[1e-4, 0, 0], [3e3, 1e3, 0]]])
    _assert_parity(tp, jp, x, hess=name == MULT[0])
    ft, fj, _ = _fp32(lambda: J.MultipolePotential(FIX / name), tp, x)
    assert _rel(ft, fj) < 1e-5


@pytest.mark.parametrize("name", MULT)
def test_multipole_fp32_origin_axis_and_extremes(name):
    """float32 at the origin, on the z-axis, at r = 1e-6 and r = 1e6 (the
    monopole's exponent guard): finite, and equal to the JAX package's
    float32 within 1e-5 of max |F|."""
    x = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 3.0], [0.0, 0.0, -40.0],
                  [1e-6, 0.0, 0.0], [0.0, 0.0, 1e-6], [1e6, 0.0, 0.0],
                  [0.0, 0.0, 1e6], [5.0, 1.0, -2.0]])
    tp = T.MultipolePotential(FIX / name)
    ft, fj, _ = _fp32(lambda: J.MultipolePotential(FIX / name), tp, x)
    assert _rel(ft, fj) < 1e-5
    phi = copy.deepcopy(tp).to(torch.float32).potential(
        torch.tensor(x, dtype=torch.float32))
    assert torch.isfinite(phi).all()


def test_multipole_state_dict_carries_jax_tables(pts):
    """load_state_dict of a JAX Multipole's arrays into a port module
    built from other tables on the same grid and labels: the port then
    evaluates as the JAX one does."""
    c = J.read_coefs(FIX / MULT[1])
    other = T.read_coefs(FIX / MULT[1])
    other.phi = np.asarray(other.phi) * 1.7
    other.dphi_dr = np.asarray(other.dphi_dr) * 1.7
    jp = J.MultipolePotential(c, monopole_scaling=False)
    tp = T.MultipolePotential(other, monopole_scaling=False)
    state = {k: torch.tensor(np.asarray(getattr(jp, k)))
             for k in tp.state_dict()}
    assert set(state) == {"x_grid", "coeffs", "f_in", "v_in", "f_out",
                          "v_out"}
    tp.load_state_dict(state)
    _assert_parity(tp, jp, pts)


def test_multipole_from_projection_matches_jax(pts):
    jn = J.NFWPotential(mass=1e12, scaleRadius=20.0)
    tn = T.NFWPotential(mass=1e12, scaleRadius=20.0)
    r = np.geomspace(0.1, 200.0, 30)
    jp = J.MultipolePotential.from_projection(
        lambda p: jn.potential(p), r, lmax=2)
    tp = T.MultipolePotential.from_projection(
        lambda p: _np(tn.potential(p)), r, lmax=2)
    _assert_parity(tp, jp, pts)


@pytest.mark.parametrize("name", MULT + [CYL])
def test_fixture_force_is_minus_grad_phi(name):
    cls = T.CylSplinePotential if name == CYL else T.MultipolePotential
    pot = cls(FIX / name)
    h = 1e-4
    for p in np.array([[2.0, 0.0, 0.0], [10.0, 5.0, 3.0], [0.5, 0.5, 0.5]]):
        f = _np(pot.force(p[None]))[0]
        fd = np.array([-(float(pot.potential((p + d)[None])[0])
                         - float(pot.potential((p - d)[None])[0])) / (2 * h)
                       for d in np.eye(3) * h])
        np.testing.assert_allclose(f, fd, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("name", MULT + [CYL])
def test_fixture_far_field_and_boundary_continuity(name):
    cls = T.CylSplinePotential if name == CYL else T.MultipolePotential
    pot = cls(FIX / name)
    r = np.array([300.0, 1000.0, 3000.0])
    gm = -_np(pot.potential(np.column_stack([r * 0.8, r * 0.36,
                                             r * 0.48]))) * r
    assert np.all(gm > 0) and gm[2] / gm[1] < 2.0
    r_edge = float(np.asarray(pot.coefs.R_grid).max())
    lo = float(pot.potential([[r_edge * 0.999, 0.0, 0.0]])[0])
    hi = float(pot.potential([[r_edge * 1.001, 0.0, 0.0]])[0])
    assert hi == pytest.approx(lo, rel=5e-3)


# ---------------------------------------------------------------------------
# cylspline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cyl():
    return J.CylSplinePotential(FIX / CYL), T.CylSplinePotential(FIX / CYL)


def test_cylspline_matches_jax(cyl, pts):
    jp, tp = cyl
    assert tp.m_vals == jp.m_vals and tp.outer_labels == jp.outer_labels
    assert tp.rscale == jp.rscale
    for k in ("lr_grid", "lz_grid", "nodes"):
        np.testing.assert_array_equal(_np(getattr(tp, k)),
                                      np.asarray(getattr(jp, k)))
    # outer_w is a least-squares fit on samples of each package's own
    # interior evaluator: equal to rounding
    assert _rel(tp.outer_w, jp.outer_w) < 1e-9
    # grid nodes in the plane and on the walls: the where-clamp keeps the
    # whole gradient at exact ties
    c = tp.coefs
    R, z = np.asarray(c.R_grid), np.asarray(c.z_grid)
    nodes = np.array([[R[i], 0.0, z[j]] for i in (1, 5, len(R) - 1)
                      for j in (0, len(z) // 2, len(z) - 1)])
    _assert_parity(tp, jp, np.concatenate([pts, nodes]))


def test_cylspline_fp32(cyl, pts):
    """float32, with the origin and z-axis points: finite, and within
    2e-5 of max |F| of float64.  The JAX package's own float32 is further
    from float64 than 1e-5 here (its Hermite sums cancel ~12-sized
    log|Phi_0| terms); the port's corner-relative sums do not, so it must
    stay below the JAX package's own error too."""
    jp, tp = cyl
    x = np.concatenate([[[0.0, 0.0, 0.0], [0.0, 0.0, 2.0],
                         [0.0, 0.0, -30.0]], pts])
    ft, fj, f64 = _fp32(lambda: J.CylSplinePotential(FIX / CYL), tp, x)
    own = _rel(fj, f64)
    assert 1e-5 < own < 1e-3
    assert _rel(ft, f64) < min(2e-5, own)


def test_cylspline_m1_harmonic_axis_derivative():
    """|m| = 1 harmonics keep their radial slope on the axis: the port's
    CylSpline of an off-centre Plummer against the exact field and the
    JAX package's evaluator."""
    shift = 1.5

    def phi_exact(p):
        q = np.array(p, float)
        q[:, 0] -= shift
        return -4.300917270069976e-06 * 1e10 / np.sqrt((q ** 2).sum(1) + 4)

    r_grid = np.concatenate([[0.0], np.geomspace(0.05, 60.0, 40)])
    zp = np.geomspace(0.05, 60.0, 14)
    z_grid = np.concatenate([-zp[::-1], [0.0], zp])
    mmax, n_phi = 4, 16
    ang = 2.0 * np.pi * np.arange(n_phi) / n_phi
    rr, zz, aa = np.meshgrid(r_grid, z_grid, ang, indexing="ij")
    p = np.column_stack([(rr * np.cos(aa)).ravel(),
                         (rr * np.sin(aa)).ravel(), zz.ravel()])
    spec = np.fft.rfft(phi_exact(p).reshape(rr.shape), axis=2) / n_phi
    tables = [spec[:, :, 0].real] + [
        (1.0 if 2 * m == n_phi else 2.0) * spec[:, :, m].real
        for m in range(1, mmax + 1)]
    args = dict(R_grid=r_grid, z_grid=z_grid,
                m_values=list(range(mmax + 1)), phi=np.stack(tables))
    tp = T.CylSplinePotential(T.CylSplineCoefs(**args))
    jp = J.CylSplinePotential(J.CylSplineCoefs(**args))
    probe = np.array([[0.01, 0.0, 1.0], [0.03, 0.02, -2.0],
                      [0.02, -0.01, 0.5], [0.04, 0.0, 3.0], [0.0, 0.0, 1.0]])
    _assert_parity(tp, jp, probe, hess=True)
    ref = phi_exact(probe)
    assert _rel(tp.potential(probe), ref) < 2e-4


# ---------------------------------------------------------------------------
# load / fire
# ---------------------------------------------------------------------------

def test_load_forms_match_jax(pts, tmp_path):
    pytest.importorskip("h5py")
    strings = [(FIX / n).read_text() for n in MULT]
    J.write_snapshot_coefs_to_h5(tmp_path / "a.h5", strings, [0.0, 1.0])
    traj = np.array([[0.0, 1.0, 0.0, 0.0], [1.0, 2.0, 0.5, 0.0],
                     [2.0, 3.0, 0.0, 1.0]])
    cases = [
        lambda P, **kw: P.load_potential(tmp_path / "a.h5", "snap_001",
                                         center=[1.0, -2.0, 0.5],
                                         keep_lm_mult=[(0, 0), (2, 0)], **kw),
        lambda P, **kw: P.load_agama_potential(FIX / MULT[1],
                                               keep_lm_mult=[0, 2], **kw),
        lambda P, **kw: P.load_evolving_potential(tmp_path / "a.h5",
                                                  center=traj, **kw),
        lambda P, **kw: P.load_agama_evolving_potential(
            tmp_path / "a.h5", keep_lm_mult=[0, 1], **kw),
    ]
    for make in cases:
        _assert_parity(make(T, device="cpu"), make(J), pts[:32], (0.4,))
        # the card is the default: without one the loader raises
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(T)
    with pytest.raises(FileNotFoundError):
        T.load_potential(tmp_path / "missing.h5", device="cpu")


@pytest.fixture()
def fire_dir(tmp_path):
    pot = tmp_path / "sim" / "potential" / "10kpc"
    pot.mkdir(parents=True)
    for name in ("600.dark.none_8.coef_mul_DR", CYL):
        shutil.copy(FIX / name, pot / name)
    (tmp_path / "sim" / "snapshot_times.txt").write_text(
        "# i scale z time lookback\n0 0.1 9.0 0.5 13.3\n"
        "300 0.5 1.0 5.9 7.9\n600 1.0 0.0 13.8 0.0\n")
    return tmp_path / "sim"


def test_fire_loaders_match_jax(fire_dir, pts):
    for kw in (dict(keep_lm_mult=[(0, 0), (1, 1)], keep_m_cylspl=[0, 2]),
               dict(kind="dark")):
        tp = T.load_fire_pot(fire_dir, 600, lmax=8, verbose=False,
                             device="cpu", **kw)
        jp = J.load_fire_pot(fire_dir, 600, lmax=8, verbose=False, **kw)
        _assert_parity(tp, jp, pts[:32])
    st_t, st_j = (P.read_snapshot_times(fire_dir) for P in (T, J))
    for k in st_j:
        np.testing.assert_array_equal(st_t[k], st_j[k])
    a = T.create_fire_evolving_ini(fire_dir, [0, 600],
                                   filename=fire_dir / "t.ini")
    b = J.create_fire_evolving_ini(fire_dir, [0, 600],
                                   filename=fire_dir / "j.ini")
    assert Path(a).read_text() == Path(b).read_text()
    with pytest.raises(FileNotFoundError):
        T.load_fire_pot(fire_dir, 601, verbose=False)


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    xv, m = make_plummer_sphere(2048, M_total=1e9, a=1.0, seed=11)
    return xv[:, :3], m


def test_fit_multipole_equals_jax(cluster):
    pos, m = cluster
    for kw in (dict(lmax=4), dict(lmax=4, symmetry="axisym"),
               dict(lmax=2, center=[0.1, 0.0, -0.1])):
        tc = T.fit_multipole_from_particles(pos, m, **kw)
        jc = J.fit_multipole_from_particles(pos, m, **kw)
        assert tc.lm_labels == jc.lm_labels
        np.testing.assert_array_equal(tc.phi, jc.phi)
        np.testing.assert_array_equal(tc.dphi_dr, jc.dphi_dr)


def test_fit_cylspline_plain_kernel_matches_jax(cluster, pts):
    """The grid through the two-set potential kernel's plain version
    (float32, Kahan): tables within 2e-6 of max |Phi| of the JAX
    package's float64 CPU sum, for plummer and newtonian pairs."""
    pos, m = cluster
    for soft in (0.0, 0.05):
        kw = dict(mmax=2, softening=soft)
        tc = T.fit_cylspline_from_particles(pos, m, device="cpu", **kw)
        jc = J.fit_cylspline_from_particles(pos, m, **kw)
        np.testing.assert_array_equal(tc.R_grid, jc.R_grid)
        np.testing.assert_array_equal(tc.z_grid, jc.z_grid)
        assert tc.m_values == jc.m_values
        assert _rel(tc.phi, jc.phi) < 2e-6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.fit_cylspline_from_particles(pos, m, mmax=2)


def test_fit_potential_driver_matches_jax(cluster):
    pos, m = cluster
    snap = T.create_snapshot_dict(pos[:1024], m[:1024], pos[1024:],
                                  m[1024:])
    res_t = T.fit_potential(snap, lmax=2, mmax_cyl=2, device="cpu")
    res_j = J.fit_potential(snap, lmax=2, mmax_cyl=2)
    np.testing.assert_array_equal(res_t["multipole"].phi,
                                  res_j["multipole"].phi)
    assert _rel(res_t["cylspline"].phi, res_j["cylspline"].phi) < 2e-6
    x = np.array([[2.0, 0.0, 0.0], [0.5, 0.3, -0.2]])
    assert _rel(res_t["potential"].potential(x),
                res_j["potential"].potential(x)) < 1e-5
