"""The port's potentials against the JAX package's, on the CPU: interp,
base, analytic, modifiers and factory/INI (the BFE modules, GalPot and
MW+LMC are in test_torch_bfe.py).

Inputs are made from a seed with numpy and go through both packages.
Tolerances (max |port - JAX| / max |JAX|): float64 1e-12 for the analytic
forms and 1e-10 for everything built on tables (potential, force and
Hessian); float32 port vs float32 JAX 1e-5 of max |F|.  The JAX package
runs with x64 on (tests/conftest.py); its float32 side is built and run
under ``jax.enable_x64(False)``, the port's is ``.to(torch.float32)``.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_streams_tpu.potentials as J
import nbody_streams_tpu_torch.potentials as T
from nbody_streams_tpu.utils import interp as jinterp
from nbody_streams_tpu_torch.utils import interp as tinterp

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
JDATA = ROOT / "nbody_streams_tpu" / "data" / "potentials"
TDATA = ROOT / "nbody_streams_tpu_torch" / "data" / "potentials"

ANALYTIC = [
    ("NFW", dict(mass=1e12, scaleRadius=20.0)),
    ("Plummer", dict(mass=1e11, scaleRadius=5.0)),
    ("Hernquist", dict(mass=5e10, scaleRadius=2.0)),
    ("Dehnen", dict(mass=5e10, scaleRadius=2.0, gamma=0.5)),
    ("Dehnen", dict(mass=5e10, scaleRadius=2.0, gamma=2.0)),
    ("Isochrone", dict(mass=1e10, scaleRadius=1.5)),
    ("MiyamotoNagai", dict(mass=6e10, scaleRadius=3.0, scaleHeight=0.3)),
    ("LogHalo", dict(velocity=200.0, coreRadius=1.0, axisRatioY=0.9,
                     axisRatioZ=0.8)),
    ("DiskAnsatz", dict(surfaceDensity=1e9, scaleRadius=3.0,
                        scaleHeight=0.3)),
    ("DiskAnsatz", dict(surfaceDensity=1e9, scaleRadius=3.0,
                        scaleHeight=-0.3, innerCutoffRadius=2.0)),
    ("DiskAnsatz", dict(surfaceDensity=1e9, scaleRadius=3.0,
                        scaleHeight=0.0)),
    ("UniformAcceleration", dict(ax=10.0, ay=-3.0, az=2.0)),
]
IDS = [f"{k}{i}" for i, (k, _) in enumerate(ANALYTIC)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, want):
    got, want = _np(got).astype(float), _np(want).astype(float)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(7)
    x = rng.normal(0.0, 15.0, (64, 3))
    x[:3] = [[3.0, 0.0, 0.0], [0.0, 0.0, 4.0], [1.0, -2.0, 0.5]]
    return x


def _evals(pot, x, t=0.0, hess=True):
    """(phi, force[, -hess6]) of either package on an (N, 3) array."""
    out = [pot.potential(x, t), pot.force(x, t)]
    if hess:
        out.append(pot.forceDeriv(x, t)[1])
    return tuple(_np(v) for v in out)


# ---------------------------------------------------------------------------
# interp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["spline", "hermite", "pchip", "const"])
@pytest.mark.parametrize("extrapolate", ["clamp", "linear"])
def test_ppoly_matches_jax(kind, extrapolate):
    rng = np.random.default_rng(3)
    times = np.sort(rng.uniform(-2.0, 2.0, 9))
    vals = rng.normal(size=(9, 3))
    der = rng.normal(size=(9, 3))
    if kind == "const":
        times, vals = times[:1], vals[:1]
    args = {"spline": (times, vals), "hermite": (times, vals, der),
            "pchip": (times, vals[:, 0]), "const": (times, vals)}[kind]
    fn = {"spline": "spline_coeffs", "hermite": "hermite_coeffs",
          "pchip": "pchip_coeffs", "const": "spline_coeffs"}[kind]
    jp = getattr(jinterp, fn)(*args, extrapolate=extrapolate)
    tp = getattr(tinterp, fn)(*args, extrapolate=extrapolate)
    np.testing.assert_array_equal(_np(tp.x), np.asarray(jp.x))
    np.testing.assert_array_equal(_np(tp.c), np.asarray(jp.c))
    tq = np.concatenate([rng.uniform(-3.0, 3.0, 20), times])
    want, dwant = np.asarray(jp(tq)), np.asarray(jp.derivative_at(tq))
    # batched (tensor t) and host (Python float t) evaluation
    assert _rel(tp(torch.tensor(tq)), want) < 1e-12
    assert _rel(tp.derivative_at(torch.tensor(tq)), dwant) < 1e-12
    host = np.stack([_np(tp(float(t))) for t in tq])
    dhost = np.stack([_np(tp.derivative_at(float(t))) for t in tq])
    assert _rel(host, want) < 1e-12 and _rel(dhost, dwant) < 1e-12


@pytest.mark.parametrize("kind", ["hermite", "pchip"])
@pytest.mark.parametrize("extrapolate", ["clamp", "linear"])
def test_ppoly_zero_dim_time_reads_nothing_back(kind, extrapolate):
    """A 0-dim tensor time (the friction's CUDA graph passes its time so)
    takes the batched path with the host form's shape and values, and
    reads nothing back: on the meta device a read back raises."""
    rng = np.random.default_rng(4)
    times = np.sort(rng.uniform(-2.0, 2.0, 9))
    vals, der = rng.normal(size=(9, 3)), rng.normal(size=(9, 3))

    def make():
        if kind == "pchip":
            return tinterp.pchip_coeffs(times, vals[:, 0],
                                        extrapolate=extrapolate)
        return tinterp.hermite_coeffs(times, vals, der,
                                      extrapolate=extrapolate)

    tp = make()
    for t in np.concatenate([[-3.0, 3.0], times, rng.uniform(-2, 2, 5)]):
        for f in (tp, tp.derivative_at):
            got, want = f(torch.tensor(t)), f(float(t))
            assert got.shape == want.shape
            assert _rel(got, want) < 1e-12
    meta = make().to("meta")
    t = torch.tensor(0.5, dtype=torch.float64, device="meta")
    assert meta(t).shape == meta.derivative_at(t).shape == tp(0.5).shape


# ---------------------------------------------------------------------------
# analytic + base
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", ANALYTIC, ids=IDS)
def test_analytic_matches_jax_fp64(kind, kw, pts):
    jp, tp = J.AnalyticPotential(kind, **kw), T.AnalyticPotential(kind, **kw)
    for got, want in zip(_evals(tp, torch.tensor(pts)), _evals(jp, pts)):
        assert got.dtype == np.float64
        assert _rel(got, want) < 1e-12
    rho_j, rho_t = np.asarray(jp.density(pts)), _np(tp.density(pts))
    assert _rel(rho_t, rho_j) < 1e-10


@pytest.mark.parametrize("kind,kw", ANALYTIC, ids=IDS)
def test_analytic_matches_jax_fp32(kind, kw, pts):
    """float32 on both sides, with the origin and z-axis points: finite
    and within 1e-5 of max |F|."""
    x = np.concatenate([[[0.0, 0.0, 0.0], [0.0, 0.0, 2.0],
                         [0.0, 0.0, -7.0]], pts]).astype(np.float32)
    with jax.enable_x64(False):
        jp = J.AnalyticPotential(kind, **kw)
        fj = np.asarray(jp.force(jnp.asarray(x)))
        pj = np.asarray(jp.potential(jnp.asarray(x)))
    tp = T.AnalyticPotential(kind, **kw).to(torch.float32)
    ft = tp.force(torch.tensor(x))
    assert ft.dtype == torch.float32 and torch.isfinite(ft).all()
    assert fj.dtype == np.float32
    assert _rel(ft, fj) < 1e-5
    assert _rel(tp.potential(torch.tensor(x)), pj) < 1e-5


def test_prep_shapes_and_promotion():
    """The JAX rules: (..., 3) flattened and restored, a single (3,)
    point gives scalars, integer input goes to the default float."""
    p = T.PlummerPotential(mass=1e11, scaleRadius=5.0)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 5, (4, 5, 3))
    assert tuple(p.potential(x).shape) == (4, 5)
    assert tuple(p.force(x).shape) == (4, 5, 3)
    assert tuple(p.forceDeriv(x)[1].shape) == (4, 5, 6)
    assert p.potential(x[0, 0]).ndim == 0
    assert tuple(p.force(x[0, 0]).shape) == (3,)
    assert p.potential([8, 0, 0]).dtype == torch.get_default_dtype()
    with pytest.raises(ValueError, match="positions"):
        p.potential(np.zeros((4, 2)))


def test_eval_name_clash():
    """Agama's eval(xyz, pot=, acc=, der=) and nn.Module.eval() share a
    name: with positions it evaluates, with none it is Module.eval."""
    jp = J.MiyamotoNagaiPotential(mass=6e10, scaleRadius=3.0)
    tp = T.MiyamotoNagaiPotential(mass=6e10, scaleRadius=3.0)
    x = np.random.default_rng(2).normal(0, 5, (16, 3))
    tp.train()
    assert tp.eval() is tp and tp.training is False
    for kw in (dict(pot=True), dict(acc=True), dict(der=True),
               dict(pot=True, acc=True, der=True)):
        got, want = tp.eval(x, **kw), jp.eval(x, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _rel(g, w) < 1e-12
    phi, f, d = tp.evalDeriv(x)
    assert _rel(phi, jp.potential(x)) < 1e-12
    assert _rel(d, jp.forceDeriv(x)[1]) < 1e-12
    with pytest.raises(ValueError, match="positions"):
        tp.eval(pot=True)
    with pytest.raises(ValueError, match="at least one"):
        tp.eval(x)


def test_composition_and_force_is_minus_grad(pts):
    a = T.PlummerPotential(mass=1e11, scaleRadius=5.0)
    b = T.NFWPotential(mass=1e12, scaleRadius=20.0)
    c = T.MiyamotoNagaiPotential(mass=6e10, scaleRadius=3.0)
    tot = a + b + c
    assert isinstance(tot, T.CompositePotential) and len(tot) == 3
    assert isinstance(sum([a, b]), T.CompositePotential)
    x = torch.tensor(pts)
    want = a.potential(x) + b.potential(x) + c.potential(x)
    assert _rel(tot.potential(x), want) < 1e-14
    # force = -grad phi by central differences
    h = 1e-4
    f = _np(tot.force(x))
    for k in range(3):
        d = torch.zeros(3, dtype=torch.float64)
        d[k] = h
        fd = -(_np(tot.potential(x + d)) - _np(tot.potential(x - d))) / (2 * h)
        assert np.abs(f[:, k] - fd).max() < 1e-5 * np.abs(f).max()


def test_analytic_factory_and_loghalo_kwargs():
    p = T.AnalyticPotential(type="dehnen_sph", mass=1e10, scaleRadius=1.0)
    assert isinstance(p, T.DehnenPotential)
    with pytest.raises(ValueError, match="Unknown analytic"):
        T.AnalyticPotential(type="nope")
    with pytest.raises(TypeError):
        T.LogHaloPotential(velocity=200.0, bogus=1.0)
    # the reference's *GPU names: the same constructors, built on the card
    # unless the caller asks for the CPU
    assert T.PotentialGPU is T.make_potential
    assert issubclass(T.NFWPotentialGPU, T.NFWPotential)
    x = np.array([[3.0, -1.0, 2.0], [40.0, 5.0, 0.0]])
    gpu = T.NFWPotentialGPU(mass=1e12, scaleRadius=20.0, device="cpu")
    np.testing.assert_array_equal(
        _np(gpu.force(x)),
        _np(T.NFWPotential(mass=1e12, scaleRadius=20.0).force(x)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.NFWPotentialGPU(mass=1e12, scaleRadius=20.0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.PotentialGPU(type="NFW", mass=1e12, scaleRadius=20.0)


def test_module_moves_its_tables():
    """Tables are buffers: .to() changes their dtype, and evaluation runs
    in the dtype of the positions whatever the tables'."""
    t = np.linspace(0.0, 1.0, 11)
    traj = np.column_stack([t, 10 * t, 0 * t, 0 * t])
    p = T.ShiftedPotential(T.PlummerPotential(mass=1e11), traj)
    p.to(torch.float32)
    assert p.traj.c.dtype == torch.float32
    x = np.random.default_rng(0).normal(0, 5, (8, 3))
    assert p.force(x.astype(np.float32), 0.3).dtype == torch.float32
    assert p.force(x, 0.3).dtype == torch.float64


# ---------------------------------------------------------------------------
# modifiers
# ---------------------------------------------------------------------------

def _traj(cols):
    t = np.linspace(-1.0, 1.0, 9)
    rng = np.random.default_rng(4)
    tab = np.column_stack([t] + [np.cumsum(rng.normal(0, 2, 9))
                                 for _ in range(cols - 1)])
    return tab[::-1]                     # unsorted on purpose


@pytest.mark.parametrize("center", ["static", "t4", "t7", "one_row"])
def test_shifted_matches_jax(center, pts):
    c = {"static": np.array([10.0, -5.0, 3.0]), "t4": _traj(4),
         "t7": _traj(7), "one_row": _traj(7)[:1]}[center]
    jp = J.ShiftedPotential(J.PlummerPotential(mass=1e11, scaleRadius=5.0),
                            c)
    tp = T.ShiftedPotential(T.PlummerPotential(mass=1e11, scaleRadius=5.0),
                            c)
    assert tp.time_dependent == jp.time_dependent
    for t in (-2.0, -0.37, 3.0):
        for got, want in zip(_evals(tp, pts, t, t == -0.37),
                             _evals(jp, pts, t, t == -0.37)):
            assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("scale", ["const", "t2", "t3"])
def test_scaled_matches_jax(scale, pts):
    tab = np.array([[-5.0, 0.5, 1.0], [-2.0, 1.0, 1.5], [0.0, 1.0, 2.0],
                    [1.0, 0.2, 2.5]])
    s = {"const": 2.0, "t2": tab[:, [0, 2]], "t3": tab}[scale]
    jp = J.ScaledPotential(J.PlummerPotential(mass=1e11, scaleRadius=5.0),
                           s, ampl=3.0)
    tp = T.ScaledPotential(T.PlummerPotential(mass=1e11, scaleRadius=5.0),
                           s, ampl=3.0)
    for t in (-6.0, -1.3, 2.0):
        for got, want in zip(_evals(tp, pts, t, t == -1.3),
                             _evals(jp, pts, t, t == -1.3)):
            assert _rel(got, want) < 1e-12


def test_scaled_schedule_no_ringing_no_negative_tail():
    pot = T.PlummerPotential(mass=1e10, scaleRadius=1.0)
    tab = np.array([[-5.0, 0.0, 1.0], [-2.2505, 0.0, 1.0],
                    [-2.25, 1.0, 1.0], [-1.75, 1.0, 1.0],
                    [-1.7495, 0.0, 1.0], [1.0, 0.0, 1.0]])
    sc = T.ScaledPotential(pot, tab)
    x = np.array([[2.0, 0.0, 0.0]])
    ref = float(pot.potential(x)[0])
    for t in np.linspace(-6.0, 3.0, 61):
        ampl = float(sc.potential(x, t=t)[0]) / ref
        assert -1e-12 <= ampl <= 1.0 + 1e-12, (t, ampl)


@pytest.mark.parametrize("interpolate", [True, False])
def test_evolving_matches_jax(interpolate, pts):
    masses = (1e11, 2e11, 1.5e11)
    times = [1.0, 0.0, 2.0]               # unsorted on purpose
    jp = J.EvolvingPotential([J.PlummerPotential(mass=m, scaleRadius=5.0)
                              for m in masses], times, interpolate)
    tp = T.EvolvingPotential([T.PlummerPotential(mass=m, scaleRadius=5.0)
                              for m in masses], times, interpolate)
    for t in (-1.0, 0.7, 1.5):
        for got, want in zip(_evals(tp, pts, t, t == 0.7),
                             _evals(jp, pts, t, t == 0.7)):
            assert _rel(got, want) < 1e-12


def test_evolving_duplicate_times_raises():
    p = T.PlummerPotential(mass=1e10)
    with pytest.raises(ValueError, match="distinct"):
        T.EvolvingPotential([p, p, p], [0.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="len"):
        T.EvolvingPotential([p, p], [0.0])


def test_trajectory_state_dict_carries_jax_tables(pts):
    """The JAX object's arrays loaded into the port's module with
    load_state_dict: a port Shifted built on another trajectory then
    evaluates as the JAX one does (the host copy of the breakpoints
    follows the load)."""
    traj = _traj(7)
    jp = J.ShiftedPotential(J.PlummerPotential(mass=1e11), traj)
    other = traj.copy()
    other[:, 0] = np.linspace(-3.0, 3.0, len(traj))
    other[:, 1:] *= 0.5
    tp = T.ShiftedPotential(T.PlummerPotential(mass=1e11), other)
    state = {"traj.x": torch.tensor(np.asarray(jp.traj.x)),
             "traj.c": torch.tensor(np.asarray(jp.traj.c))}
    assert set(state) == set(tp.state_dict())
    tp.load_state_dict(state)
    for t in (-0.9, 0.1, 2.0):
        assert _rel(tp.force(pts, t), jp.force(pts, t)) < 1e-12


# ---------------------------------------------------------------------------
# factory / INI
# ---------------------------------------------------------------------------

def test_mw22_ini_matches_jax(pts):
    jp = J.load_potential_ini(JDATA / "MWPotential22.ini")
    tp = T.load_potential_ini(TDATA / "MWPotential22.ini", device="cpu")
    assert isinstance(tp, T.CompositePotential) and len(tp) == 6
    for got, want in zip(_evals(tp, pts), _evals(jp, pts)):
        assert _rel(got, want) < 1e-12
    x = pts.astype(np.float32)
    with jax.enable_x64(False):
        fj = np.asarray(J.load_potential_ini(
            JDATA / "MWPotential22.ini").force(jnp.asarray(x)))
    ft = copy.deepcopy(tp).to(torch.float32).force(torch.tensor(x))
    assert _rel(ft, fj) < 1e-5


def test_factory_forms_and_modifiers_match_jax(pts, tmp_path):
    """Analytic + composite + center/scale nesting + a trajectory file +
    a time-dependent UniformAcceleration file, through make_potential
    and an INI with trailing non-potential sections and comments."""
    traj = _traj(4)
    np.savetxt(tmp_path / "traj.txt", traj)
    acc = np.column_stack([np.linspace(-1, 1, 7),
                           np.random.default_rng(5).normal(0, 50, (7, 3))])
    np.savetxt(tmp_path / "acc.txt", acc)
    ini = tmp_path / "pot.ini"
    ini.write_text(
        "# comment\n[Potential a]\ntype = Plummer\nmass = 1e10,\n"
        "scaleRadius = 1.0\ncenter = 50, 0, 0\nscale = 2.0\n\n"
        "[Potential b]\ntype = NFW\nmass = 1e12\nscaleRadius = 20\n"
        "center = traj.txt\n\n"
        "[Potential c]\ntype = UniformAcceleration\nfile = acc.txt\n\n"
        "[Potential stub]\ntype = DiskAnsatz\n\n"
        "[SelfConsistentModel]\nrminSph = 0.005\n")
    specs = [dict(type="Plummer", mass=1e10, scaleRadius=1.0,
                  center=[50.0, 0.0, 0.0], scale=2.0, ampl=0.5),
             dict(type="LogHalo", v0=180.0, coreradius=2.0)]
    jp, tp = J.load_potential_ini(ini), T.load_potential_ini(ini,
                                                              device="cpu")
    assert len(tp) == 3
    jm = J.make_potential(*specs)
    tm = T.make_potential(*specs, device="cpu")
    for t in (-0.5, 0.3):
        for got, want in zip(_evals(tp, pts, t, t > 0),
                             _evals(jp, pts, t, t > 0)):
            assert _rel(got, want) < 1e-12
        for got, want in zip(_evals(tm, pts, t, t > 0),
                             _evals(jm, pts, t, t > 0)):
            assert _rel(got, want) < 1e-12
    # Shifted outermost: the minimum sits at the stated centre
    pot = T.make_potential(type="Plummer", mass=1e10, scaleRadius=1.0,
                           center=[50.0, 0.0, 0.0], scale=2.0, device="cpu")
    assert float(pot.potential([[50.0, 0, 0]])[0]) \
        < float(pot.potential([[100.0, 0, 0]])[0])


def test_timestamps_ini_evolving_matches_jax(pts, tmp_path):
    """A type=Evolving INI with a Timestamps block (semicolon comments)
    of analytic snapshot files."""
    for i, m in enumerate((1e11, 2e11, 3e11)):
        (tmp_path / f"s{i}.ini").write_text(
            f"[Potential]\ntype=Plummer\nmass={m}\nscaleRadius=4\n")
    ini = tmp_path / "ev.ini"
    ini.write_text("[Potential]\ntype=Evolving\ninterpLinear=True\n"
                   "Timestamps\n; a comment\n0.0 s0.ini\n1.0 s1.ini\n"
                   "# another\n2.5 s2.ini\n")
    jp, tp = J.load_potential_ini(ini), T.load_potential_ini(ini,
                                                              device="cpu")
    assert isinstance(tp, T.EvolvingPotential)
    for t in (0.3, 1.7):
        for got, want in zip(_evals(tp, pts, t, t > 1),
                             _evals(jp, pts, t, t > 1)):
            assert _rel(got, want) < 1e-12
