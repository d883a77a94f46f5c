"""The port's run_simulation / run_nbody against the JAX package's, end to
end on the CPU, and the files each package writes read by the other.

N = 512 Plummer sphere, 20 KDK steps of dt = 2e-5, spline h = 0.05,
float32 + Kahan.  The JAX side runs its jnp oracle; the port runs its CUDA
path (on the CPU: the kernels' plain versions) and its torch oracle, alone
and in an external field (MWPotential22; the MW+LMC evolving field, the
satellite placed at (14, 0, 6) kpc).  Tolerance: 1e-6 * max |x| on
positions and velocities (fp32 force sums in another order; the port
evaluates the field in the fp32 state's dtype, the JAX package in its
fp64 tables).
"""
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import nbody_streams_tpu as jst
import nbody_streams_tpu_torch as tst
from nbody_streams_tpu.potentials import load_potential_ini as jax_ini
from nbody_streams_tpu.potentials.mwlmc import (
    load_mw_lmc_potential as jax_mwlmc)
from nbody_streams_tpu_torch import run as trun
from nbody_streams_tpu_torch.potentials import (
    load_mw_lmc_potential, load_potential_ini)

torch.set_num_threads(2)

N = 512
DT = 2e-5
STEPS = 20


@pytest.fixture(scope="module")
def case():
    xv, m = tst.make_plummer_sphere(N, M_total=1e9, a=1.0, seed=2)
    return xv, [tst.Species.dark(N=N, mass=float(m[0]), softening=0.05)]


def _jax_species(species):
    return [jst.Species(s.name, s.N, s.mass, s.softening) for s in species]


def _run(pkg, xv, species, out_dir, steps, **kw):
    kw.setdefault("snapshots", 3)
    sp = species if pkg is tst else _jax_species(species)
    return pkg.run_simulation(xv, sp, 0.0, steps * DT, DT,
                              architecture="cpu", output_dir=str(out_dir),
                              verbose=False, **kw)["dark"]


def _assert_close(got, want):
    for sl in (slice(0, 3), slice(3, 6)):
        scale = np.abs(want[:, sl]).max()
        assert np.abs(got[:, sl] - want[:, sl]).max() < 1e-6 * scale


@pytest.fixture(scope="module")
def jax_final(case, tmp_path_factory):
    xv, species = case
    return _run(jst, xv, species, tmp_path_factory.mktemp("jax"), STEPS)


MW22 = "data/potentials/MWPotential22.ini"
#: the satellite's place in the field (examples/stream_nbody.py)
ORBIT = np.array([14.0, 0.0, 6.0, 30.0, 150.0, -10.0])


def _fields(pkg):
    if pkg is tst:
        return {"mw22": lambda: load_potential_ini(
                    "nbody_streams_tpu_torch/" + MW22, device="cpu"),
                "mwlmc": lambda: load_mw_lmc_potential(device="cpu")[0]}
    return {"mw22": lambda: jax_ini("nbody_streams_tpu/" + MW22),
            "mwlmc": lambda: jax_mwlmc()[0]}


@pytest.mark.parametrize("impl,field", [
    pytest.param("cuda", None, id="cuda"),
    pytest.param("torch", None, id="torch"),
    pytest.param("cuda", "mw22", id="cuda-mw22"),
    pytest.param("cuda", "mwlmc", id="cuda-mwlmc")])
def test_run_simulation_matches_jax(case, jax_final, tmp_path, impl, field):
    xv, species = case
    if field is None:
        got = _run(tst, xv, species, tmp_path, STEPS, impl=impl)
        want = jax_final
    else:
        xv = xv + ORBIT
        t0 = -1.0 if field == "mwlmc" else 0.0
        runs = {}
        for pkg in (tst, jst):
            sp = species if pkg is tst else _jax_species(species)
            pot = _fields(pkg)[field]()
            kw = dict(impl=impl) if pkg is tst else {}
            runs[pkg] = pkg.run_simulation(
                xv, sp, t0, t0 + STEPS * DT, DT, architecture="cpu",
                output_dir=str(tmp_path / pkg.__name__), verbose=False,
                snapshots=3, external_potential=pot, **kw)["dark"]
        got, want = runs[tst], runs[jst]
        # the field moved the satellite: its centre of mass accelerated
        drift = got[:, 3:].mean(0) - xv[:, 3:].mean(0)
        assert np.abs(drift).max() > 1e-3
    assert got.shape == (N, 6) and got.dtype == np.float64
    _assert_close(got, want)
    if field is not None:
        return
    # the JAX package's reader reads the port's snapshots
    reader = jst.ParticleReader(str(tmp_path / "snapshot*.h5"))
    assert list(reader.Snapshots) == [0, 1, 2]
    last = reader.read_snapshot(2)
    np.testing.assert_array_equal(last.dark["posvel"], got)
    assert abs(last.time - STEPS * DT) < 1e-12


def test_port_restart_resumes_in_jax(case, jax_final, tmp_path):
    xv, species = case
    _run(tst, xv, species, tmp_path, STEPS // 2, snapshots=2,
         restart_interval=STEPS // 2)
    resumed = _run(jst, xv, species, tmp_path, STEPS, continue_run=True,
                   restart_interval=STEPS // 2)
    _assert_close(resumed, jax_final)
    reader = tst.ParticleReader(str(tmp_path / "snapshot*.h5"))
    assert list(reader.Snapshots) == [0, 1, 2]


def test_jax_restart_resumes_in_port(case, jax_final, tmp_path):
    xv, species = case
    _run(jst, xv, species, tmp_path, STEPS // 2, snapshots=2,
         restart_interval=STEPS // 2)
    resumed = _run(tst, xv, species, tmp_path, STEPS, continue_run=True,
                   restart_interval=STEPS // 2, impl="cuda")
    _assert_close(resumed, jax_final)
    step = trun._load_restart(tmp_path)[2]
    assert step == STEPS


def test_import_leaves_jax_out():
    mods = ("nbody_streams_tpu_torch, nbody_streams_tpu_torch.potentials, "
            "nbody_streams_tpu_torch.friction, nbody_streams_tpu_torch.df, "
            "nbody_streams_tpu_torch.ops.scf, "
            "nbody_streams_tpu_torch.fast_sims, "
            "nbody_streams_tpu_torch.fast_sims.orbits, "
            "nbody_streams_tpu_torch.fast_sims.spray, "
            "nbody_streams_tpu_torch.fast_sims.restricted, "
            "nbody_streams_tpu_torch.fast_sims._common, "
            "nbody_streams_tpu_torch.tree, nbody_streams_tpu_torch.tree_gpu, "
            "nbody_streams_tpu_torch.fields, "
            "nbody_streams_tpu_torch.agama_helper, "
            "nbody_streams_tpu_torch.utils, "
            "nbody_streams_tpu_torch.utils.main, "
            "nbody_streams_tpu_torch.utils.devices, "
            "nbody_streams_tpu_torch.coords, "
            "nbody_streams_tpu_torch.coords.streams, "
            "nbody_streams_tpu_torch.benchmarks.scf")
    code = (f"import sys, {mods}; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'nbody_streams_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_not_ported_options_raise(case, tmp_path):
    """The sharded impl and more than one device still raise, naming their
    ROADMAP item (the multi-device ring); the SCF tier, dynamical
    friction, the one-device tree and profile_dir run (the last two are
    held in tests/test_torch_compat.py)."""
    xv, species = case
    run = lambda **kw: tst.run_simulation(   # noqa: E731
        xv, species, 0.0, 2 * DT, DT, output_dir=str(tmp_path),
        verbose=False, save_snapshots=False, **kw)
    two = ["cuda:0", "cuda:1"]
    for kw, item in ((dict(impl="sharded"), "item 6"),
                     (dict(method="tree", devices=two), "item 6"),
                     (dict(devices=two), "item 6")):
        with pytest.raises(NotImplementedError, match=item):
            run(architecture="cpu", **kw)
    for kw in (dict(method="scf", scf_a=1.0),
               dict(dynamical_friction=True,
                    external_potential=_fields(tst)["mw22"]())):
        got = run(architecture="cpu", overwrite=True, **kw)["dark"]
        assert got.shape == (N, 6) and np.isfinite(got).all()
    with pytest.raises(ValueError, match="architecture"):
        run(architecture="tpu")
    with pytest.raises(ValueError, match="tpu"):
        trun._resolve_device("tpu")
    with pytest.raises(TypeError, match="bogus"):
        run(architecture="cpu", bogus=1)
    # any object with force(pos, t) is a field; one without is refused
    with pytest.raises(TypeError, match="force"):
        run(architecture="cpu", external_potential=object())


def test_gpu_architecture_raises_without_a_card(case, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    xv, species = case
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.run_simulation(xv, species, 0.0, DT, DT, architecture="gpu",
                           output_dir=str(tmp_path), verbose=False)
    # 'auto' means the card too: without one it raises, naming 'cpu'
    with pytest.raises(RuntimeError, match="architecture='cpu'"):
        trun._resolve_device("auto")


def test_overwrite_and_continue_guards(case, tmp_path):
    xv, species = case
    _run(tst, xv, species, tmp_path, 2, snapshots=2)
    with pytest.raises(FileExistsError):
        _run(tst, xv, species, tmp_path, 2, snapshots=2)
    (tmp_path / "restart.npz").unlink()
    with pytest.raises(FileNotFoundError, match="restart.npz"):
        _run(tst, xv, species, tmp_path, 2, snapshots=2, continue_run=True)
    _run(tst, xv, species, tmp_path, 2, snapshots=2, overwrite=True)
    assert (tmp_path / "restart.npz").exists()


def test_nan_gate_keeps_last_good_restart(case, tmp_path):
    xv, species = case
    bad = xv.copy()
    bad[0, 3] = np.nan
    with pytest.raises(FloatingPointError, match="Non-finite"):
        _run(tst, bad, species, tmp_path, 2, save_snapshots=False)
    assert (tmp_path / "restart_nanabort.npz").exists()
    assert not (tmp_path / "restart.npz").exists()


def test_debug_energy_reports_drift(case, tmp_path, capsys):
    xv, species = case
    tst.run_simulation(xv, species, 0.0, 4 * DT, DT, architecture="cpu",
                       output_dir=str(tmp_path), snapshots=2,
                       debug_energy=True, verbose=True)
    out = capsys.readouterr().out
    de = [float(line.split("dE/E=")[1]) for line in out.splitlines()
          if "dE/E=" in line]
    assert de and all(abs(d) < 1e-5 for d in de)


def test_watchdog_hang_saves_completed_work(tmp_path, monkeypatch):
    """A hang mid-run saves an emergency restart holding the work done up
    to the last finished 50-step sub-chunk, then interrupts the run."""
    monkeypatch.setattr(trun, "_CHUNK_GRACE_S", 0.2)
    xv, m = tst.make_plummer_sphere(32, M_total=1e4, a=0.01, seed=1)
    calls = {"n": 0}

    def hanging_force(pos, vel, mass, t):
        calls["n"] += 1
        if calls["n"] > 60:          # hang inside the second sub-chunk
            time.sleep(2.0)
        return np.zeros_like(pos)

    with pytest.raises(KeyboardInterrupt):
        tst.run_nbody(xv, m, 0.0, 120e-4, 1e-4, softening=0.003,
                      architecture="cpu", output_dir=str(tmp_path),
                      verbose=False, save_snapshots=False,
                      step_timeout_s=0.01, force_extra=hanging_force)
    loaded = trun._load_restart(tmp_path)
    assert loaded is not None and loaded[2] >= 50
    assert np.isfinite(loaded[0]).all()


def test_snapshot_schedule_collapses_duplicates():
    assert list(trun._snapshot_schedule(3, 10)) == [0, 1, 2, 3]
    assert list(trun._snapshot_schedule(10, 1)) == [10]
