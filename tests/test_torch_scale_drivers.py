"""The port's scale drivers (``nbody_streams_tpu_torch/benchmarks/
flagship2m.py`` and ``northstar.py``) against the repo's JAX drivers
(``benchmarks/flagship2m.py``, ``benchmarks/northstar.py``) on the CPU, at
small N: the flagship's ICs (1e-10 of max), its run (1e-6 of max), a
resumed run against an unbroken one (exactly), the attempts summary, the
gates' JSON lines and energy brackets, the argsort line, the card default
and the figures' directory."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import nbody_streams_tpu as jst
from nbody_streams_tpu.nbody_io import _load_restart as jax_load_restart
from nbody_streams_tpu.ops.dispatch import DirectGravity as JaxDirectGravity
from nbody_streams_tpu.potentials.mwlmc import (
    load_mw_lmc_potential as jax_mwlmc)
from nbody_streams_tpu_torch.benchmarks import flagship2m as fl
from nbody_streams_tpu_torch.benchmarks import northstar as ns
from nbody_streams_tpu_torch.sim import run_simulation

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
N = 2049
STEPS = 4
N_GATE = 1024
# the JSON keys of the JAX gates (benchmarks/northstar.py:121-133,185-197)
GATE_KEYS = {
    "gate2m": {"metric", "value", "unit", "steps", "n", "gint_per_s",
               "abs_dE_over_E", "Q0", "Q1", "peak_hbm_gb", "wall_s",
               "snapshots", "restart"},
    "gate1m": {"metric", "value", "unit", "steps", "n", "ms_per_step",
               "gint_per_s", "Q0", "Q1", "peak_hbm_gb", "wall_s",
               "resumed_from_step"},
}


def _jax_driver(name):
    """The JAX driver module from ``benchmarks/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_close(got, want):
    for sl in (slice(0, 3), slice(3, 6)):
        scale = np.abs(want[:, sl]).max()
        assert np.abs(got[:, sl] - want[:, sl]).max() < 1e-6 * scale


@pytest.fixture(scope="module")
def jax_ics():
    return _jax_driver("flagship2m").build_ics(N)


def test_build_ics_matches_jax(jax_ics):
    xv_j, sp_j = jax_ics
    xv, sp = fl.build_ics(N, device="cpu")
    assert xv.shape == (N, 6)
    assert np.abs(xv - xv_j).max() <= 1e-10 * np.abs(xv_j).max()
    assert [(s.name, s.N, s.softening) for s in sp] == [
        (s.name, s.N, s.softening) for s in sp_j]
    for a, b in zip(sp, sp_j):
        np.testing.assert_array_equal(a.mass, b.mass)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's flagship at N for STEPS steps: unbroken, and stopped at
    step 2 then resumed."""
    root = tmp_path_factory.mktemp("flagship")
    whole = fl.run(N, STEPS, device="cpu", out=root / "whole")
    half = fl.run(N, STEPS, device="cpu", out=root / "split", _stop_step=2)
    split = fl.run(N, STEPS, device="cpu", out=root / "split")
    return root, whole, half, split


def test_flagship_run_matches_jax(jax_ics, port_runs, tmp_path):
    xv, species = jax_ics
    pot, _ = jax_mwlmc()
    want = jst.run_simulation(
        xv, species, -STEPS * fl.DT, 0.0, fl.DT, architecture="cpu",
        method="direct", external_potential=pot, dynamical_friction=True,
        df_M_sat=fl.M_DARK + fl.M_STAR + fl.M_BH,
        df_coulomb_mode="variable", df_update_interval=10,
        output_dir=str(tmp_path), save_snapshots=False, snapshots=4,
        restart_interval=50, overwrite=True, verbose=False,
        precision="float32_kahan", step_timeout_s=900.0)
    got = port_runs[1]
    assert list(got) == ["dark", "stars", "bh"]
    for name in got:
        _assert_close(got[name], want[name])
    # the satellite's structure, as the driver prints it: the same for
    # both packages' states, and it fell in
    sat, sat_jax = fl.satellite(got, species), fl.satellite(want, species)
    for key in sat:
        assert abs(sat[key] - sat_jax[key]) <= 1e-6 * abs(sat_jax[key])
    bounds = np.cumsum([0] + [sp.N for sp in species])
    start = fl.satellite({sp.name: xv[a:b] for sp, a, b in zip(
        species, bounds, bounds[1:])}, species)
    assert sat["r_com"] < start["r_com"]


def test_resumed_run_equals_unbroken(port_runs):
    root, whole, half, split = port_runs
    assert all(np.isfinite(v).all() for v in half.values())
    for name in whole:
        np.testing.assert_array_equal(split[name], whole[name])
    recs = json.loads((root / "split" / fl.ATTEMPTS).read_text())
    assert [(r["start_step"], r["end_step"]) for r in recs] == [(0, 2),
                                                              (2, 4)]
    assert all(r["wall_s"] > 0 for r in recs)
    total = fl.summary(root / "split")
    assert total["steps"] == STEPS and total["attempts"] == 2
    assert total["wall_s"] == sum(r["wall_s"] for r in recs)
    assert fl.summary(root / "whole")["attempts"] == 1
    # the JAX reader reads the port's restart file, state entries and all
    restart = jax_load_restart(root / "split")
    assert restart[2] == STEPS
    np.testing.assert_array_equal(
        restart[0], np.concatenate([split[k] for k in split]))


def test_figures_write_under_the_output(port_runs):
    docs = ROOT / "docs" / "runs" / "flagship2m"
    before = sorted((p.name, p.stat().st_mtime_ns) for p in docs.glob("*"))
    out = port_runs[0] / "whole"
    written = fl.figures(out=out, device="cpu")
    assert [p.name for p in written] == ["sph_first.png", "sph_last.png"]
    for p in written:
        assert p.parent == out / "figures" and p.stat().st_size > 0
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in docs.glob("*")) == before


def _jax_energy(masses, arr):
    import jax.numpy as jnp

    solver = JaxDirectGravity(masses, np.full(len(masses), ns.SOFTENING))
    phi = np.asarray(solver.potential(jnp.asarray(arr[:, :3], jnp.float32)),
                     np.float64)
    ke = 0.5 * (masses * (np.asarray(arr[:, 3:]) ** 2).sum(1)).sum()
    return ke, 0.5 * (masses * phi).sum()


@pytest.mark.parametrize("gate,seed", [("gate2m", 1), ("gate1m", 2)])
def test_gate_on_cpu(gate, seed, tmp_path, capsys):
    run = {"gate2m": ns.run_gate2m, "gate1m": ns.run_gate1m}[gate]
    rec = run(n=N_GATE, steps=STEPS, device="cpu", out=tmp_path / gate)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines[-1] == rec
    assert GATE_KEYS[gate] <= set(rec) and rec["device"] == "cpu"
    assert rec["steps"] == STEPS and rec["n"] == N_GATE
    de = rec["abs_dE_over_E"] if gate == "gate2m" else rec["value"]
    assert np.isfinite(de) and de < 1e-4
    assert rec["peak_hbm_gb"] is None
    if gate == "gate2m":
        assert rec["restart"] and rec["snapshots"] == ["snapshot.h5",
                                                       "snapshot.times"]
    # the bracket against the JAX formula, at the ICs and the final state
    xv, masses, _ = ns._plummer(N_GATE, seed)
    final = np.load(tmp_path / gate / "restart.npz")["phase_space"]
    energy = ns.energy_bracket(masses, "cpu")
    for arr in (xv, final):
        for got, want in zip(energy(arr), _jax_energy(masses, arr)):
            assert abs(got - want) <= 1e-6 * abs(want)


def test_gate1m_resumes_a_stopped_attempt(tmp_path, capsys):
    xv, masses, species = ns._plummer(N_GATE, 2)
    run_simulation(xv, species, 0.0, STEPS * ns.DT, ns.DT,
                   architecture="cpu", impl="cuda", save_snapshots=False,
                   verbose=False, restart_interval=100, overwrite=True,
                   output_dir=str(tmp_path), _stop_step=2)
    rec = ns.run_gate1m(n=N_GATE, steps=STEPS, device="cpu", out=tmp_path)
    assert rec["resumed_from_step"] == 2 and rec["value"] < 1e-4
    assert not (tmp_path.parent / (tmp_path.name + "_warmup")).exists()
    assert np.load(tmp_path / "restart.npz")["step"] == STEPS


def test_argsort_on_cpu(capsys):
    ms = ns.run_argsort(n=65536, device="cpu")
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec == {"metric": "argsort_2m_ms", "value": ms, "unit": "ms",
                   "n": 65536, "device": "cpu"} and ms > 0


@pytest.mark.parametrize("call", [
    lambda: fl.build_ics(5),
    lambda: fl.run(5, 1),
    lambda: fl.figures(),
    lambda: fl.main([]),
    lambda: ns.run_argsort(n=16),
    lambda: ns.run_gate2m(n=16, steps=1),
    lambda: ns.run_gate1m(n=16, steps=1),
    lambda: ns.main(["gate1m"]),
], ids=["build_ics", "run", "figures", "flagship_main", "argsort", "gate2m",
        "gate1m", "northstar_main"])
def test_drivers_default_to_the_card(call, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("stop", [0, STEPS + 1])
def test_stop_step_outside_the_run_raises(stop, tmp_path):
    xv, masses, species = ns._plummer(64, 3)
    with pytest.raises(ValueError, match="stop_step"):
        run_simulation(xv, species, 0.0, STEPS * ns.DT, ns.DT,
                       architecture="cpu", save_snapshots=False,
                       verbose=False, output_dir=str(tmp_path),
                       _stop_step=stop)


def test_northstar_gate1m_options(monkeypatch):
    """The gate1m command line passes its depth, target drift and output
    directory to run_gate1m; the bare command keeps the 1,000-step gate."""
    seen = []
    monkeypatch.setattr(ns, "run_gate1m", lambda **kw: seen.append(kw))
    assert ns.main(["gate1m", "--steps", "200", "--target-drift", "1e-8",
                    "--out", "d"]) == 0
    assert ns.main(["gate1m"]) == 0
    assert seen == [dict(steps=200, out="d", target_drift=1e-8),
                    dict(steps=1000, out=ns.OUT_1M, target_drift=None)]
    with pytest.raises(SystemExit):
        ns.main(["gate3m"])
