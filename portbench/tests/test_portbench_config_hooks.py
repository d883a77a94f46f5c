"""A configuration's own hooks in the harness: the solver keywords it
names, its self-gravity reference and its control faults.

On the CPU: the three configurations of ``BENCHMARK.json`` hand
``run_simulation`` the keywords they always did (``kernel='spline'``
among them); the check with the default self-gravity named or not gives
the same numbers; and two configurations that exist only here, put into
the harness's look-ups by ``monkeypatch``, decide ``correct`` by their own
hooks: an SCF tier with no ``kernel`` key, judged against a float64 SCF
stand-in (the program's own ``SCFGravity(precision='float64')``, for the
plumbing only: a configuration of the benchmark brings a plain reference
of its own) and its faults, and a direct sum with Plummer softening
against a float64 Plummer sum.  Each fails against the default spline
direct sum.  On the card (marked ``cuda``): the SCF tier at 2^20 bodies
and (nmax, lmax) = (8, 4) is correct, and with its contractions in TF32
it is not."""
import contextlib
import copy
import types

import pytest
import torch

from portbench import faults, harness
from portbench.reference import check, gravity

SEED = 2**31 + 29
# the plain Plummer sphere's inputs, field and friction (none)
PLUMMER_CFG, PLUMMER = harness.config("plummer_iso")

# what run_simulation got from each configuration before the hooks, at
# n_body = 256 on the CPU, besides output_dir and the window's
# restart_interval
BASE = {"method": "direct", "kernel": "spline", "precision": "float32_kahan",
        "architecture": "cpu", "save_snapshots": False, "verbose": False}
FRICTION = {"dynamical_friction": True,
            "df_M_sat": pytest.approx(2.251e9, rel=1e-12),
            "df_coulomb_mode": "variable", "df_update_interval": 10}
KEYWORDS = {"plummer_iso.n65k": (BASE, False),
            "mwlmc_sat.n1m": ({**BASE, **FRICTION}, True),
            "king_stream.n1m": (BASE, True)}


@pytest.mark.parametrize("cell", KEYWORDS)
def test_each_configuration_hands_the_same_keywords(cell, monkeypatch):
    from nbody_streams_tpu_torch import sim

    calls = []
    run_simulation = sim.run_simulation

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return run_simulation(*args, **kwargs)

    monkeypatch.setattr(sim, "run_simulation", spy)
    line, numbers = harness.run(cell, SEED, 0.2, False, device="cpu",
                                n_body=256)
    assert line["correct"], numbers
    want, has_field = KEYWORDS[cell]
    start, window = calls
    assert set(start) == {*want, "output_dir", "external_potential"}
    assert set(window) == set(start) | {"restart_interval"}
    for kw in (start, window):
        assert {k: kw[k] for k in want} == want
        assert (kw["external_potential"] is not None) is has_field


def test_the_default_self_gravity_is_the_direct_sum():
    inputs = PLUMMER.make_inputs(PLUMMER_CFG, 256, SEED, "cpu")
    mass = torch.as_tensor(inputs["mass"])
    soft = torch.as_tensor(inputs["soft"])
    x = inputs["pos"]
    g = torch.Generator().manual_seed(5)
    dx = 1e-4 * torch.randn(x.shape, generator=g, dtype=torch.float64)
    a = {"x": x, "y": x, "v": inputs["vel"], "t": -2e-5}
    b = {"x": x + dx, "y": x + dx, "v": inputs["vel"] + dx, "t": 0.0}
    sample = torch.arange(0, 256, 3)
    args = (a, b, sample, mass, soft, 4.3e-6, 2e-5)
    assert check.step(*args) == check.step(*args, gravity=gravity.accel)


# -- configurations that exist only in these tests -------------------------

def _scf_sim_kwargs(cfg, inputs):
    return {f"scf_{k}": v for k, v in cfg["scf"].items()}


def _scf_stand_in(cfg, device):
    """The float64 SCF field of every source at the targets, by the
    program's own ``SCFGravity``: a stand-in for the plumbing only."""
    from nbody_streams_tpu_torch.ops.scf import SCFGravity

    o = cfg["scf"]

    def accel(tgt_pos, tgt_soft, tgt_index, src_pos, src_mass, src_soft, G):
        scf = SCFGravity(src_mass, nmax=o["nmax"], lmax=o["lmax"], a=o["a"],
                         G=G, precision="float64", device=device)
        return scf.field(src_pos, tgt_pos)[1]

    return accel


@contextlib.contextmanager
def _scaled():
    """Every SCF acceleration scaled by 1 + 1e-3."""
    from nbody_streams_tpu_torch.ops import scf

    accel = scf.SCFGravity.accel
    scf.SCFGravity.accel = lambda self, pos: accel(self, pos) * (1 + 1e-3)
    try:
        yield
    finally:
        scf.SCFGravity.accel = accel


@contextlib.contextmanager
def _tf32():
    """The SCF contractions in TF32: the guard that keeps them in IEEE
    fp32 taken out, TF32 allowed."""
    from nbody_streams_tpu_torch.ops import scf

    guard, allow = scf._ieee_fp32, torch.backends.cuda.matmul.allow_tf32
    scf._ieee_fp32 = contextlib.nullcontext
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        scf._ieee_fp32 = guard
        torch.backends.cuda.matmul.allow_tf32 = allow


def _plummer_sum(cfg, device):
    """The float64 direct sum with Plummer softening, h = max(h_i, h_j)."""

    def accel(tgt_pos, tgt_soft, tgt_index, src_pos, src_mass, src_soft, G):
        d = src_pos[None, :, :] - tgt_pos[:, None, :]
        h = torch.maximum(tgt_soft[:, None], src_soft[None, :])
        w = src_mass[None, :] * ((d * d).sum(-1) + h * h) ** -1.5
        own = (torch.arange(src_pos.shape[0], device=src_pos.device)[None, :]
               == tgt_index[:, None])
        w = torch.where(own, torch.zeros_like(w), w)
        return G * (w[:, :, None] * d).sum(1)

    return accel


def _module(**hooks):
    return types.SimpleNamespace(
        make_inputs=PLUMMER.make_inputs, program_field=PLUMMER.program_field,
        reference_terms=PLUMMER.reference_terms,
        sim_kwargs=hooks.pop("sim_kwargs", PLUMMER.sim_kwargs), **hooks)


SCF_CFG = {**{k: PLUMMER_CFG[k] for k in ("M_total", "a", "softening", "dt",
                                          "t_end", "trace_steps_max")},
           "name": "scf_hooks", "method": "scf", "precision": "float32_kahan",
           "scf": {"nmax": 4, "lmax": 2, "a": 1.0},
           "limits": {"acc_err": 1e-4, "pos_err": 1e-4}}
SCF = _module(sim_kwargs=_scf_sim_kwargs, reference_gravity=_scf_stand_in,
              FAULTS={"scaled": _scaled, "tf32": _tf32})
PLUMMER_SOFT_CFG = {**PLUMMER_CFG, "name": "plummer_soft",
                    "kernel": "plummer"}

# configuration, module, n_body, fault, correct
CASES = {
    "scf-own": (SCF_CFG, SCF, 2048, None, True),
    "scf-direct": (SCF_CFG, _module(sim_kwargs=_scf_sim_kwargs), 2048, None,
                   False),
    "scf-own-scaled": (SCF_CFG, SCF, 2048, "scaled", False),
    "plummer-own": (PLUMMER_SOFT_CFG, _module(reference_gravity=_plummer_sum),
                    256, None, True),
    "plummer-spline": (PLUMMER_SOFT_CFG, _module(), 256, None, False),
}


def _install(monkeypatch, cfg, module, n_body, check_sample):
    """A cell ``<config>.test`` of ``cfg`` and ``module`` in the harness's
    look-ups, with ``n_body`` bodies and K = 21 at any ``--seconds`` up to
    about 2; returns the cell's name."""
    cell = cfg["name"] + ".test"
    man = harness.manifest()
    man["workloads"].append({"name": cell, "config": cfg["name"],
                             "traffic": cell, "chips": 1, "why": "a test"})
    config, traffic, cell_file = (harness.config, harness.traffic,
                                  harness.cell_file)
    monkeypatch.setattr(harness, "manifest", lambda: copy.deepcopy(man))
    monkeypatch.setattr(harness, "config", lambda name: (
        (cfg, module) if name == cfg["name"] else config(name)))
    monkeypatch.setattr(harness, "traffic", lambda name: (
        {"n_body": n_body, "check_sample": check_sample} if name == cell
        else traffic(name)))
    monkeypatch.setattr(harness, "cell_file", lambda name: (
        {"steps_per_second": 1.0} if name == cell else cell_file(name)))
    return cell


@pytest.mark.parametrize("case", CASES)
def test_a_configurations_hooks_decide_correct(case, monkeypatch):
    cfg, module, n_body, fault, want = CASES[case]
    cell = _install(monkeypatch, cfg, module, n_body, n_body)
    with faults.planted(fault, cell):
        line, numbers = harness.run(cell, SEED, 0.2, False, device="cpu")
    assert line["correct"] is want, numbers
    assert line["attempted"] == 21


def test_a_fault_name_of_the_harness_comes_first(monkeypatch):
    # a configuration's fault of the same name as one of faults.py's
    # is not the one planted
    module = _module(FAULTS={"half": _scaled})
    cell = _install(monkeypatch, PLUMMER_SOFT_CFG, module, 256, 256)
    with faults.planted("half", cell):
        from nbody_streams_tpu_torch import run as prun

        assert prun.make_kdk_step.__name__ == "broken_make"
    with pytest.raises(KeyError):
        with faults.planted("no-such-fault", cell):
            pass


@pytest.mark.cuda
def test_scf_at_a_million_is_correct_its_tf32_control_not(card, monkeypatch):
    cfg = {**SCF_CFG, "scf": {"nmax": 8, "lmax": 4, "a": 1.0}}
    cell = _install(monkeypatch, cfg, SCF, 2**20, 8192)
    line, numbers = harness.run(cell, SEED, 1.0, False)
    assert line["correct"], numbers
    with faults.planted("tf32", cell):
        line, numbers = harness.run(cell, SEED, 1.0, False)
    assert not line["correct"], numbers
