"""The stream cell ``king_stream.n1m``: its King sampler against the
program's King model, its inputs from the seed, its check against the
faults of ``faults.py`` on the CPU, the band-window reader, and on the card
(marked ``cuda``) the cell at its own size against the float32 control."""
import numpy as np
import pytest
import torch

from portbench import faults, harness

CELL = "king_stream.n1m"
CFG, MOD = harness.config("king_stream")


@pytest.mark.parametrize("fault", [None, *faults.FAULTS],
                         ids=lambda f: f or "none")
def test_a_broken_step_is_not_correct(fault):
    with faults.planted(fault):
        line, numbers = harness.run(CELL, 2**31 + 13, 0.2, False,
                                    device="cpu", n_body=256)
    assert line["correct"] is (fault is None), numbers
    if fault is not None and fault.endswith(".late"):
        assert all(numbers["start"][q] <= limit
                   for q, limit in CFG["limits"].items()), numbers


def test_king_table_against_the_program():
    from nbody_streams_tpu_torch.fast_sims.king import KingModel

    x, w, m, x_t = MOD.king_table(CFG["W0"])
    prog = KingModel(CFG["W0"], CFG["mass"], CFG["r_core"])
    assert abs(x_t * CFG["r_core"] / prog.r_tidal - 1) < 1e-3
    mine = np.interp(prog.r_grid, x * CFG["r_core"], m / m[-1])
    assert np.abs(mine - prog.m_grid / CFG["mass"]).max() < 1e-3
    assert w[0] == CFG["W0"] and w[-1] == 0.0 and np.all(np.diff(m) > 0)


def test_sampled_cluster():
    n = 20_000
    inp = MOD.make_inputs(CFG, n, 2**33 + 5, torch.device("cpu"))
    pos = inp["pos"] - torch.tensor(CFG["R0"], dtype=torch.float64)
    vel = inp["vel"] - torch.tensor(CFG["V0"], dtype=torch.float64)
    assert pos.mean(0).abs().max() < 1e-12 and vel.mean(0).abs().max() < 1e-9
    x, w, m, x_t = MOD.king_table(CFG["W0"])
    r = pos.norm(dim=1).numpy()
    assert r.max() <= x_t * CFG["r_core"] * 1.01
    # M(<r) of the sample against the table, to its sampling error
    share = np.interp(r, x * CFG["r_core"], m / m[-1])
    grid = np.linspace(0.05, 0.95, 19)
    assert np.abs(np.quantile(share, grid) - grid).max() < 0.02
    # every body bound: below its local escape speed sqrt(2 sigma^2 W(r)),
    # to the shift of the removed mean motion
    sigma2 = MOD.ics.G * CFG["mass"] / (CFG["r_core"] * m[-1])
    v_esc = np.sqrt(2 * sigma2 * np.interp(r, x * CFG["r_core"], w))
    assert np.all(vel.norm(dim=1).numpy() <= v_esc + 0.01 * v_esc.max())
    assert inp["species"] == [("star", n, CFG["mass"] / n,
                               CFG["softening"])]


def test_same_seed_same_inputs():
    a = MOD.make_inputs(CFG, 512, 2**40 + 1, torch.device("cpu"))
    b = MOD.make_inputs(CFG, 512, 2**40 + 1, torch.device("cpu"))
    c = MOD.make_inputs(CFG, 512, 2**40 + 2, torch.device("cpu"))
    assert torch.equal(a["pos"], b["pos"]) and torch.equal(a["vel"], b["vel"])
    assert not torch.equal(a["pos"], c["pos"])


def test_no_friction_and_a_static_field():
    assert MOD.sim_kwargs(CFG, None) == {}
    field, friction = MOD.reference_terms(CFG, torch.device("cpu"))
    assert friction is None
    x = torch.tensor([[8.0, 0.0, 0.1], [14.0, 0.0, 6.0]], dtype=torch.float64)
    assert torch.equal(field.force(x, 0.0), field.force(x, -1.0))
    prog = MOD.program_field(CFG, "cpu")
    assert torch.allclose(prog.force(x.float(), 0.0).double(),
                          field.force(x, 0.0), rtol=1e-5)


def test_window_over_band_reader():
    read = harness.reader("gravity.window_over_band.field").read
    assert read({"branches": {"two_pass": 3, "single_pass": 1}}) is None
    assert read({"branches": {"window_rows": 0, "band_rows": 0}}) is None
    assert read({"branches": {"window_rows": 440, "band_rows": 200}}) == 2.2


@pytest.mark.cuda
def test_program_correct_control_not(card):
    line, numbers = harness.run(CELL, 2**31 + 101, 1.0, False)
    assert line["correct"], numbers
    assert line["metrics"]["field_step_ms"]["value"] > 0
    line, numbers = harness.run(CELL, 2**31 + 101, 1.0, False,
                                precision="float32")
    assert not line["correct"], numbers
