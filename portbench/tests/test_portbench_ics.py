"""The initial conditions: the Plummer sampler's enclosed mass, and the
satellite's species split and Jeans dispersion."""
import math

import numpy as np
import pytest
import torch

from portbench import harness, ics

CPU = torch.device("cpu")


def test_plummer_enclosed_mass_profile():
    n, a = 200_000, 1.3
    pos, vel = ics.plummer_sphere(ics.generator(2**31 + 7, CPU), n, 1e9, a,
                                  CPU)
    r = torch.linalg.norm(pos, dim=1).numpy()
    for x in (0.3, 0.7, 1.0, 2.0, 5.0):
        want = x ** 3 / (x * x + 1) ** 1.5
        got = (r < x * a).mean()
        assert abs(got - want) < 4 * math.sqrt(want * (1 - want) / n)
    # virial equilibrium: 2K = -W = 3 pi G M^2 / (32 a)
    m = 1e9 / n
    two_k = m * (vel * vel).sum().item()
    assert abs(two_k / (3 * math.pi * ics.G * 1e18 / (32 * a)) - 1) < 0.02


def test_same_seed_same_inputs():
    cfg, mod = harness.config("mwlmc_sat")
    a = mod.make_inputs(cfg, 600, 2**33 + 5, CPU)
    b = mod.make_inputs(cfg, 600, 2**33 + 5, CPU)
    c = mod.make_inputs(cfg, 600, 2**33 + 6, CPU)
    assert torch.equal(a["pos"], b["pos"]) and torch.equal(a["vel"],
                                                           b["vel"])
    assert not torch.equal(a["pos"], c["pos"])


@pytest.mark.parametrize("n_body", [65536, 1048576])
def test_satellite_species_split(n_body):
    cfg, mod = harness.config("mwlmc_sat")
    n_dark, n_star, n_bh = mod.split(cfg, n_body)
    assert (n_dark, n_bh) == (round(n_body * 5 / 6), 1)
    assert n_dark + n_star == n_body


def test_satellite_inputs():
    cfg, mod = harness.config("mwlmc_sat")
    inp = mod.make_inputs(cfg, 3000, 11, CPU)
    m = inp["mass"]
    assert m.shape == (3001,) and inp["pos"].shape == (3001, 3)
    assert np.isclose(m.sum(), 2.0e9 + 2.5e8 + 1e6)
    w = torch.as_tensor(m / m.sum())[:, None]
    assert torch.allclose((w * inp["pos"]).sum(0),
                          torch.tensor(cfg["R0"], dtype=torch.float64))
    assert torch.allclose((w * inp["vel"]).sum(0),
                          torch.tensor(cfg["V0"], dtype=torch.float64))
    assert [s[0] for s in inp["species"]] == ["dark", "stars", "bh"]


def test_jeans_sigma_against_plummer():
    # one Plummer in its own potential: sigma^2 = G M / (6 sqrt(r^2 + a^2))
    mass, a = 2e9, 1.5
    lnr, s2 = ics.jeans_sigma2(mass, a, [(mass, a)])
    r = np.exp(lnr)
    want = ics.G * mass / (6 * np.sqrt(r * r + a * a))
    inside = r < 100 * a
    assert np.max(np.abs(s2[inside] / want[inside] - 1)) < 1e-4


def test_jeans_velocities_dispersion():
    mass, a = 2e9, 1.5
    lnr, s2 = ics.jeans_sigma2(mass, a, [(mass, a)])
    g = ics.generator(5, CPU)
    r = torch.full((400_000,), a, dtype=torch.float64)
    v = ics.jeans_velocities(g, r, lnr, s2)
    want = ics.G * mass / (6 * math.sqrt(2) * a)
    assert abs(v.var(0).mean().item() / want - 1) < 0.01
