"""king_stream: a King (1966) cluster disrupting in the static McMillan17
field, the reference project's N-body stream deployment (see the .json).

The cluster is sampled here from the King distribution function in code
of its own, not through the program's ``sample_king``, so that a change to
the program cannot change the cell's data:

* the dimensionless King equation, (1 / x^2) d/dx (x^2 dW/dx) =
  -9 rho(W) / rho(W0), with rho(W) = e^W erf(sqrt W) - sqrt(4 W / pi)
  (1 + 2 W / 3), is solved in float64 on the host from the centre
  (W = W0) to the tidal radius (W = 0), x = r / r_core;
* radii are drawn by the inverse of the tabulated M(<r);
* speeds by rejection from the isotropic DF, f(E) ~ exp((psi - v^2/2) /
  sigma^2) - 1 for v below sqrt(2 psi), with q = v / sqrt(2 psi) drawn
  against the envelope q^2 (1 - q^2) (e^W - 1) >= q^2 (e^(W (1 - q^2)) -
  1), in bulk rounds on the device.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
from scipy.integrate import solve_ivp
from scipy.special import erf

from portbench import ics

# the raw files the program ships and the reference reads too
DATA = (Path(__file__).resolve().parents[2] / "nbody_streams_tpu_torch"
        / "data" / "potentials" / "MW_LMC_evolv")
# candidate speeds a remaining particle draws in one rejection round
_CANDIDATES = 16


def _rho_hat(w):
    w = np.maximum(w, 0.0)
    sw = np.sqrt(w)
    return np.exp(w) * erf(sw) - 2.0 * sw / math.sqrt(math.pi) \
        * (1.0 + 2.0 * w / 3.0)


def king_table(W0, n_grid=4096):
    """The dimensionless King model of central depth ``W0``: ``(x, w, m,
    x_t)``, on a grid of ``n_grid`` radii x = r / r_core from 0 to the
    tidal radius ``x_t``, the depth W(x) and m(x) = -x^2 dW/dx, which is
    M(<r) in units where m(x_t) is the total mass."""
    rho0 = _rho_hat(W0)

    def rhs(x, y):
        return [y[1], -9.0 * _rho_hat(y[0]) / rho0 - 2.0 * y[1] / x]

    def edge(x, y):
        return y[0]

    edge.terminal, edge.direction = True, -1
    # start off the centre on the series W = W0 - 3/2 x^2 + O(x^4)
    x0 = 1e-5
    sol = solve_ivp(rhs, [x0, 1e4], [W0 - 1.5 * x0 ** 2, -3.0 * x0],
                    method="DOP853", events=edge, rtol=1e-12, atol=1e-14,
                    dense_output=True)
    x_t = float(sol.t_events[0][0])
    x = np.concatenate([[0.0], np.geomspace(x0, x_t, n_grid - 1)])
    y = sol.sol(x[1:])
    w = np.concatenate([[W0], np.maximum(y[0], 0.0)])
    w[-1] = 0.0
    m = np.concatenate([[0.0], -x[1:] ** 2 * y[1]])
    return x, w, m, x_t


def _interp(xq, xp, fp):
    """Linear interpolation of the table (xp, fp) at ``xq`` (torch)."""
    k = torch.searchsorted(xp, xq).clamp(1, xp.numel() - 1)
    t = (xq - xp[k - 1]) / (xp[k] - xp[k - 1])
    return fp[k - 1] + t * (fp[k] - fp[k - 1])


def speed_fractions(g, w, device):
    """q = v / sqrt(2 psi) of the King DF at depths ``w`` = psi /
    sigma^2, by rejection in bulk: each round every remaining particle
    draws ``_CANDIDATES`` (q, y) pairs and keeps its first accepted q."""
    n = w.numel()
    out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        wt = w[todo][:, None]
        m = todo.numel()
        q = ics._uniform(g, m * _CANDIDATES, device).view(m, _CANDIDATES)
        y = ics._uniform(g, m * _CANDIDATES, device).view(m, _CANDIDATES)
        f = q * q * torch.expm1(wt * (1.0 - q * q))
        ok = y * 0.25 * torch.expm1(wt) <= f
        hit = ok.any(1)
        first = ok.to(torch.int8).argmax(1)
        out[todo[hit]] = q[hit, first[hit]]
        todo = todo[~hit]
    return out


def sample(cfg, n, seed, device):
    """(pos, vel) of a King cluster of ``n`` bodies in its own frame,
    float64 on ``device``: centre of mass and mean velocity removed."""
    mass, r_c = cfg["mass"], cfg["r_core"]
    x, w, m, _ = king_table(cfg["W0"])
    # sigma^2 = G M / (r_c m(x_t)): the mass scale of the dimensionless
    # model (4 pi G rho_0 r_c^2 = 9 sigma^2)
    sigma2 = ics.G * mass / (r_c * m[-1])
    f64 = dict(dtype=torch.float64, device=device)
    r_grid = torch.as_tensor(x * r_c, **f64)
    u_grid = torch.as_tensor(m / m[-1], **f64)
    w_grid = torch.as_tensor(w, **f64)
    g = ics.generator(seed, device)
    r = _interp(ics._uniform(g, n, device), u_grid, r_grid)
    pos = r[:, None] * ics.isotropic(g, n, device)
    wr = _interp(r, r_grid, w_grid).clamp_min(0.0)
    v = speed_fractions(g, wr, device) * torch.sqrt(2.0 * sigma2 * wr)
    vel = v[:, None] * ics.isotropic(g, n, device)
    return pos - pos.mean(0), vel - vel.mean(0)


def make_inputs(cfg, n_body, seed, device):
    """The cluster's phase space from ``seed``, float64 tensors on
    ``device``, placed on its orbit (R0, V0); one species of equal
    masses."""
    pos, vel = sample(cfg, n_body, seed, device)
    pos = pos + torch.tensor(cfg["R0"], dtype=torch.float64, device=device)
    vel = vel + torch.tensor(cfg["V0"], dtype=torch.float64, device=device)
    m = cfg["mass"] / n_body
    return {"pos": pos, "vel": vel,
            "species": [("star", n_body, m, cfg["softening"])],
            "mass": np.full(n_body, m),
            "soft": np.full(n_body, cfg["softening"])}


def sim_kwargs(cfg, inputs):
    return {}


def program_field(cfg, device):
    from nbody_streams_tpu_torch.potentials import make_potential
    from nbody_streams_tpu_torch.potentials.mwlmc import mw_lmc_data_dir

    return make_potential(file=mw_lmc_data_dir() / cfg["field"],
                          device=device)


def reference_terms(cfg, device):
    """The reference's McMillan17 field alone, float64 on ``device``,
    from the raw INI file through the frozen GalPot copies; no
    friction."""
    from portbench.reference.field import parse_ini
    from portbench.reference.field.base import CompositePotential
    from portbench.reference.field.galpot import build_disk, build_spheroid

    build = {"disk": build_disk, "spheroid": build_spheroid}
    field = CompositePotential([build[kind](**kw) for kind, kw
                                in parse_ini(DATA / cfg["field"])])
    return field.to(device=device, dtype=torch.float64), None
