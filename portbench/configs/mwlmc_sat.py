"""mwlmc_sat: the flagship's satellite in the evolving MW + LMC field with
Chandrasekhar friction (see the .json)."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from portbench import ics

# the raw files the program ships and the reference reads too
DATA = (Path(__file__).resolve().parents[2] / "nbody_streams_tpu_torch"
        / "data" / "potentials")


def split(cfg, n_body):
    """(n_dark, n_stars, 1): the flagship's split of N = n_body + 1."""
    n_dark = int(round(n_body * cfg["components"]["dark"]["share"]))
    return n_dark, n_body - n_dark, 1


def make_inputs(cfg, n_body, seed, device):
    """The satellite's phase space from ``seed``, float64 tensors on
    ``device``: Plummer radii per component, Gaussian velocities with each
    component's Jeans dispersion in the potential of all three, the common
    centre of mass removed, then placed on the orbit (R0, V0)."""
    c = cfg["components"]
    n_dark, n_star, n_bh = split(cfg, n_body)
    plummers = [(c["dark"]["mass"], c["dark"]["a"]),
                (c["stars"]["mass"], c["stars"]["a"])]
    g = ics.generator(seed, device)
    pos, vel = [], []
    for name, n in (("dark", n_dark), ("stars", n_star)):
        mass, a = c[name]["mass"], c[name]["a"]
        r = ics.plummer_radii(g, n, a, device)
        pos.append(r[:, None] * ics.isotropic(g, n, device))
        lnr, s2 = ics.jeans_sigma2(mass, a, plummers, c["bh"]["mass"])
        vel.append(ics.jeans_velocities(g, r, lnr, s2))
    zero = torch.zeros((n_bh, 3), dtype=torch.float64, device=device)
    pos = torch.cat(pos + [zero])
    vel = torch.cat(vel + [zero])
    m = np.concatenate([np.full(n_dark, c["dark"]["mass"] / n_dark),
                        np.full(n_star, c["stars"]["mass"] / n_star),
                        [c["bh"]["mass"]]])
    w = torch.as_tensor(m / m.sum(), device=device)[:, None]
    pos = pos - (w * pos).sum(0) + torch.tensor(cfg["R0"], device=device,
                                                 dtype=torch.float64)
    vel = vel - (w * vel).sum(0) + torch.tensor(cfg["V0"], device=device,
                                                 dtype=torch.float64)
    soft = np.concatenate([np.full(n_dark, c["dark"]["softening"]),
                           np.full(n_star, c["stars"]["softening"]),
                           [c["bh"]["softening"]]])
    species = [("dark", n_dark, c["dark"]["mass"] / n_dark,
                c["dark"]["softening"]),
               ("stars", n_star, c["stars"]["mass"] / n_star,
                c["stars"]["softening"]),
               ("bh", n_bh, c["bh"]["mass"], c["bh"]["softening"])]
    return {"pos": pos, "vel": vel, "species": species, "mass": m,
            "soft": soft}


def sim_kwargs(cfg, inputs):
    f = cfg["friction"]
    return {"dynamical_friction": True,
            "df_M_sat": float(inputs["mass"].sum()),
            "df_coulomb_mode": f["df_coulomb_mode"],
            "df_update_interval": f["df_update_interval"]}


def program_field(cfg, device):
    from nbody_streams_tpu_torch.potentials.mwlmc import (
        load_mw_lmc_potential,
    )

    return load_mw_lmc_potential(device=device)[0]


def reference_terms(cfg, device):
    """The reference's field, float64 on ``device``, and a maker of its
    friction for a call's total mass and mid time (the friction's
    dispersion table is taken there)."""
    from portbench.reference.field import load_mw_lmc
    from portbench.reference.friction import Friction

    field = load_mw_lmc(DATA / cfg["field"], device=device)
    return field, lambda mass_total, t_mid: Friction(field, mass_total,
                                                     ics.G, t_mid)
