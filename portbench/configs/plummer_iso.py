"""plummer_iso: an isolated equilibrium Plummer sphere (see the .json)."""
from __future__ import annotations

import numpy as np

from portbench import ics


def make_inputs(cfg, n_body, seed, device):
    """The sphere's phase space from ``seed``: float64 tensors on
    ``device``, one species of equal masses."""
    g = ics.generator(seed, device)
    pos, vel = ics.plummer_sphere(g, n_body, cfg["M_total"], cfg["a"],
                                  device)
    m = cfg["M_total"] / n_body
    return {"pos": pos, "vel": vel,
            "species": [("stars", n_body, m, cfg["softening"])],
            "mass": np.full(n_body, m), "soft": np.full(n_body,
                                                        cfg["softening"])}


def sim_kwargs(cfg, inputs):
    return {}


def program_field(cfg, device):
    return None


def reference_terms(cfg, device):
    """The reference's field and friction maker: neither, in isolation."""
    return None, None
