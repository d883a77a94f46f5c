"""King (1966) lowered-isothermal models: potential, density, sampling.

Counterpart of ``nbody_streams_tpu/fast_sims/king.py`` (NumPy/SciPy on the
host, the same ODE solution and random stream); the potential is the
port's ``MultipolePotential``.  ``KingModel.potential()`` is a bare module
on the CPU; ``make_king_potential`` builds on the card unless the caller
passes ``device='cpu'``.

The reference obtains King progenitor potentials and samples through the
Agama C++ GalaxyModel machinery (reference: fast_sims/_common.py:222-277);
here the model is solved natively: the dimensionless King ODE is
integrated host-side once, scaled to (mass, scale radius), and exposed as
a spherical MultipolePotential plus a phase-space sampler (inverse-CDF
radii + von Neumann rejection velocities from the lowered-isothermal DF).
"""
from __future__ import annotations

import numpy as np
from scipy.integrate import solve_ivp
from scipy.special import erf

from .._device import resolve_device
from ..constants import G_DEFAULT
from ..potentials.coefs import MultipoleCoefs
from ..potentials.multipole import MultipolePotential

__all__ = ["KingModel", "make_king_potential", "sample_king"]


def _king_rho_hat(w):
    """Dimensionless King density rho(w)/rho_1 for potential depth w."""
    w = np.maximum(w, 0.0)
    sw = np.sqrt(w)
    return np.where(
        w > 0,
        np.exp(w) * erf(sw) - 2.0 * sw / np.sqrt(np.pi) * (1.0 + 2.0 * w / 3.0),
        0.0,
    )


class KingModel:
    """Solve the King model for central depth W0; scale to (M, r_scale).

    ``r_scale`` is interpreted as the King core radius r_c.  Exposes
    tabulated rho(r), M(<r), Phi(r), sigma^2 and the tidal radius.
    """

    def __init__(self, W0: float, mass: float, r_core: float,
                 G: float = G_DEFAULT):
        if W0 <= 0:
            raise ValueError(f"W0 must be > 0, got {W0}")
        self.W0 = float(W0)
        self.G = float(G)

        # dimensionless solution: d/dx (x^2 dw/dx) = -9 x^2 rho(w)/rho(0)
        rho0 = _king_rho_hat(W0)

        def rhs(x, y):
            w, dw = y
            rho = _king_rho_hat(max(w, 0.0)) / rho0
            d2w = -9.0 * rho - (2.0 / max(x, 1e-12)) * dw
            return [dw, d2w]

        def hit_edge(x, y):
            return y[0]

        hit_edge.terminal = True
        hit_edge.direction = -1

        # accuracy comes from rtol/atol, not the step cap: max_step=10
        # vs 0.02 agrees to ~1e-10 in x_t and m_tot while cutting a
        # W0=17 build from ~55 s to ~0.3 s (the event is a monotonic
        # zero crossing, so a coarse cap cannot skip it)
        sol = solve_ivp(rhs, [1e-6, 1e4], [W0, 0.0], events=hit_edge,
                        max_step=10.0, rtol=1e-10, atol=1e-12,
                        dense_output=True)
        tail = None
        if sol.t_events[0].size == 0:
            # very deep model (W0 >~ 16): the tidal edge lies beyond
            # x = 1e4 core radii.  Continue from the endpoint with a
            # looser step cap — w(x) is monotonically decreasing out
            # here, so the sign-change event cannot be skipped.
            tail = solve_ivp(rhs, [1e4, 1e7], sol.y[:, -1],
                             events=hit_edge, max_step=100.0,
                             rtol=1e-10, atol=1e-12, dense_output=True)
            if tail.t_events[0].size == 0:
                raise ValueError(
                    f"King model W0={W0} is too deep: no tidal edge "
                    "within 1e7 core radii (physical King models have "
                    "W0 <~ 16; check the parameter)")

        def dense(x):
            # piecewise dense output across the (optional) continuation
            if tail is None:
                return sol.sol(x)
            x = np.asarray(x, float)
            return np.where(x <= 1e4, sol.sol(np.minimum(x, 1e4)),
                            tail.sol(np.maximum(x, 1e4)))

        x_t = float((tail if tail is not None
                     else sol).t_events[0][0])   # dimensionless tidal radius
        xs = np.geomspace(1e-4, x_t * 0.999999, 400)
        ws = dense(xs)[0]
        ws = np.maximum(ws, 0.0)
        rho_hat = _king_rho_hat(ws) / rho0       # rho / rho_0

        # cumulative mass (dimensionless): m(x) = int 9? -> from ODE,
        # x^2 dw/dx = -9 m(x)/(4 pi ...) in these units m(x) ~ -x^2 w'
        dws = dense(xs)[1]
        m_hat = -(xs**2) * dws                   # proportional to M(<x)
        m_tot_hat = float(-(x_t**2) * dense(x_t)[1])

        # physical scaling: x = r/r_c, total mass = mass
        self.r_core = float(r_core)
        self.r_tidal = x_t * self.r_core
        self.concentration = np.log10(x_t)
        mass = float(mass)
        self.mass = mass

        r = xs * self.r_core
        m_phys = mass * m_hat / m_tot_hat
        # scaling relations: rho0 = 9 M / (4 pi rc^3 m_tot_hat) and
        # sigma^2 = 4 pi G rho0 rc^2 / 9 = G M / (rc m_tot_hat)
        self.sigma2 = self.G * mass / (self.r_core * m_tot_hat)

        self.r_grid = r
        self.rho_grid = (mass / m_tot_hat) * 9.0 \
            / (4.0 * np.pi * self.r_core**3) * rho_hat
        self.m_grid = m_phys
        self.w_grid = ws                          # psi/sigma^2
        self.psi_grid = ws * self.sigma2          # relative potential

        # absolute potential: Phi(r) = -psi(r) - G M / r_t
        self.phi_grid = -(self.psi_grid + self.G * mass / self.r_tidal)
        # dPhi/dr = G M(<r) / r^2
        self.dphi_grid = self.G * m_phys / r**2

    def potential(self) -> MultipolePotential:
        """Spherical MultipolePotential for this model (Keplerian outside
        the tidal radius by construction of the outer power law)."""
        coefs = MultipoleCoefs(
            R_grid=self.r_grid, lm_labels=[(0, 0)],
            phi=self.phi_grid[:, None], dphi_dr=self.dphi_grid[:, None],
            metadata={"type": "Multipole", "symmetry": "Spherical",
                      "model": f"King W0={self.W0}"},
        )
        return MultipolePotential(coefs)

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """Sample (n, 6) phase-space points from the King DF."""
        rng = np.random.default_rng(seed)
        # radii by inverse CDF of M(<r)
        u = rng.uniform(0, 1, n) * self.m_grid[-1]
        r = np.interp(u, self.m_grid, self.r_grid)
        from ..ic import sample_isotropic

        pos = r[:, None] * sample_isotropic(rng, n)

        # velocities: f(E) ~ exp((psi - v^2/2)/s2) - 1, 0 <= v <= v_esc
        psi = np.interp(r, self.r_grid, self.psi_grid)
        v = np.empty(n)
        todo = np.arange(n)
        fmax = np.exp(psi / self.sigma2) - 1.0   # at v = 0
        while todo.size:
            vt = rng.uniform(0, 1, todo.size) * np.sqrt(2 * psi[todo])
            f = np.exp((psi[todo] - 0.5 * vt**2) / self.sigma2) - 1.0
            # weight by v^2 for the speed distribution; envelope
            # g = fmax * v^2
            accept = rng.uniform(0, 1, todo.size) * fmax[todo] * \
                (2 * psi[todo]) <= f * vt**2
            v[todo[accept]] = vt[accept]
            todo = todo[~accept]
        vel = v[:, None] * sample_isotropic(rng, n)
        return np.concatenate([pos, vel], axis=1)


def make_king_potential(mass: float, r_core: float, W0: float = 3.0,
                        G: float = G_DEFAULT,
                        device="cuda") -> MultipolePotential:
    """The King model's spherical ``MultipolePotential`` on ``device``
    (the card unless the caller passes ``device='cpu'``; without a card
    the default raises)."""
    device = resolve_device(device)
    return KingModel(W0, mass, r_core, G=G).potential().to(device)


def sample_king(n: int, mass: float, r_core: float, W0: float = 3.0,
                seed: int = 0, G: float = G_DEFAULT):
    model = KingModel(W0, mass, r_core, G=G)
    xv = model.sample(n, seed=seed)
    masses = np.full(n, mass / n)
    return xv, masses
