"""Chandrasekhar dynamical friction as a ``ForceExtra`` on device tensors.

Counterpart of ``nbody_streams_tpu/friction.py``.  The term — the
shrinking-sphere or bound-particle centre, the kinematic predictor between
full updates, the sigma(r) lookup and BT2008 eq. 8.13 — runs on the state's
device inside the KDK step, its state a dict of tensors.  Where the JAX
package selects the full update or the predictor with ``lax.cond`` on the
device step counter, the port's step counter is a Python int and the choice
is a host ``if``; the step's time ``t`` is a Python float, and so is the
stored ``t_prev``.  Nothing in ``__call__`` reads a device value back.

On the card the one-point work of a call (the density at the centre,
sigma(r) and eq. 8.13: ~21,000 small launches in the MW+LMC field) is
captured as one CUDA graph at a run's second call and replayed at every
later one, where the JAX package runs the same ops as one jitted program.
Its time enters the graph as a 0-dim float64 tensor, so the field's
trajectory tables take their batched, device-side path; a potential that
reads a device value back cannot be captured, and its run stays eager
(``GRAPHS`` counts both).  On the CPU every call is eager.

Physics (as the JAX package):

* a_DF = -4 pi G^2 M_sat rho ln(Lambda)/v^2 [erf(X) - 2X/sqrt(pi)
  exp(-X^2)] v_hat with X = v/(sqrt(2) sigma(r))
* Coulomb log 'variable' ln(r v^2/(G M_sat)) clipped at ln(1.1), or
  'fixed'
* Read+2006 core-stalling suppression min(1, (r/r_core)^gamma)
* sigma(r): the isotropic Jeans integral or the Eddington-inversion
  moments ('quasispherical'), tabulated once on the host in float64 into a
  clamped log-log spline; or 'local_circular', sqrt(r |g_r| / 2) from the
  potential at each call
* the centre: a fixed-iteration shrinking sphere every
  ``update_interval`` steps (DF applied within ``apply_radius_factor`` x
  the sphere), or with ``com_method='bound_phi'`` the median phase-space
  point of the particles bound in the self-gravity potential (DF applied
  to the bound particles, the bound mass as M_sat)

The median is NaN-aware and averages the two middle values of an even
count, as ``jnp.nanmedian`` does (``torch.nanmedian`` returns the lower).
"""
from __future__ import annotations

import copy
import math
import warnings

import numpy as np
import torch

from .constants import G_DEFAULT
from .integrate import ForceExtra
from .telemetry import span
from .utils.interp import spline_coeffs

__all__ = [
    "GRAPHS",
    "ChandrasekharFriction",
    "make_df_force_extra",
    "chandrasekhar_accel",
    "chandrasekhar_friction",
    "compute_sigma_r",
    "shrinking_sphere_com",
    "bound_center_phi",
]


#: the centre term's CUDA graphs in this process: ``captured`` (one a run on
#: the card), ``replayed`` (one a friction call after that), ``fallback``
#: (captures that raised: those runs stay eager)
GRAPHS = {"captured": 0, "replayed": 0, "fallback": 0}


def _np(x):
    """A potential's output as a float64 numpy array (tensors may sit on
    the card)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, float)


def _host_copy(pot):
    """A float64 CPU copy of a torch potential for host tabulation; any
    other object is used as it is."""
    if isinstance(pot, torch.nn.Module):
        return copy.deepcopy(pot).to("cpu", torch.float64)
    return pot


# ---------------------------------------------------------------------------
# sigma(r)
# ---------------------------------------------------------------------------

def _local_circular(pot, r, t):
    p = torch.stack([r, torch.zeros_like(r), torch.zeros_like(r)], -1)
    gr = pot.force(p, t)[..., 0]
    return torch.sqrt(torch.clamp_min(0.5 * r * gr.abs(), 1e-12))


def _sigma_table(pot, t_eval, grid_r, method):
    """(ln r, ln sigma) tables of the 'jeans' and 'quasispherical'
    methods, in float64 on the host."""
    r = (np.asarray(grid_r, float) if grid_r is not None
         else np.geomspace(1e-2, 2e3, 200))
    if method == "quasispherical":
        # extend outward: the Eddington integral sweeps psi -> 0, i.e.
        # radii beyond any truncated grid (see the JAX package)
        r = np.concatenate([r, np.geomspace(r.max() * 1.25,
                                            r.max() * 1e3, 32)])
    pts = np.column_stack([r, np.zeros_like(r), np.zeros_like(r)])
    rho = np.maximum(_np(pot.density(pts, t=t_eval)), 1e-300)

    if method == "quasispherical":
        psi = -_np(pot.potential(pts, t=t_eval))
        if np.any(np.diff(psi) >= 0):
            raise ValueError(
                "quasispherical sigma needs psi = -Phi monotonically "
                "decreasing in r (is the potential spherical-ish?)")
        if psi[-1] <= 0:
            raise ValueError(
                "quasispherical sigma needs psi = -Phi > 0 on the whole "
                f"grid (psi({r[-1]:.3g}) = {psi[-1]:.3g}): the Eddington "
                "inversion assumes the Agama zero-point Phi(inf) = 0 — "
                "re-anchor the potential (e.g. subtract Phi at a large "
                "radius) or pass a tighter grid_r")
        from scipy.interpolate import CubicSpline

        rho_of_psi = CubicSpline(psi[::-1], rho[::-1])
        _d2 = rho_of_psi.derivative(2)
        psi_lo = psi[-1]

        def d2rho(p):
            # zero-fill below the tabulated range instead of cubic
            # extrapolation
            return np.where(p >= psi_lo, _d2(np.maximum(p, psi_lo)), 0.0)

        # f(E) on the psi grid; psi = E(1 - u^2) removes the endpoint
        # singularity
        u, wu = np.polynomial.legendre.leggauss(64)
        u = 0.5 * (u + 1.0)
        wu = 0.5 * wu
        e_grid = psi[::-1]
        vals = d2rho(e_grid[:, None] * (1.0 - u[None, :] ** 2))
        f_e = (2.0 * np.sqrt(e_grid) * (vals * wu[None, :]).sum(1)
               / (np.sqrt(8.0) * np.pi ** 2))
        f_e = np.maximum(f_e, 0.0)
        # piecewise-linear ln f(ln E)
        ln_e_tab = np.log(e_grid)
        ln_f_tab = np.log(f_e + 1e-300)

        def ln_f(e):
            return np.interp(np.log(np.maximum(e, e_grid[0])),
                             ln_e_tab, ln_f_tab)

        vq, wv = np.polynomial.legendre.leggauss(96)
        vq = 0.5 * (vq + 1.0)
        wv = 0.5 * wv
        sigma2 = np.empty_like(r)
        for i, ps in enumerate(psi):
            vmax = np.sqrt(2.0 * ps)
            v = vmax * vq
            fE = np.exp(ln_f(np.maximum(ps - 0.5 * v * v, e_grid[0])))
            m2 = (fE * v ** 2 * wv).sum() * vmax
            m4 = (fE * v ** 4 * wv).sum() * vmax
            sigma2[i] = m4 / (3.0 * m2) if m2 > 0 else 0.0
        sigma_tab = np.sqrt(np.maximum(sigma2, 1e-12))
        lnr = np.log(r)
    else:
        g_r = np.abs(_np(pot.force(pts, t=t_eval))[:, 0])
        # integrate rho*g from the outside in (log-spaced trapezoid)
        integrand = rho * g_r * r
        lnr = np.log(r)
        seg = 0.5 * (integrand[1:] + integrand[:-1]) * np.diff(lnr)
        cum_out = np.concatenate([np.cumsum(seg[::-1])[::-1], [0.0]])
        sigma_tab = np.sqrt(np.maximum(cum_out / rho, 1e-12))
    return lnr, np.log(sigma_tab)


class _SplineSigma:
    """sigma(r) = exp(spline(ln max(r, 1e-10))): a float64 PPoly, moved
    to the caller's device with ``to``; evaluated in float64 and returned
    in the dtype of ``r``."""

    def __init__(self, spline):
        self.spline = spline

    def to(self, device):
        out = copy.copy(self)
        out.spline = copy.deepcopy(self.spline).to(device)
        return out

    def __call__(self, rq, t=None):
        if not isinstance(rq, torch.Tensor):
            rq = torch.as_tensor(np.asarray(rq, float),
                                 device=self.spline.c.device)
        # at least 1-D: indexing the tables with a 0-dim index tensor
        # would read it back to the host
        x = torch.log(torch.clamp_min(rq.to(torch.float64), 1e-10))
        sig = torch.exp(self.spline(x.reshape(-1)))
        return sig.reshape(rq.shape).to(rq.dtype)


def compute_sigma_r(pot, t_eval: float = 0.0, grid_r=None,
                    method: str = "jeans"):
    """Radial velocity dispersion profile as a callable ``sigma(r, t)``.

    'jeans': sigma_r^2(r) = (1/rho) int_r^inf rho(s) |g_r(s)| ds;
    'quasispherical': Eddington-inversion DF moments; both tabulated once
    on the host from a float64 CPU copy of ``pot`` (clamped log-log
    spline, ``utils.interp.spline_coeffs``).  'local_circular':
    sqrt(r |g_r| / 2) from ``pot`` at each call."""
    if method not in ("jeans", "local_circular", "quasispherical"):
        raise ValueError(f"unknown sigma method {method!r}")
    if method == "local_circular":
        def sigma(r, t=t_eval):
            if not isinstance(r, torch.Tensor):
                buf = (next(pot.buffers(), None)
                       if isinstance(pot, torch.nn.Module) else None)
                r = torch.as_tensor(np.asarray(r, float),
                                    device=None if buf is None else buf.device)
            return _local_circular(pot, r, t)

        return sigma
    lnr, ln_sig = _sigma_table(_host_copy(pot), t_eval, grid_r, method)
    return _SplineSigma(spline_coeffs(lnr, ln_sig, extrapolate="clamp"))


# ---------------------------------------------------------------------------
# CoM finders
# ---------------------------------------------------------------------------

def _nanmedian0(x):
    """Column medians of (N, K) ``x`` ignoring NaN; an even count averages
    the two middle values (``jnp.nanmedian``).  Sort and gather on the
    device, no host read (NaN sorts last)."""
    s, _ = torch.sort(x, dim=0)
    k = (~torch.isnan(x)).sum(0, keepdim=True)
    lo = torch.gather(s, 0, torch.clamp_min(k - 1, 0) // 2)
    hi = torch.gather(s, 0, k // 2)
    return (0.5 * (lo + hi))[0]


def bound_center_phi(pos, vel, mass, phi, r_prev, v_prev, dt,
                     r_max: float = 10.0, n_iter: int = 10):
    """Phi-energy iterative bound-particle centre.

    Predict the centre kinematically, take the median phase-space point of
    the particles bound (phi + |v - v_com|^2/2 < 0) within ``r_max``,
    iterate ``n_iter`` times (fewer than 2 such particles: all of them).
    Returns (r_com, v_com, bound_mask, M_bound)."""
    xv = torch.cat([pos, vel], 1)
    center = torch.cat([r_prev + v_prev * dt, v_prev])
    nan = torch.full((), float("nan"), dtype=xv.dtype, device=xv.device)
    for _ in range(n_iter):
        dr2 = ((pos - center[:3]) ** 2).sum(1)
        vrel2 = ((vel - center[3:]) ** 2).sum(1)
        bound = (phi + 0.5 * vrel2) < 0.0
        use = bound & (dr2 < r_max * r_max)
        use = use | (use.sum() < 2)
        center = _nanmedian0(torch.where(use[:, None], xv, nan))
    vrel2 = ((vel - center[3:]) ** 2).sum(1)
    bound = (phi + 0.5 * vrel2) < 0.0
    m_bound = (mass * bound).sum()
    return center[:3], center[3:], bound, m_bound


def shrinking_sphere_com(pos, vel, mass, n_iter: int = 5,
                         frac: float = 0.5):
    """Fixed-iteration shrinking-sphere centre: (r_com, v_com, r_sphere).

    Start from the global centre of mass, shrink the aperture by ``frac``
    ``n_iter`` times, recomputing the mass-weighted centre of the enclosed
    particles (an empty aperture keeps the previous centre and radius)."""
    m = mass
    com = (pos * m[:, None]).sum(0) / m.sum()
    r = torch.linalg.norm(pos - com, dim=1).max()
    for _ in range(n_iter):
        r_new = r * frac
        d = torch.linalg.norm(pos - com, dim=1)
        w = m * (d <= r_new)
        wsum = w.sum()
        ok = wsum > 0
        com = torch.where(ok, (pos * w[:, None]).sum(0)
                          / torch.clamp_min(wsum, 1e-300), com)
        r = torch.where(ok, r_new, r)
    d = torch.linalg.norm(pos - com, dim=1)
    w = m * (d <= r)
    wsum = torch.clamp_min(w.sum(), 1e-300)
    v_com = (vel * w[:, None]).sum(0) / wsum
    return com, v_com, r


# ---------------------------------------------------------------------------
# The friction formula
# ---------------------------------------------------------------------------

def chandrasekhar_accel(r_com, v_com, M_sat, rho, sigma, t, G=G_DEFAULT,
                        coulomb_mode: str = "variable",
                        fixed_ln_lambda: float = 3.0,
                        core_gamma: float = 0.0, r_core: float = 1.0):
    """BT2008 eq. 8.13 DF acceleration at the centre.

    ``r_com``/``v_com`` may be (3,) or (N, 3) (with ``rho``/``sigma``
    scalar or (N,)): norms are taken along the last axis.  Tensors,
    arrays or Python numbers; the result is a tensor on ``v_com``'s
    device (float64 on the CPU for array input).  Python numbers stay
    host scalars, so nothing is copied to the card."""
    dev = v_com.device if isinstance(v_com, torch.Tensor) else None

    def tt(x):
        if isinstance(x, torch.Tensor) or (dev is not None
                                           and np.ndim(x) == 0):
            return x
        return torch.as_tensor(np.asarray(x, float), device=dev)

    def cmin(x, lo):
        return (torch.clamp_min(x, lo) if isinstance(x, torch.Tensor)
                else max(float(x), lo))

    r_com, v_com, M_sat, rho, sigma = map(tt, (r_com, v_com, M_sat, rho,
                                               sigma))
    r = torch.linalg.norm(r_com, dim=-1)
    v = torch.linalg.norm(v_com, dim=-1)
    v_safe = torch.clamp_min(v, 1e-6)
    x = v_safe / (math.sqrt(2.0) * cmin(sigma, 1e-6))
    if coulomb_mode == "fixed":
        ln_lambda = torch.full_like(r, float(fixed_ln_lambda))
    else:
        b_min = G * M_sat / (v_safe ** 2 + 1e-30)
        ln_lambda = torch.log(torch.clamp_min(r / (b_min + 1e-9), 1.1))
    bracket = torch.erf(x) - (2.0 / math.sqrt(math.pi)) * x * torch.exp(-x * x)
    a_mag = (4.0 * math.pi * G * G * M_sat * rho * ln_lambda * bracket
             / v_safe ** 2)
    if core_gamma > 0.0:
        a_mag = a_mag * torch.clamp_max((r / r_core) ** core_gamma, 1.0)
    a = -(v_com / v_safe[..., None]) * a_mag[..., None]
    # vanish when the satellite is at rest or at the exact centre
    live = ((r > 1e-6) & (v > 1e-6))[..., None]
    return torch.where(live, a, torch.zeros_like(a))


def chandrasekhar_friction(r_com, v_com, M_sat, pot, sigma_func, t,
                           coulomb_mode: str = "variable",
                           fixed_ln_lambda: float = 3.0,
                           core_gamma: float = 0.0, r_core: float = 1.0,
                           G: float = G_DEFAULT):
    """The host form: the local density from ``pot``, the dispersion from
    ``sigma_func(r)``, then BT2008 eq. 8.13.  Returns a numpy (3,) array;
    the on-device term is :class:`ChandrasekharFriction`."""
    r_com = np.asarray(r_com, float)
    v_com = np.asarray(v_com, float)
    r = float(np.linalg.norm(r_com))
    v = float(np.linalg.norm(v_com))
    if r < 1e-6 or v < 1e-6:
        return np.zeros(3)
    rho = float(_np(pot.density(r_com, t)).ravel()[0])
    sigma = float(_np(sigma_func(r)).ravel()[0])
    return _np(chandrasekhar_accel(
        r_com, v_com, M_sat, rho, sigma, t, G=G,
        coulomb_mode=coulomb_mode, fixed_ln_lambda=fixed_ln_lambda,
        core_gamma=core_gamma, r_core=r_core))


# ---------------------------------------------------------------------------
# ForceExtra
# ---------------------------------------------------------------------------

class _CentreGraph:
    """``fn(r_com, v_com, m_eff, t) -> a_df`` captured as one CUDA graph.

    The capture runs on a side stream that waits for the caller's, so the
    host records it while the device works through what is queued.  Its
    inputs are static copies: ``t`` a float64 0-dim tensor, ``m_eff`` a
    tensor where it is one and else a constant of the graph.  A call fills
    them, replays on the current stream and returns a copy of the output,
    so nothing the caller keeps aliases the graph's memory.  Capture
    raises where ``fn`` reads a device value back to the host."""

    def __init__(self, fn, r_com, v_com, m_eff, t):
        dev = r_com.device
        self.r_com, self.v_com = r_com.clone(), v_com.clone()
        self.mass_input = isinstance(m_eff, torch.Tensor)
        self.m_eff = m_eff.clone() if self.mass_input else m_eff
        self.t = torch.full((), float(t), dtype=torch.float64, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin()
                try:
                    self.out = fn(self.r_com, self.v_com, self.m_eff, self.t)
                finally:
                    self.graph.capture_end()
        finally:
            main.wait_stream(side)

    def __call__(self, r_com, v_com, m_eff, t):
        self.r_com.copy_(r_com)
        self.v_com.copy_(v_com)
        if self.mass_input:
            self.m_eff.copy_(m_eff)
        self.t.fill_(float(t))
        self.graph.replay()
        return self.out.clone()


class ChandrasekharFriction(ForceExtra):
    """The DF ``ForceExtra`` with the centre carried in its state.

    ``pot`` is the host potential (any object with ``density``; ``force``
    too for 'local_circular').  ``to(device, dtype)`` returns a copy whose
    potential (a deep copy of a torch module) and sigma table sit on the
    run's device, the potential in the state's dtype; ``run_nbody`` calls
    it, so the caller's object is left as it is."""

    def __init__(self, pot, M_sat: float, G: float = G_DEFAULT,
                 coulomb_mode: str = "variable",
                 fixed_ln_lambda: float = 3.0, core_gamma: float = 0.0,
                 r_core: float = 1.0, update_interval: int = 10,
                 sigma_method: str = "jeans", apply_radius_factor=2.0,
                 shrink_n_iter: int = 5, shrink_frac: float = 0.5,
                 sigma_grid_r=None, t_start: float = 0.0,
                 t_end: float = 0.0, com_method: str = "shrinking_sphere",
                 bound_r_max: float = 10.0):
        if M_sat <= 0:
            raise ValueError(f"M_sat must be positive, got {M_sat}")
        if update_interval < 1:
            raise ValueError(
                f"update_interval must be >= 1, got {update_interval}")
        if com_method not in ("shrinking_sphere", "bound_phi"):
            raise ValueError(
                f"com_method must be 'shrinking_sphere' or 'bound_phi', "
                f"got {com_method!r}")
        self.com_method = com_method
        self.bound_r_max = float(bound_r_max)
        #: the integrator computes the self-gravity potential each step
        #: (one more pass of the direct kernels) when this is True
        self.needs_phi = com_method == "bound_phi"
        self.pot = pot
        self.M_sat = float(M_sat)
        self.G = float(G)
        self.coulomb_mode = coulomb_mode
        self.fixed_ln_lambda = float(fixed_ln_lambda)
        self.core_gamma = float(core_gamma)
        self.r_core = float(r_core)
        self.update_interval = int(update_interval)
        self.apply_radius_factor = apply_radius_factor
        self.shrink_n_iter = int(shrink_n_iter)
        self.shrink_frac = float(shrink_frac)
        self.sigma_method = sigma_method
        self.t_mid = 0.5 * (t_start + t_end)
        self.sigma = compute_sigma_r(pot, t_eval=self.t_mid,
                                     grid_r=sigma_grid_r,
                                     method=sigma_method)
        self._reset_graph()

    def _reset_graph(self):
        # None: not captured yet (the first call on the card is eager, the
        # second captures); False: capture raised, eager for good
        self._graph = None
        self._warm = False

    def to(self, device=None, dtype=None):
        """A copy on ``device`` with the potential in ``dtype`` (and a
        CUDA graph of its own, captured at its second call on the
        card)."""
        out = copy.copy(self)
        out._reset_graph()
        if isinstance(self.pot, torch.nn.Module):
            out.pot = copy.deepcopy(self.pot).to(device=device, dtype=dtype)
        if isinstance(self.sigma, _SplineSigma):
            out.sigma = self.sigma.to(device)
        else:
            out.sigma = compute_sigma_r(out.pot, t_eval=self.t_mid,
                                        method="local_circular")
        return out

    def init_state(self, pos, vel, mass, t):
        com, v_com, r_sph = shrinking_sphere_com(
            pos, vel, mass, self.shrink_n_iter, self.shrink_frac)
        state = {
            "r_com": com,
            "v_com": v_com,
            "r_sphere": r_sph,
            "a_df": torch.zeros_like(com),
            "t_prev": float(t),
        }
        if self.com_method == "bound_phi":
            state["m_bound"] = torch.full((), self.M_sat, dtype=pos.dtype,
                                          device=pos.device)
            state["bound"] = torch.ones(pos.shape[0], dtype=torch.bool,
                                        device=pos.device)
        return state

    def _centre_term(self, r_com, v_com, m_eff, t):
        """The one-point work of a call: the density at the centre,
        sigma(r) and BT2008 eq. 8.13."""
        r = torch.linalg.norm(r_com)
        rho = self.pot.density(r_com, t=t)
        sig = self.sigma(r, t=t)
        return chandrasekhar_accel(
            r_com, v_com, m_eff, rho, sig, t, G=self.G,
            coulomb_mode=self.coulomb_mode,
            fixed_ln_lambda=self.fixed_ln_lambda,
            core_gamma=self.core_gamma, r_core=self.r_core)

    def _centre_accel(self, r_com, v_com, m_eff, t):
        """``_centre_term``, from its CUDA graph where the state is on the
        card, from the second call on (see the module)."""
        graph = self._graph
        if graph is None and self._warm:
            try:
                graph = _CentreGraph(self._centre_term, r_com, v_com, m_eff,
                                     t)
                GRAPHS["captured"] += 1
            except Exception as exc:    # any failure to capture: eager
                warnings.warn(f"friction: the centre term could not be "
                              f"captured as a CUDA graph ({exc!r}); this "
                              f"run stays eager", RuntimeWarning)
                graph = False
                GRAPHS["fallback"] += 1
            self._graph = graph
        if graph and graph.mass_input == isinstance(m_eff, torch.Tensor):
            GRAPHS["replayed"] += 1
            with span("friction.replay"):
                return graph(r_com, v_com, m_eff, t)
        self._warm = r_com.is_cuda
        return self._centre_term(r_com, v_com, m_eff, t)

    def __call__(self, state, pos, vel, mass, t, phi=None, step=0):
        dt = float(t) - state["t_prev"]
        use_phi = self.com_method == "bound_phi" and phi is not None
        refresh = int(step) % self.update_interval == 0
        r_sph = state["r_sphere"]
        m_bound = state.get("m_bound")
        bound = state.get("bound")
        if refresh and use_phi:
            with span("friction.centre"):
                r_com, v_com, bound, m_bound = bound_center_phi(
                    pos, vel, mass, phi, state["r_com"], state["v_com"], dt,
                    r_max=self.bound_r_max)
        elif refresh:
            with span("friction.centre"):
                r_com, v_com, r_sph = shrinking_sphere_com(
                    pos, vel, mass, self.shrink_n_iter, self.shrink_frac)
        else:
            a = state["a_df"]
            r_com = state["r_com"] + state["v_com"] * dt + 0.5 * a * dt * dt
            v_com = state["v_com"] + a * dt
        if use_phi:
            # the bound mass tracks tidal stripping, floored at 1e-4 M_sat
            m_eff = torch.clamp_min(m_bound, 1e-4 * self.M_sat)
        else:
            m_eff = self.M_sat

        with span("friction.density"):
            a_df = self._centre_accel(r_com, v_com, m_eff, t).to(pos.dtype)

        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        if use_phi:
            acc = torch.where(bound[:, None], a_df[None, :], zero)
        elif self.apply_radius_factor is not None:
            cutoff = self.apply_radius_factor * r_sph
            d = torch.linalg.norm(pos - r_com, dim=1)
            acc = torch.where((d <= cutoff)[:, None], a_df[None, :], zero)
        else:
            acc = a_df.expand(pos.shape)

        new_state = {
            "r_com": r_com,
            "v_com": v_com,
            "r_sphere": r_sph,
            "a_df": a_df,
            "t_prev": float(t),
        }
        if self.com_method == "bound_phi":
            new_state["m_bound"] = m_bound
            new_state["bound"] = bound
        return acc, new_state


def make_df_force_extra(pot, M_sat: float, **kwargs) -> ChandrasekharFriction:
    """A :class:`ChandrasekharFriction` applying Chandrasekhar friction to
    the satellite's centre-of-mass motion (the reference surface)."""
    return ChandrasekharFriction(pot, M_sat, **kwargs)
