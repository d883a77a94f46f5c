"""Softening laws of the torch port against the JAX package, in fp64.

The same (r^2, h) grids, made with numpy from a seed, go through
``nbody_streams_tpu.ops.kernels`` and ``nbody_streams_tpu_torch.ops.kernels``
(and the per-particle ``pre`` forms the kernels use).  Tolerance: 1e-12
relative, i.e. a few ulps of fp64 through the polynomial and the cube.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_streams_tpu.ops import kernels as jk
from nbody_streams_tpu.ops import pallas_direct as jpd
from nbody_streams_tpu_torch.ops import cuda_direct as tcd
from nbody_streams_tpu_torch.ops import kernels as tk

torch.set_num_threads(2)

KINDS = ["newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline"]
RTOL = 1e-12


def _grid():
    """r^2 and h with h = 0 entries and q = r/h near 0, 0.5 and 1."""
    rng = np.random.default_rng(101)
    h = np.concatenate([rng.uniform(0.01, 1.0, 400), np.zeros(50),
                        np.full(150, 0.3)])
    q = np.concatenate([rng.uniform(0.0, 3.0, 400), rng.uniform(0.1, 2, 50),
                        0.5 + np.linspace(-1e-6, 1e-6, 50),
                        1.0 + np.linspace(-1e-6, 1e-6, 50),
                        np.linspace(1e-9, 1e-3, 50)])
    r = np.where(h > 0, q * h, q)
    return r * r + 1e-15, h


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_force_factor_matches_jax(kind):
    r2, h = _grid()
    _close(tk.force_factor(kind, torch.tensor(r2), torch.tensor(h)),
           jk.force_factor(kind, jnp.asarray(r2), jnp.asarray(h)))


@pytest.mark.parametrize("kind", KINDS)
def test_potential_factor_matches_jax(kind):
    r2, h = _grid()
    _close(tk.potential_factor(kind, torch.tensor(r2), torch.tensor(h)),
           jk.potential_factor(kind, jnp.asarray(r2), jnp.asarray(h)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["acc", "pot"])
def test_pre_form_factors_match_jax(kind, mode):
    """The kernels' per-particle form (1/h for the spline, h^2 otherwise;
    h = 0 gives 1/h = inf and must select the Newtonian branch)."""
    r2, h = _grid()
    pre_t = tcd._soft_pre(kind, torch.tensor(h))
    pre_j = jpd._soft_pre(kind, jnp.asarray(h))
    np.testing.assert_array_equal(pre_t.numpy(), np.asarray(pre_j))
    t_fn, j_fn = ((tcd._force_pre, jpd._force_pre) if mode == "acc"
                  else (tcd._pot_pre, jpd._pot_pre))
    _close(t_fn(kind, torch.tensor(r2), pre_t),
           j_fn(kind, jnp.asarray(r2), pre_j))


def test_spline_potential_q2_nesting_is_continuous():
    """The q^2 nesting of the inner spline potential (the JAX package's,
    not the CUDA reference's q^4) is continuous at q = 0.5."""
    h = torch.tensor([1.0, 1.0], dtype=torch.float64)
    r = torch.tensor([0.5 - 1e-9, 0.5 + 1e-9], dtype=torch.float64)
    u = tk.potential_factor("spline", r * r, h)
    assert abs(float(u[0] - u[1])) < 1e-7
