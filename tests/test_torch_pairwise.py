"""The port's plain-torch oracle against the JAX package's jnp oracle.

Inputs are made with numpy from a seed.  Tolerances: 1e-12 * max in fp64
(the same blocked sums in another order); 3e-6 * max for the fp32 Kahan tier
against the fp64 oracle (the JAX package's kernel-vs-oracle tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_streams_tpu.ops import pairwise as jp
from nbody_streams_tpu_torch.ops import pairwise as tp

torch.set_num_threads(2)

KINDS = ["newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline"]
G = 4.3e-6


@pytest.fixture(scope="module")
def cluster():
    rng = np.random.default_rng(7)
    n = 300
    pos = rng.normal(0, 1, (n, 3))
    mass = rng.uniform(0.5, 2.0, n) * 1e5
    soft = rng.uniform(0.05, 0.3, n)
    soft[:20] = 0.0
    return pos, mass, soft


def _max_err(got, want):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kind", KINDS)
def test_forces_fp64_match_jax(cluster, kind):
    pos, mass, soft = cluster
    want = jp.compute_forces_direct(pos, mass, soft, G=G, kernel=kind,
                                    precision="float64", block_size=128)
    got = tp.compute_forces_direct(pos, mass, soft, G=G, kernel=kind,
                                   precision="float64", block_size=128,
                                   device="cpu")
    assert got.dtype == torch.float64 and got.shape == (300, 3)
    assert _max_err(got, want) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
def test_potential_fp64_match_jax(cluster, kind):
    pos, mass, soft = cluster
    want = jp.compute_potential_direct(pos, mass, soft, G=G, kernel=kind,
                                       precision="float64", block_size=128)
    got = tp.compute_potential_direct(pos, mass, soft, G=G, kernel=kind,
                                      precision="float64", block_size=128,
                                      device="cpu")
    assert got.shape == (300,)
    assert _max_err(got, want) < 1e-12


@pytest.mark.parametrize("mode", ["acc", "pot"])
def test_kahan_fp32_within_3e6_of_fp64(cluster, mode):
    pos, mass, soft = cluster
    fn_t, fn_j = ((tp.compute_forces_direct, jp.compute_forces_direct)
                  if mode == "acc" else
                  (tp.compute_potential_direct, jp.compute_potential_direct))
    want = fn_j(pos, mass, soft, G=G, kernel="spline", precision="float64")
    got = fn_t(pos, mass, soft, G=G, kernel="spline",
               precision="float32_kahan", block_size=64, device="cpu")
    assert got.dtype == torch.float32
    assert _max_err(got, want) < 3e-6


def test_tiles_and_kahan_add_match_jax(cluster):
    pos, mass, soft = cluster
    idx = np.arange(pos.shape[0], dtype=np.int32)
    t, s = slice(0, 100), slice(50, 300)
    args = (pos[t], soft[t], idx[t], pos[s], mass[s], soft[s], idx[s])
    for name in ("accel_tile", "potential_tile"):
        want = getattr(jp, name)("spline", *map(jnp.asarray, args))
        got = getattr(tp, name)("spline", *map(torch.tensor, args))
        assert _max_err(got, want) < 1e-12, name
    rng = np.random.default_rng(3)
    tot, comp, delta = rng.normal(size=(3, 8)).astype(np.float32)
    for g, w in zip(tp.kahan_add(*map(torch.tensor, (tot, comp, delta))),
                    jp.kahan_add(*map(jnp.asarray, (tot, comp, delta)))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scalar_mass_and_softening_broadcast(cluster):
    pos, _, _ = cluster
    a = tp.compute_forces_direct(pos, 1e5, 0.1, precision="float64",
                                 device="cpu")
    b = tp.compute_forces_direct(pos, np.full(300, 1e5), np.full(300, 0.1),
                                 precision="float64", device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="pos must be"):
        tp.compute_forces_direct(pos[:, :2], 1.0, device="cpu")


def test_numpy_input_goes_to_the_card_by_default(cluster):
    """Numpy input runs on the card unless device= says otherwise: without
    a card the default raises, naming the CPU option.  A tensor keeps its
    own device."""
    pos, mass, soft = cluster
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (tp.compute_forces_direct, tp.compute_potential_direct):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(pos, mass, soft)
        got = fn(torch.tensor(pos), mass, soft, precision="float64")
        assert got.device.type == "cpu"
