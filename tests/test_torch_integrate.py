"""The port's KDK integrator against the JAX package's, from one state.

A JAX ``IntegratorState`` is built and handed to the port as numpy arrays
(``from_jax_state``); both packages then take the same KDK steps.
Tolerance: 1e-6 * max |x| on positions and velocities (fp32 force sums in
another order, through 8 compensated steps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_streams_tpu import integrate as ji
from nbody_streams_tpu.ops.dispatch import DirectGravity as JDirectGravity
from nbody_streams_tpu_torch import integrate as ti
from nbody_streams_tpu_torch.ops import cuda_direct as cd
from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

torch.set_num_threads(2)

DT = 2e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def jax_run():
    """N = 256 Plummer-ish cluster: the JAX state at step 0 and after 8
    KDK steps (jnp oracle, float32 + Kahan)."""
    rng = np.random.default_rng(3)
    n = 256
    pos = rng.normal(0, 1, (n, 3))
    vel = rng.normal(0, 10.0, (n, 3))
    mass = np.full(n, 1e9 / n)
    solver = JDirectGravity(mass, np.full(n, 0.05), impl="jnp")
    accel_fn = ji.make_accel_fn(solver, solver.mass)
    step_fn = ji.make_kdk_step(accel_fn, DT, 0.0)
    s0 = ji.init_state(pos, vel, accel_fn, solver.mass, 0.0)
    arrays = {k: np.asarray(getattr(s0, k)) for k in
              ("pos", "vel", "pos_c", "vel_c", "acc", "ext_acc", "step")}
    arrays["sort_order"] = None
    s8 = ji.run_chunk(step_fn, jax.tree.map(jnp.copy, s0), 8)
    ke, pe = ji.system_energy(s8, solver, solver.mass)
    return arrays, s8, mass, (float(ke), float(pe))


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_kdk_steps_match_jax_from_one_state(jax_run, impl):
    arrays, s8, mass, _ = jax_run
    state = ti.from_jax_state(arrays, device="cpu")
    assert state.pos.dtype == torch.float32 and state.sort_order is None
    solver = DirectGravity(mass, np.full(mass.shape[0], 0.05), impl=impl,
                           device="cpu")
    step_fn = ti.make_kdk_step(ti.make_accel_fn(solver, solver.mass), DT,
                               0.0)
    out = ti.run_chunk(step_fn, state, 8)
    assert out.step == 8
    for field in ("pos", "vel", "acc"):
        assert _rel(getattr(out, field), getattr(s8, field)) < 1e-6, field


def test_system_energy_matches_jax(jax_run):
    arrays, s8, mass, (ke, pe) = jax_run
    solver = DirectGravity(mass, np.full(mass.shape[0], 0.05), impl="cuda",
                           device="cpu")
    state = ti.from_jax_state({k: np.asarray(getattr(s8, k)) for k in
                               ("pos", "vel", "pos_c", "vel_c", "acc",
                                "ext_acc", "step")}, device="cpu")
    got = ti.system_energy(state, solver, solver.mass)
    assert abs(float(got[0]) - ke) < 1e-6 * abs(ke)
    assert abs(float(got[1]) - pe) < 1e-6 * abs(pe)


def test_state_round_trip(jax_run):
    arrays, *_ = jax_run
    back = ti.to_numpy_state(ti.from_jax_state(arrays, device="cpu"))
    for k in ("pos", "vel", "pos_c", "vel_c", "acc", "ext_acc"):
        np.testing.assert_array_equal(back[k], arrays[k])
    assert int(back["step"]) == int(arrays["step"])
    assert back["sort_order"] is None
    order = np.random.default_rng(0).permutation(256).astype(np.int32)
    with_order = ti.from_jax_state(dict(arrays, sort_order=order),
                                   device="cpu")
    np.testing.assert_array_equal(
        ti.to_numpy_state(with_order)["sort_order"], order)


def test_from_jax_state_default_device_is_the_card(jax_run):
    """With no device= the state is carried onto the card: without one it
    raises, naming the CPU option."""
    arrays, *_ = jax_run
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ti.from_jax_state(arrays)
    assert ti.from_jax_state(arrays, device="cpu").pos.device.type == "cpu"


class _SortedCuda(DirectGravity):
    """Force the sorted two-pass path at a small N (band geometry
    tm=64, tn=128, so the band is a strict subset of the rows)."""

    spatial_sort_active = True

    def accel(self, pos, order=None):
        return cd.cuda_accel(pos, self.mass, self.softening, self.G,
                             self.kernel, self.kahan, self.eps2,
                             spatial_sort=True, order=order, tm=64, tn=128)


def test_presort_per_chunk_matches_sort_per_call():
    """One slab sort per chunk carried in the state matches sorting in
    every force call (mirrors the JAX package's
    test_run_chunk_presort_matches_per_call_sort)."""
    rng = np.random.default_rng(3)
    n = 3072
    pos = rng.normal(0, 1, (n, 3))
    vel = rng.normal(0, 10.0, (n, 3))
    solver = _SortedCuda(np.full(n, 1e9 / n), np.full(n, 0.02), device="cpu")
    accel_fn = ti.make_accel_fn(solver, solver.mass)
    step_fn = ti.make_kdk_step(accel_fn, DT, 0.0)
    before = dict(cd.BRANCHES)
    per_call = ti.run_chunk(
        step_fn, ti.init_state(pos, vel, accel_fn, solver.mass, 0.0,
                               device="cpu"), 4)
    s1 = ti.init_state(pos, vel, accel_fn, solver.mass, 0.0,
                       sort_fn=solver.sort_key, device="cpu")
    presorted = ti.run_chunk(step_fn, s1, 4, presort=True)
    assert cd.BRANCHES["two_pass"] >= before["two_pass"] + 10
    order = presorted.sort_order.numpy()
    assert np.array_equal(np.sort(order), np.arange(n))
    for field in ("pos", "vel"):
        assert _rel(getattr(presorted, field),
                    getattr(per_call, field)) < 1e-6, field


def test_run_chunk_refreshes_order_every_k_steps():
    n = 64
    solver = DirectGravity(np.full(n, 1.0), 0.05, impl="torch",
                           device="cpu")
    seen = []
    base = ti.make_kdk_step(ti.make_accel_fn(solver, solver.mass), DT, 0.0)

    def step_fn(state):
        seen.append(state.sort_order)
        return base(state)

    rng = np.random.default_rng(1)
    s0 = ti.init_state(rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
                       ti.make_accel_fn(solver, solver.mass), solver.mass,
                       0.0, device="cpu")
    ti.run_chunk(step_fn, s0, 5, presort=True, presort_every=2)
    fresh = [i for i in range(1, 5) if seen[i] is not seen[i - 1]]
    assert seen[0] is not None and fresh == [2, 4]


def test_external_and_extra_hooks_are_added():
    """The duck-typed external potential (refreshed every k steps) and
    force_extra terms add to self gravity."""
    n = 32
    solver = DirectGravity(np.full(n, 1.0), 0.05, impl="torch",
                           device="cpu")
    calls = []

    class Uniform:
        def force(self, pos, t):
            calls.append(t)
            return torch.ones_like(pos)

    class Extra(ti.ForceExtra):
        needs_phi = True

        def init_state(self, pos, vel, mass, t):
            return 0

        def __call__(self, state, pos, vel, mass, t, phi=None, step=0):
            assert phi is not None and phi.shape == (n,)
            return 2.0 * torch.ones_like(pos), state + 1

    accel = ti.make_accel_fn(solver, solver.mass, Uniform(), 2, Extra())
    pos = torch.randn(n, 3)
    acc, ext, st = accel(pos, pos, 0.0, 1, torch.zeros(n, 3), 0)
    self_g = solver.accel(pos)
    assert torch.allclose(acc, self_g + 2.0) and st == 1 and not calls
    acc, ext, st = accel(pos, pos, 0.0, 2, ext, st)
    assert torch.allclose(acc, self_g + 3.0) and len(calls) == 1
    state = ti.init_state(pos.numpy(), pos.numpy(), accel, solver.mass, 0.0,
                          start_step=3, dt=DT, force_extra=Extra(),
                          device="cpu")
    assert len(calls) == 2        # refreshed at init despite 3 % 2 != 0
    assert dataclasses.asdict(state)["step"] == 3
