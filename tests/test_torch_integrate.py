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
    assert state.pos.dtype == torch.float32
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
    # the JAX state's slab order is accepted and left to the solver
    order = np.random.default_rng(0).permutation(256).astype(np.int32)
    with_order = ti.to_numpy_state(ti.from_jax_state(
        dict(arrays, sort_order=order), device="cpu"))
    assert set(with_order) == set(back) and "sort_order" not in back
    for k in ("pos", "vel", "pos_c", "vel_c", "acc", "ext_acc"):
        np.testing.assert_array_equal(with_order[k], arrays[k])


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

    def accel(self, pos):
        return cd.cuda_accel(pos, self.mass, self.softening, self.G,
                             self.kernel, self.kahan, self.eps2,
                             spatial_sort=True, tm=64, tn=128)


def _sorted_case(seed, n, spread, sigma, soft):
    rng = np.random.default_rng(seed)
    solver = _SortedCuda(np.full(n, 1e9 / n), np.full(n, soft),
                         device="cpu")
    accel_fn = ti.make_accel_fn(solver, solver.mass)
    s0 = ti.init_state(rng.normal(0, spread, (n, 3)),
                       rng.normal(0, sigma, (n, 3)), accel_fn, solver.mass,
                       0.0, device="cpu")
    return solver, accel_fn, s0


def test_order_after_the_drift_equals_sort_per_call_bitwise():
    """The force of every KDK step runs on the slab order of the step's
    drifted positions: it equals ``cuda_accel`` given that order bit for
    bit, so an order carried from before the drift cannot come back
    unnoticed."""
    solver, accel_fn, state = _sorted_case(3, 3072, 1.0, 10.0, 0.02)
    step_fn = ti.make_kdk_step(accel_fn, DT, 0.0)
    before = dict(cd.BRANCHES)
    for _ in range(4):
        state = step_fn(state)
        want = cd.cuda_accel(state.pos, solver.mass, solver.softening,
                             solver.G, solver.kernel, solver.kahan,
                             solver.eps2, spatial_sort=True,
                             order=cd.slab_sort_key(state.pos), tm=64,
                             tn=128)
        assert torch.equal(state.acc, want)
    assert cd.BRANCHES["two_pass"] == before["two_pass"] + 8


def test_order_after_the_drift_keeps_a_hot_cluster_on_two_passes():
    """A compact cluster with a high velocity dispersion and a large dt:
    on the order of the positions before the drift the band window
    outgrows the band, so such a step would fall back to the single pass;
    the solver's own order of the drifted positions keeps every
    evaluation on the two passes."""
    steps = 4
    solver, accel_fn, s0 = _sorted_case(7, 3072, 0.1, 60.0, 0.005)
    step_fn = ti.make_kdk_step(accel_fn, 1e-3, 0.0)
    before = dict(cd.BRANCHES)
    s1 = step_fn(s0)
    h = solver.softening.max()
    stale_order = cd.slab_sort_key(s0.pos)
    _, stale, rows = cd.band_window(s1.pos[stale_order][:, 0], h, 64, 128)
    _, own, _ = cd.band_window(s1.pos[cd.slab_sort_key(s1.pos)][:, 0], h,
                               64, 128)
    assert int(own) <= cd.band_rows(rows) < int(stale)
    ti.run_chunk(step_fn, s1, steps - 1)
    assert cd.BRANCHES["single_pass"] == before["single_pass"]
    assert cd.BRANCHES["two_pass"] == before["two_pass"] + steps


def test_saved_order_sorts_the_saved_positions_and_resumes():
    """The state a restart saves (``to_numpy_state``) holds no slab order
    (the solver takes its own), and a run resumed from it continues bit
    for bit on the sorted path."""
    _, accel_fn, s0 = _sorted_case(5, 3072, 1.0, 10.0, 0.02)
    step_fn = ti.make_kdk_step(accel_fn, DT, 0.0)
    s3 = ti.run_chunk(step_fn, s0, 3)
    saved = ti.to_numpy_state(s3)
    assert "sort_order" not in saved
    whole = ti.run_chunk(step_fn, s3, 2)
    resumed = ti.run_chunk(step_fn, ti.from_jax_state(saved, device="cpu"),
                           2)
    for field in ("pos", "vel", "acc"):
        assert torch.equal(getattr(resumed, field), getattr(whole, field))


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
