"""The port's multi-device ring (``parallel/sharded.py``) against the JAX
package's, on the CPU.

The port's counterpart of tests/test_sharded.py: the JAX ring runs on the
8-device virtual CPU mesh that tests/conftest.py sets up, the port's over
eight virtual CPU shards (``devices=['cpu'] * 8``), on the same numpy
inputs.  Tolerances (max |port - JAX| / max |JAX|): 2e-6 in float32 (the
JAX package's own ring-vs-single tolerance), 1e-13 in float64; the
kernel route's ring (the kernels' plain versions on CPU tensors) against
the JAX Pallas ring in interpret mode (``mxu=False``; the moment form,
``mxu=True``, is held against it in tests/test_torch_moment.py), 2e-6.  Runs in float64 as tests/test_sharded.py: rtol 1e-10,
atol 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nbody_streams_tpu as jst
import nbody_streams_tpu_torch as tst
from nbody_streams_tpu.ops.dispatch import DirectGravity as JDirect
from nbody_streams_tpu_torch.integrate import (
    init_state,
    make_accel_fn,
    system_energy,
)
from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
from nbody_streams_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(2)

G = 4.3e-6
EIGHT = ["cpu"] * 8
TOL = {"float32_kahan": 2e-6, "float64": 1e-13}
RUN_TOL = dict(rtol=1e-10, atol=1e-12)


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / np.abs(want).max()


def _port(mass, soft, precision="float32_kahan", kernel="spline", **opts):
    return DirectGravity(mass, soft, G=G, kernel=kernel, precision=precision,
                         impl="sharded", devices=EIGHT,
                         sharded_opts=opts or None)


def _jax(mass, soft, precision="float32_kahan", kernel="spline",
         pallas=False):
    opts = (dict(use_pallas=True, interpret=True, mxu=False) if pallas
            else None)
    return JDirect(mass, soft, G=G, kernel=kernel, precision=precision,
                   impl="sharded", devices=jax.devices(), sharded_opts=opts)


def _eval(solver, mode, pos):
    """``mode`` ('accel' or 'potential') of either package's solver, as
    float64 numpy."""
    if isinstance(solver, DirectGravity):
        return getattr(solver, mode)(
            torch.tensor(pos, dtype=solver.dtype)).double().numpy()
    return np.asarray(getattr(solver, mode)(jnp.asarray(pos, solver.dtype)),
                      float)


@pytest.fixture(scope="module")
def cluster():
    """N = 1,000 on 8 shards: 125-row blocks, no whole tile of 64."""
    rng = np.random.default_rng(7)
    n = 1000
    return (rng.normal(0, 1, (n, 3)), rng.uniform(0.5, 2.0, n) * 1e5,
            rng.uniform(0.05, 0.3, n))


@pytest.fixture(scope="module")
def slab():
    """1,024 particles, h = 0.01: slab-sorted, every non-adjacent ring
    block is far; shuffled, the blocks' x-intervals overlap."""
    rng = np.random.default_rng(41)
    n = 1024
    pos = rng.normal(0, 1, (n, 3))
    mass = rng.uniform(0.5, 2.0, n) * 1e5
    soft = np.full(n, 0.01)
    return {"shuffled": (pos, mass, soft),
            "sorted": tsh.slab_sort_for_sharding(pos, mass, soft)}


@pytest.fixture(scope="module")
def jax_pallas_acc(slab):
    """The JAX Pallas ring's accelerations on both layouts, with its
    tiles counted by law (tests/test_sharded.py's spy)."""
    from nbody_streams_tpu.ops import pallas_direct

    out = {}
    orig = pallas_direct.pallas_accel_2set
    for layout in ("sorted", "shuffled"):
        counts = {}

        def spy(*args, counts=counts, **kw):
            res = orig(*args, **kw)
            jax.debug.callback(
                lambda _, k=args[5]: counts.__setitem__(
                    k, counts.get(k, 0) + 1), res[0, 0])
            return res

        pallas_direct.pallas_accel_2set = spy
        try:
            pos, mass, soft = slab[layout]
            acc = _eval(_jax(mass, soft, pallas=True), "accel", pos)
            jax.effects_barrier()
        finally:
            pallas_direct.pallas_accel_2set = orig
        out[layout] = (acc, counts)
    return out


# ---------------------------------------------------------------------------
# the ring against the JAX package's ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["accel", "potential"])
@pytest.mark.parametrize("precision", ["float32_kahan", "float64"])
def test_ring_matches_jax_ring(cluster, precision, mode):
    pos, mass, soft = cluster
    port = _port(mass, soft, precision)
    assert port.impl == "sharded" and not port._sharded.use_kernels
    got = _eval(port, mode, pos)
    want = _eval(_jax(mass, soft, precision), mode, pos)
    assert got.shape == want.shape
    assert _rel(got, want) < TOL[precision]


@pytest.mark.parametrize("kernel", ["spline", "plummer", "newtonian"])
def test_ring_potential_laws_match_jax(cluster, kernel):
    pos, mass, soft = cluster
    got = _eval(_port(mass, soft, "float64", kernel), "potential", pos)
    want = _eval(_jax(mass, soft, "float64", kernel), "potential", pos)
    assert _rel(got, want) < TOL["float64"]


@pytest.mark.parametrize("layout", ["sorted", "shuffled"])
def test_kernel_ring_accel_matches_jax_pallas_ring(slab, jax_pallas_acc,
                                                   layout):
    pos, mass, soft = slab[layout]
    port = _port(mass, soft, use_kernels=True)
    assert port._sharded.use_kernels
    got = _eval(port, "accel", pos)
    want, _ = jax_pallas_acc[layout]
    assert _rel(got, want) < 2e-6


@pytest.mark.parametrize("layout", ["sorted", "shuffled"])
def test_kernel_ring_potential_matches_jax_pallas_ring(slab, layout):
    """Covers the self mask on step r = 0: an unmasked self pair would add
    -G m_i / sqrt(eps2), ~1e7 x the physical potential."""
    pos, mass, soft = slab[layout]
    got = _eval(_port(mass, soft, use_kernels=True), "potential", pos)
    want = _eval(_jax(mass, soft, pallas=True), "potential", pos)
    assert _rel(got, want) < 2e-6


@pytest.mark.parametrize("case", ["n1000", "n601_offcentre"])
def test_kernel_ring_uneven_n_and_ghosts(cluster, case):
    """N = 1,000 (125-row blocks, padded to a whole tile of sources) and an
    off-centre N = 601 (7 ghost rows): both against the JAX Pallas ring,
    N rows in and N rows out.  The ring pads inside the solver, with the
    last row repeated, so the far test sees the last shard's own
    x-interval; an array at the padded length is not a valid input."""
    if case == "n1000":
        pos, mass, soft = cluster
    else:
        rng = np.random.default_rng(9)
        n = 601
        pos = rng.normal(0, 1, (n, 3)) + np.array([120.0, -80.0, 60.0])
        pos, mass, soft = tsh.slab_sort_for_sharding(
            pos, rng.uniform(0.5, 2.0, n) * 1e5, np.full(n, 0.01))
    n = len(mass)
    port = _port(mass, soft, use_kernels=True)
    sd = port._sharded
    assert sd.npad == n + (-n) % 8
    jx = _jax(mass, soft, pallas=True)
    seen, far = [], sd._far
    sd._far = lambda posp: seen.append(posp) or far(posp)
    for mode in ("accel", "potential"):
        got = _eval(port, mode, pos)
        assert got.shape[0] == n
        assert _rel(got, _eval(jx, mode, pos)) < 2e-6
    posp, = seen
    assert posp.shape == (sd.npad, 3)
    assert torch.equal(posp[n:], posp[n - 1:n].expand(sd.npad - n, 3))
    with pytest.raises(ValueError, match="pos shape"):
        port.accel(torch.zeros((sd.npad + (sd.npad == n), 3)))


def test_far_tiles_match_the_jax_ring(slab, jax_pallas_acc):
    """Sorted input: the far blocks take the Newtonian law on at least half
    of the D^2 tiles, the same tiles as the JAX ring's device test takes
    it on; shuffled input: none."""
    for layout, expect_far in (("sorted", True), ("shuffled", False)):
        pos, mass, soft = slab[layout]
        port = _port(mass, soft, use_kernels=True)
        before = dict(tsh.TILES)
        _eval(port, "accel", pos)
        counts = {k: tsh.TILES[k] - before[k] for k in tsh.TILES}
        assert sum(counts.values()) == 64
        _, jax_counts = jax_pallas_acc[layout]
        assert counts["newtonian"] == jax_counts.get("newtonian", 0)
        if expect_far:
            assert counts["newtonian"] >= 64 // 2, counts
        else:
            assert counts["newtonian"] == 0, counts


def test_fp64_takes_the_plain_tile(cluster):
    pos, mass, soft = cluster
    f64 = _port(mass, soft, "float64", use_kernels=True)
    assert not f64._sharded.use_kernels
    # on CPU shards the default is the plain tile too
    assert not _port(mass, soft)._sharded.use_kernels
    before = tsh.TILES["spline"]
    _eval(f64, "accel", pos)
    assert tsh.TILES["spline"] - before == 64


def test_sharded_opts_pass_through_and_raise(slab):
    pos, mass, soft = slab["shuffled"]
    g = DirectGravity(mass, soft, G=G, kernel="spline", impl="sharded",
                      devices=["cpu"] * 4, sharded_opts={"use_kernels": True})
    assert g._sharded.use_kernels and g._sharded.n_dev == 4
    assert g.devices == (torch.device("cpu"),) * 4
    single = DirectGravity(mass, soft, G=G, impl="torch", device="cpu")
    assert _rel(_eval(g, "accel", pos), _eval(single, "accel", pos)) < 2e-6
    # the shards are named by devices=, not by a sharded_opts mesh
    with pytest.raises(TypeError, match="mesh"):
        _port(mass, soft, mesh=["cpu"] * 4)
    with pytest.raises(ValueError, match="sharded_opts"):
        DirectGravity(mass, soft, impl="torch", device="cpu",
                      sharded_opts={"use_kernels": True})
    with pytest.raises(ValueError, match="impl='sharded'"):
        DirectGravity(mass, soft, impl="cuda", devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="first"):
        DirectGravity(mass, soft, device="cpu", impl="sharded",
                      devices=["meta", "meta"])
    # impl='auto' over more than one device is the ring; over one, the
    # one-device path on that device
    assert DirectGravity(mass, soft, devices=["cpu"] * 2).impl == "sharded"
    one = DirectGravity(mass, soft, devices=["cpu"])
    assert one.impl == "torch" and one.devices is None


def test_mxu_raises(slab):
    """mxu=True no longer raises: on the kernel route the far blocks of the
    sorted slab take kernel M's two-set form (tests/test_torch_moment.py
    holds it against the JAX ring); without the kernels, or by default,
    it is off."""
    pos, mass, soft = slab["sorted"]
    port = _port(mass, soft, use_kernels=True, mxu=True)
    assert port._sharded.mxu
    assert not _port(mass, soft, use_kernels=True)._sharded.mxu
    assert not _port(mass, soft, mxu=True)._sharded.mxu
    before = dict(tsh.TILES)
    got = _eval(port, "accel", pos)
    assert tsh.TILES["newtonian"] - before["newtonian"] >= 64 // 2
    want = _eval(_port(mass, soft, use_kernels=True), "accel", pos)
    assert not np.array_equal(got, want)
    assert _rel(got, want) < 3e-6


def test_slab_sort_for_sharding_preserves_physics():
    rng = np.random.default_rng(12345)
    n = 512
    xv = rng.normal(0, 1, (n, 6))
    m = rng.uniform(0.5, 1.5, n)
    h = np.full(n, 0.05)
    xv_s, m_s, h_s = tsh.slab_sort_for_sharding(xv, m, h)
    assert np.all(np.diff(xv_s[:, 0]) >= 0)
    from nbody_streams_tpu.parallel.sharded import slab_sort_for_sharding

    for a, b in zip((xv_s, m_s, h_s), slab_sort_for_sharding(xv, m, h)):
        np.testing.assert_array_equal(a, b)
    a0 = _eval(_port(m, h, use_kernels=True), "accel", xv[:, :3])
    a1 = _eval(_port(m_s, h_s, use_kernels=True), "accel", xv_s[:, :3])
    order = np.argsort(xv[:, 0], kind="stable")
    np.testing.assert_allclose(a1, a0[order], rtol=2e-5, atol=1e-8)


def test_make_particle_mesh(monkeypatch):
    mesh = tsh.make_particle_mesh(["cpu"] * 3)
    assert mesh == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="types"):
        tsh.make_particle_mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="at least one"):
        tsh.make_particle_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* k"):
        tsh.make_particle_mesh()
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* k"):
        DirectGravity(np.ones(16), 0.1, impl="sharded")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsh.make_particle_mesh(["cuda:0", "cuda:0"])


# ---------------------------------------------------------------------------
# ghost padding, the integrator and run_nbody
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uneven():
    rng = np.random.default_rng(5)
    n = 517
    return (rng.normal(0, 1, (n, 3)), rng.uniform(0.5, 2.0, n) * 1e5,
            rng.uniform(0.05, 0.3, n))


def test_ghost_state_and_system_energy(uneven):
    """N = 517 on 8 shards: the state holds the 517 rows, the ring's force
    on them equals the one-device force, and system_energy of the state
    equals the JAX package's of its own (sharded, ghost-padded) state and
    the one-device value."""
    pos, mass, soft = uneven
    n = len(mass)
    ring = _port(mass, soft, "float64")
    assert ring._sharded.npad == n + 3
    accel_fn = make_accel_fn(ring, ring.mass)
    vel = np.random.default_rng(1).normal(0, 10, (n, 3))
    state = init_state(pos, vel, accel_fn, ring.mass, 0.0,
                       dtype=torch.float64, device="cpu")
    assert state.pos.shape == (n, 3) and state.acc.shape == (n, 3)
    ke, pe = system_energy(state, ring, ring.mass)

    from nbody_streams_tpu import integrate as jint

    jring = _jax(mass, soft, "float64")
    jfn = jint.make_accel_fn(jring, jring.mass)
    jstate = jring.shard_state(jint.init_state(pos, vel, jfn, jring.mass,
                                               0.0, dtype=jnp.float64))
    assert jstate.pos.shape[0] == n + 3
    jke, jpe = jint.system_energy(jstate, jring, jring.mass)
    assert abs(float(ke) - float(jke)) < 1e-13 * abs(float(jke))
    assert abs(float(pe) - float(jpe)) < 1e-13 * abs(float(jpe))
    single = DirectGravity(mass, soft, G=G, precision="float64",
                           device="cpu")
    flat = init_state(pos, vel, make_accel_fn(single, single.mass),
                      single.mass, 0.0, dtype=torch.float64, device="cpu")
    assert _rel(state.acc, flat.acc) < TOL["float64"]
    ske, spe = system_energy(flat, single, single.mass)
    assert abs(float(pe) - float(spe)) < 1e-13 * abs(float(spe))
    assert float(ke) == pytest.approx(float(ske), rel=1e-15)


@pytest.fixture(scope="module")
def run_case():
    def make(n):
        xv, m = tst.make_plummer_sphere(n, M_total=1e4, a=0.01, seed=3)
        return xv, m, [tst.Species.dark(N=n, mass=float(m[0]),
                                        softening=0.003)]
    return make


@pytest.mark.parametrize("n", [256, 517])
def test_method_tree_runs_the_ring_end_to_end(run_case, tmp_path, n):
    """run_simulation(method='tree', devices=['cpu'] * 8): the ring (the
    tiles counted), against the JAX package's sharded run and the port's
    direct path; at N = 517 the ring pads 3 ghost rows inside the solver
    and the output holds the 517 rows."""
    xv, m, sp = run_case(n)
    kw = dict(time_start=0.0, time_end=2e-4, dt=2e-5, architecture="cpu",
              save_snapshots=False, verbose=False, precision="float64")
    before = sum(tsh.TILES.values())
    tree = tst.run_simulation(xv, sp, output_dir=str(tmp_path / "t"),
                              method="tree", devices=EIGHT, **kw)["dark"]
    # 11 force evaluations (the first and one a step) of 64 tiles
    assert sum(tsh.TILES.values()) - before == 11 * 64
    direct = tst.run_simulation(xv, sp, output_dir=str(tmp_path / "d"),
                                method="direct", **kw)["dark"]
    jsp = [jst.Species.dark(N=n, mass=float(m[0]), softening=0.003)]
    jtree = jst.run_simulation(xv, jsp, output_dir=str(tmp_path / "j"),
                               method="tree", devices=jax.devices(),
                               **kw)["dark"]
    assert tree.shape == (n, 6)
    np.testing.assert_allclose(tree, jtree, **RUN_TOL)
    np.testing.assert_allclose(tree, direct, **RUN_TOL)


def test_ring_run_files_are_ghost_free(run_case, tmp_path):
    """The snapshots and the restart file of a ghost-padded ring run hold
    the N real rows, the JAX package reads them, and a resumed run ends
    where an uninterrupted one does."""
    n = 517
    xv, m, sp = run_case(n)
    kw = dict(architecture="cpu", verbose=False, precision="float64",
              method="tree", devices=EIGHT, snapshots=3,
              restart_interval=5)
    out = tst.run_simulation(xv, sp, 0.0, 2e-4, 2e-5,
                             output_dir=str(tmp_path / "a"), **kw)["dark"]
    reader = jst.ParticleReader(str(tmp_path / "a" / "snapshot*.h5"))
    assert list(reader.Snapshots) == [0, 1, 2]
    np.testing.assert_array_equal(reader.read_snapshot(0).dark["posvel"],
                                  xv)
    np.testing.assert_array_equal(reader.read_snapshot(2).dark["posvel"],
                                  out)
    from nbody_streams_tpu.nbody_io import _load_restart

    restart = _load_restart(tmp_path / "a")
    assert restart[0].shape == (n, 6) and restart[2] == 10
    np.testing.assert_array_equal(restart[0], out)
    # stop at step 5, resume to step 10 in the port's ring
    kw["save_snapshots"] = False
    half = tst.run_simulation(xv, sp, 0.0, 1e-4, 2e-5,
                              output_dir=str(tmp_path / "b"), **kw)["dark"]
    assert half.shape == (n, 6)
    resumed = tst.run_simulation(xv, sp, 0.0, 2e-4, 2e-5,
                                 output_dir=str(tmp_path / "b"),
                                 continue_run=True, **kw)["dark"]
    np.testing.assert_allclose(resumed, out, **RUN_TOL)


def test_callback_force_extra_sees_only_real_rows(run_case, tmp_path):
    n = 517
    xv, m, _ = run_case(n)
    shapes = set()

    def drag(pos, vel, masses, t):
        shapes.add((pos.shape, vel.shape, masses.shape))
        return -0.5 * vel

    kw = dict(softening=0.003, architecture="cpu", precision="float64",
              save_snapshots=False, verbose=False, force_extra=drag)
    ring = tst.run_nbody(xv, m, 0.0, 1e-4, 2e-5, devices=EIGHT,
                         output_dir=str(tmp_path / "r"), **kw)
    assert shapes == {((n, 3), (n, 3), (n,))}
    direct = tst.run_nbody(xv, m, 0.0, 1e-4, 2e-5,
                           output_dir=str(tmp_path / "d"), **kw)
    np.testing.assert_allclose(ring, direct, **RUN_TOL)


def test_ring_run_nbody_integrates_n_rows(run_case, tmp_path, monkeypatch):
    """A ring run at N = 517 on 8 CPU shards, in an external field and with
    the energy diagnostic on: every state the KDK step takes and every
    position array the solver sees holds the 517 rows, and the run ends
    where the one-device run does."""
    from nbody_streams_tpu_torch import run as trun
    from nbody_streams_tpu_torch.potentials import NFWPotential

    n = 517
    xv, m, _ = run_case(n)
    shapes = []
    make = trun.make_kdk_step

    def spy_make(*args, **kw):
        step = make(*args, **kw)

        def spied(state):
            shapes.append(tuple(state.pos.shape))
            return step(state)

        return spied

    monkeypatch.setattr(trun, "make_kdk_step", spy_make)
    seen = []
    ring_eval = tsh.ShardedDirect._sharded_eval

    def spy_eval(self, mode, pos):
        seen.append(tuple(pos.shape))
        return ring_eval(self, mode, pos)

    monkeypatch.setattr(tsh.ShardedDirect, "_sharded_eval", spy_eval)
    kw = dict(softening=0.003, architecture="cpu", precision="float64",
              save_snapshots=False, verbose=False, debug_energy=True,
              external_potential=NFWPotential(mass=1e8, scaleRadius=0.05))
    ring = trun.run_nbody(xv, m, 0.0, 1e-4, 2e-5, devices=EIGHT,
                          output_dir=str(tmp_path / "r"), **kw)
    assert shapes == [(n, 3)] * 5
    # the first force, one a step, and the energy at the start
    assert seen == [(n, 3)] * 7
    direct = trun.run_nbody(xv, m, 0.0, 1e-4, 2e-5,
                            output_dir=str(tmp_path / "d"), **kw)
    assert ring.shape == (n, 6)
    np.testing.assert_allclose(ring, direct, **RUN_TOL)


def test_run_nbody_gpu_tree_forwards_devices(run_case, tmp_path):
    xv, m, _ = run_case(517)
    kw = dict(softening=0.003, architecture="cpu", precision="float64",
              save_snapshots=False, verbose=False)
    with pytest.warns(UserWarning, match="exact"):
        from nbody_streams_tpu_torch import tree as ttree

        ttree._warned = False
        ring = tst.run_nbody_gpu_tree(xv, m, 0.0, 1e-4, 2e-5, devices=EIGHT,
                                      output_dir=str(tmp_path / "r"), **kw)
    direct = tst.run_nbody(xv, m, 0.0, 1e-4, 2e-5, kernel="plummer",
                           output_dir=str(tmp_path / "d"), **kw)
    np.testing.assert_allclose(ring, direct, **RUN_TOL)


def test_ring_scaling_runs_on_cpu(capsys):
    from nbody_streams_tpu_torch.benchmarks import ring_scaling

    out = ring_scaling.main(["--device", "cpu", "-N", "512",
                             "--per-shard", "64", "--reps", "1"])
    assert [r["D"] for r in out["strong"]] == [1, 2, 4, 8]
    assert [r["N"] for r in out["weak"]] == [64, 128, 256, 512]
    assert all(r["ms"] > 0 and r["tiles"] == r["D"] ** 2
               for r in out["strong"] + out["weak"])
    assert "strong scaling" in capsys.readouterr().out

