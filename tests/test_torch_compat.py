"""The port's drop-in surface and one-card tree tier against the JAX
package's, on the CPU.

Mirrors tests/test_compat.py (module-path aliases, the ``fields`` names,
``run_nbody_cpu``'s reference knobs) and tests/test_tree_compat.py
(``TreeGPU`` / ``tree_gravity_gpu`` / ``run_nbody_gpu_tree``), and holds
the port's public names to the JAX package's.  The same numpy inputs go
through both packages.  Tolerances: ``tree_gravity_gpu`` (float32 + Kahan
on both sides) within 2e-6 of the JAX shim's and of the fp64 numpy oracle
(max |err| / max |oracle|); runs in float32 + Kahan within 1e-6 * max |x|,
as tests/test_torch_sim.py.  ``method='tree'`` on one device is the
direct path, so it equals ``method='direct'`` exactly.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import nbody_streams_tpu as jst
import nbody_streams_tpu.tree as jtree
import nbody_streams_tpu_torch as tst
import nbody_streams_tpu_torch.potentials as TP
from nbody_streams_tpu_torch import tree as ttree
from tests.numpy_oracle import oracle_forces, oracle_potential

torch.set_num_threads(2)

CPU = dict(device="cpu")
DT = 2e-4


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def cluster():
    rng = np.random.default_rng(11)
    pos = rng.normal(0, 1.0, (300, 3))
    mass = rng.uniform(0.5, 2.0, 300) * 1e6
    return pos, mass


@pytest.fixture()
def fresh_warning(monkeypatch):
    """The tree tier warns once a process: start each test unwarned.

    The JAX package's flag is reset too, and put back when the test ends,
    so that its own tests still see their first warning in this process.
    """
    monkeypatch.setattr(ttree, "_warned", False)
    monkeypatch.setattr(jtree, "_warned", False)


# ---------------------------------------------------------------------------
# public names and module-path aliases
# ---------------------------------------------------------------------------

def test_public_names_cover_the_jax_package():
    """Every public name of the JAX package (outside viz) and of its
    fast_sims, coords and utils exists in the port."""
    import nbody_streams_tpu.coords as jc
    import nbody_streams_tpu.fast_sims as jf
    import nbody_streams_tpu.utils as ju

    missing = [n for n in jst.__all__ if n != "viz" and not hasattr(tst, n)]
    for jmod, tmod in ((jf, tst.fast_sims), (jc, tst.coords),
                       (ju, tst.utils)):
        missing += [f"{jmod.__name__}.{n}" for n in jmod.__all__
                    if not hasattr(tmod, n)]
    assert not missing
    assert tst.utils.JaxPPoly is tst.utils.PPoly


def test_reference_module_paths_resolve():
    from nbody_streams_tpu import agama_helper as jah
    from nbody_streams_tpu_torch import agama_helper, tree_gpu

    assert agama_helper.fit_potential is TP.fit_potential
    assert agama_helper.PotentialGPU is TP.make_potential
    assert agama_helper.MultipoleCoefs is TP.MultipoleCoefs
    assert agama_helper.load_agama_potential is TP.load_agama_potential
    assert agama_helper.NFWPotentialGPU is TP.NFWPotentialGPU
    assert set(agama_helper.__all__) == set(jah.__all__)
    for name in agama_helper.__all__:
        assert getattr(agama_helper, name) is getattr(TP, name)
    assert tree_gpu.TreeGPU is ttree.TreeGPU
    assert tree_gpu.tree_gravity_gpu is ttree.tree_gravity_gpu
    assert tree_gpu.run_nbody_gpu_tree is ttree.run_nbody_gpu_tree
    assert tree_gpu.cuda_alive is tst.device_alive
    assert tst.cuda_alive is tst.device_alive
    assert tst.get_gpu_info is tst.get_device_info
    assert tst.run_nbody_gpu is tst.run_nbody_tpu


def test_fields_module_alias_matches_jax(cluster):
    from nbody_streams_tpu import fields as jfields
    from nbody_streams_tpu_torch import fields

    pos, mass = cluster
    assert fields.compute_nbody_forces_gpu is tst.compute_forces_direct
    assert fields.compute_nbody_potential_cpu is tst.compute_potential_direct
    assert tst.compute_nbody_forces_cpu is tst.compute_forces_direct
    assert set(fields.__all__) == set(jfields.__all__)
    for name in ("forces", "potential"):
        got = getattr(fields, f"compute_nbody_{name}_gpu")(
            pos, mass, 0.05, **CPU).numpy()
        want = np.asarray(getattr(jfields, f"compute_nbody_{name}_gpu")(
            pos, mass, 0.05))
        assert _rel(got, want) < 2e-6
    assert fields.get_gpu_info(**CPU)["platform"] == "cpu"


def test_device_info_and_alive():
    info = tst.get_device_info(**CPU)
    assert info["platform"] == "cpu" and info["n_devices"] == 1
    assert {"device_kind", "id", "process_index",
            "default_backend"} <= set(info)
    assert tst.device_alive("cpu") is True
    if torch.cuda.is_available():
        info = tst.get_gpu_info()
        assert info["platform"] == "gpu" and info["bytes_limit"] > 0
        assert tst.cuda_alive() is True
    else:
        # the card is the default: without one the info raises, naming
        # the CPU, and the health check says the card is not alive
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tst.get_gpu_info()
        assert tst.cuda_alive() is False


# ---------------------------------------------------------------------------
# the tree tier
# ---------------------------------------------------------------------------

def test_tree_gravity_matches_jax_and_oracle(cluster, fresh_warning):
    pos, mass = cluster
    with pytest.warns(UserWarning, match="exact"):
        acc, phi = tst.tree_gravity_gpu(pos, mass, eps=0.1, theta=0.5,
                                        **CPU)
    assert acc.shape == (300, 3) and phi.shape == (300,)
    assert acc.dtype == np.float32 and phi.dtype == np.float32
    ref_acc = oracle_forces(pos, mass, np.full(300, 0.1), tst.G_DEFAULT,
                            kind="plummer")
    ref_phi = oracle_potential(pos, mass, np.full(300, 0.1), tst.G_DEFAULT,
                               kind="plummer")
    assert _rel(acc, ref_acc) < 2e-6 and _rel(phi, ref_phi) < 2e-6
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_acc, j_phi = jst.tree_gravity_gpu(pos, mass, eps=0.1, theta=0.5)
    assert _rel(acc, j_acc) < 2e-6 and _rel(phi, j_phi) < 2e-6


def test_tree_warns_once(cluster, fresh_warning, tmp_path):
    """The ignored tree knobs are reported once a process, whichever
    entry point comes first."""
    pos, mass = cluster
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tst.tree_gravity_gpu(pos, mass, theta=0.4, nleaf=8, **CPU)
        tst.tree_gravity_gpu(pos, mass, theta=0.7, ncrit=8, **CPU)
        tst.run_nbody_gpu_tree(np.hstack([pos, np.zeros_like(pos)]), mass,
                               0.0, DT, DT, theta=0.3, architecture="cpu",
                               save_snapshots=False, verbose=False,
                               output_dir=str(tmp_path))
    hits = [w for w in rec if "tree tier is exact" in str(w.message)]
    assert len(hits) == 1 and "theta=0.4" in str(hits[0].message)


def test_handle_reuse_caches_solver(cluster, fresh_warning):
    pos, mass = cluster
    tree = tst.TreeGPU(300, eps=0.1, **CPU)
    with pytest.warns(UserWarning):
        a1, _ = tst.tree_gravity_gpu(pos, mass, eps=0.1, tree=tree)
    solver = tree._solver
    a2, _ = tst.tree_gravity_gpu(pos + 0.1, mass, eps=0.1, tree=tree)
    assert tree._solver is solver          # same mass/eps: no rebuild
    assert not np.allclose(a1, a2)
    tst.tree_gravity_gpu(pos, mass * 2, eps=0.1, tree=tree)
    assert tree._solver is not solver      # new mass: rebuilt


def test_handle_eps_honoured_without_explicit_arg(cluster, fresh_warning):
    pos, mass = cluster
    with pytest.warns(UserWarning):
        a_handle, _ = tst.tree_gravity_gpu(
            pos, mass, tree=tst.TreeGPU(300, eps=0.4, **CPU))
    a_explicit, _ = tst.tree_gravity_gpu(pos, mass, eps=0.4, **CPU)
    np.testing.assert_array_equal(a_handle, a_explicit)
    a_default, _ = tst.tree_gravity_gpu(pos, mass, **CPU)   # eps = 0.05
    assert np.abs(a_handle - a_default).max() > 0


def test_run_nbody_gpu_tree_matches_jax(tmp_path, cluster, fresh_warning):
    pos, mass = cluster
    xv = np.hstack([pos, np.zeros_like(pos)])
    kw = dict(softening=0.1, theta=0.6, snapshots=2, verbose=False)
    with pytest.warns(UserWarning, match="exact"):
        got = tst.run_nbody_gpu_tree(xv, mass, 0.0, 10 * DT, DT,
                                     architecture="cpu",
                                     output_dir=str(tmp_path / "t"), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # one device, as the port's tree tier: the JAX direct path
        want = jst.run_nbody_gpu_tree(xv, mass, 0.0, 10 * DT, DT,
                                      architecture="cpu", impl="jnp",
                                      output_dir=str(tmp_path / "j"), **kw)
    assert got.shape == (300, 6) and np.isfinite(got).all()
    for sl in (slice(0, 3), slice(3, 6)):
        assert np.abs(got[:, sl] - want[:, sl]).max() \
            < 1e-6 * np.abs(want[:, sl]).max()


# ---------------------------------------------------------------------------
# the run drivers: run_nbody_cpu / _tpu / _gpu, method='tree', profile_dir
# ---------------------------------------------------------------------------

def test_run_nbody_cpu_reference_kwargs(tmp_path):
    """The reference's CPU-only knobs (method/theta/nthreads) are accepted
    and dropped; the run is the JAX package's run_nbody_cpu."""
    xv, m = tst.make_plummer_sphere(128, M_total=1e8, a=0.5, seed=1)
    kw = dict(softening=0.05, save_snapshots=False, verbose=False)
    got = tst.run_nbody_cpu(xv, m, 0.0, 2 * DT, DT, method="tree",
                            theta=0.5, nthreads=4,
                            output_dir=str(tmp_path / "t"), **kw)
    want = jst.run_nbody_cpu(xv, m, 0.0, 2 * DT, DT, method="tree",
                             theta=0.5, nthreads=4,
                             output_dir=str(tmp_path / "j"), **kw)
    assert got.shape == (128, 6)
    for sl in (slice(0, 3), slice(3, 6)):
        assert np.abs(got[:, sl] - np.asarray(want)[:, sl]).max() \
            < 1e-6 * np.abs(want[:, sl]).max()
    with pytest.raises(ValueError, match="unknown method"):
        tst.run_nbody_cpu(xv, m, 0.0, 2 * DT, DT, method="fmm")
    if not torch.cuda.is_available():
        # the accelerator-pinned drivers mean the card
        for fn in (tst.run_nbody_gpu, tst.run_nbody_tpu):
            with pytest.raises(RuntimeError, match="architecture='cpu'"):
                fn(xv, m, 0.0, DT, DT, output_dir=str(tmp_path / "g"),
                   **kw)


def test_method_tree_is_the_direct_path(tmp_path, monkeypatch):
    """On one device method='tree' runs the direct path with the run's own
    kernel: the same state as method='direct', through the sorted
    two-pass branch at the default spline softening (its threshold
    lowered from N = 16,384 to this test's 4,096)."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    n = 4096
    monkeypatch.setattr(cd, "SORT_MIN_N", 2048)
    xv, m = tst.make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    species = [tst.Species.dark(N=n, mass=float(m[0]), softening=0.05)]
    out = {}
    for method in ("tree", "direct"):
        before = dict(cd.BRANCHES)
        out[method] = tst.run_simulation(
            xv, species, 0.0, 2 * DT / 10, DT / 10, architecture="cpu",
            method=method, impl="cuda", theta=0.5,
            output_dir=str(tmp_path / method), save_snapshots=False,
            verbose=False)["dark"]
        assert cd.BRANCHES["two_pass"] > before["two_pass"]
    np.testing.assert_array_equal(out["tree"], out["direct"])
    with pytest.raises(NotImplementedError, match="item 6"):
        tst.run_simulation(xv, species, 0.0, DT, DT, architecture="cpu",
                           method="tree", devices=["cuda:0", "cuda:1"],
                           output_dir=str(tmp_path), verbose=False)


def test_profile_dir_writes_a_trace(tmp_path):
    xv, m = tst.make_plummer_sphere(256, M_total=1e8, a=0.5, seed=3)
    prof = tmp_path / "prof"
    out = tst.run_nbody(xv, m, 0.0, 3 * DT, DT, softening=0.05,
                        architecture="cpu", save_snapshots=False,
                        verbose=False, profile_dir=str(prof),
                        output_dir=str(tmp_path / "o"))
    assert np.isfinite(out).all()
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    # the CPU side of the chunks' work: the plain version's torch ops
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_new_entry_points_need_the_card_or_cpu(cluster, tmp_path):
    """Without a card every new entry point raises unless it is asked for
    the CPU (the health check alone answers False)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nbody_streams_tpu_torch import fast_sims as tf
    from nbody_streams_tpu_torch.utils import iterative_unbinding

    pos, mass = cluster
    host = TP.NFWPotential(mass=1e12, scaleRadius=20.0)
    xv0 = np.array([25.0, 0, 0, 0, 150.0, 0])
    calls = [
        lambda: tst.tree_gravity_gpu(pos, mass),
        lambda: tst.tree_gravity_gpu(pos, mass, tree=tst.TreeGPU(300)),
        lambda: tst.run_nbody_gpu_tree(np.hstack([pos, pos]), mass, 0.0,
                                       DT, DT, save_snapshots=False,
                                       output_dir=str(tmp_path)),
        lambda: tf.integrate_orbit(host, xv0, 0.0, 1.0, n_steps=4),
        lambda: tf.integrate_orbits_released(host, xv0[None], [0.0], 0.0,
                                             1.0, 4),
        lambda: tf.orbits.integrate_orbit_adaptive(host, xv0, 0.0, 1.0),
        lambda: tf.create_particle_spray_stream(host, 1e8, xv0, 0.3),
        lambda: tf.run_restricted_nbody(host, 1e8, xv0, 0.3),
        lambda: tf.make_progenitor_potential("Plummer", 1e8, 0.3),
        lambda: tf.spherical_potential_from_particles(pos, mass),
        lambda: iterative_unbinding(pos, pos, mass),
        lambda: iterative_unbinding(pos, pos, mass,
                                    potential_compute_method="bfe"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
