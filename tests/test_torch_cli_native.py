"""The port's native host library and its command line against the JAX
package's, on the CPU.

The native kNN must equal SciPy's cKDTree (1e-12 relative: the same
float64 distances); the library builds with g++ at first use into
``NBODY_TORCH_BUILD_DIR`` and raises, with the tail of its build log,
where the JAX package falls back.  ``nbody-torch-run`` with
``--precision float64`` must end where the JAX package's ``nbody-run``
ends on the same flags (1e-10 of the largest phase-space coordinate;
measured ~1e-16: the same float64 arithmetic in another order).
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from nbody_streams_tpu.cli import main as jax_cli
from nbody_streams_tpu_torch import cli, native
from nbody_streams_tpu_torch.viz.sph import get_smoothing_lengths

torch.set_num_threads(2)

DATA = "nbody_streams_tpu_torch/data/potentials/MWPotential22.ini"


def _kdtree(pos, k):
    d, _ = cKDTree(pos).query(pos, k=k + 1)
    return d[:, -1]


def _degenerate_cases():
    rng = np.random.default_rng(0)
    return [
        (np.column_stack([rng.normal(0, 1, (4000, 2)),
                          np.full(4000, 5.0)]), 16),          # coplanar
        (np.column_stack([np.linspace(0, 1, 2000),
                          np.zeros(2000), np.zeros(2000)]), 8),  # line
        (np.column_stack([rng.normal(0, 10, (5000, 2)),
                          rng.normal(0, 0.01, 5000)]), 16),   # thin disc
        (rng.normal(0, 1, (4000, 3)), 16),                    # 3-D cloud
        (rng.standard_cauchy((3000, 3)), 32),                 # heavy tails
    ]


@pytest.mark.parametrize("case", range(5))
def test_knn_matches_ckdtree(case):
    pos, k = _degenerate_cases()[case]
    want = _kdtree(pos, k)
    np.testing.assert_allclose(native.knn_radius(pos, k), want, rtol=1e-12)
    np.testing.assert_allclose(native.knn_radius_ckdtree(pos, k), want,
                               rtol=1e-12)


def test_knn_small_inputs():
    for n in (1, 2, 5):
        pos = np.random.default_rng(n).normal(size=(n, 3))
        np.testing.assert_allclose(native.knn_radius(pos, 32),
                                   native.knn_radius_ckdtree(pos, 32),
                                   rtol=1e-12)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        native.knn_radius(np.zeros((10, 2)))


def test_morton_sort_is_permutation_and_local(rng):
    pos = rng.normal(0, 1, (5000, 3))
    d_orig = np.linalg.norm(np.diff(pos, axis=0), axis=1).mean()
    for order in (native.morton_argsort(pos),
                  native.morton_argsort_numpy(pos)):
        assert np.array_equal(np.sort(order), np.arange(5000))
        d_sorted = np.linalg.norm(np.diff(pos[order], axis=0),
                                  axis=1).mean()
        assert d_sorted < 0.3 * d_orig


def test_builds_into_build_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("NBODY_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    assert native.build(verbose=False)
    assert native.native_available()
    libs = list(tmp_path.glob("nbody_torch_native/*/libnbody_torch_host.so"))
    assert len(libs) == 1
    assert (libs[0].parent / "build.log").read_text().startswith(
        shutil.which("g++"))
    assert not list(tmp_path.rglob("*.tmp"))
    pos = np.random.default_rng(1).normal(size=(500, 3))
    np.testing.assert_allclose(native.knn_radius(pos, 8), _kdtree(pos, 8),
                               rtol=1e-12)
    assert native.build_dir() == tmp_path / "nbody_torch_native"


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a compiler error reaches the caller with the
    tail of build.log."""
    path = os.environ["PATH"]
    cxx = tmp_path / "bin" / "g++"
    cxx.parent.mkdir()
    cxx.write_text("#!/bin/sh\necho 'host_ops.cpp:1: error: boom' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{cxx.parent}{os.pathsep}{path}")
    monkeypatch.setenv("NBODY_TORCH_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_lib", None)
    pos = np.random.default_rng(2).normal(size=(100, 3))
    for fn in (native.knn_radius, native.morton_argsort):
        with pytest.raises(RuntimeError, match="error: boom"):
            fn(pos)
    with pytest.raises(RuntimeError, match="build.log"):
        get_smoothing_lengths(pos, 8, method="native")
    assert not native.native_available()
    assert not native.build(verbose=False)
    assert cli.build_native_main([]) == 1
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.knn_radius(pos)
    # the ckdtree method needs no library
    np.testing.assert_allclose(get_smoothing_lengths(pos, 8,
                                                     method="ckdtree"),
                               _kdtree(pos, 8), rtol=1e-12)
    monkeypatch.setenv("PATH", path)
    monkeypatch.setattr(native, "_lib", None)
    assert cli.build_native_main([]) == 0


def test_cli_runs_simulation(tmp_path):
    rc = cli.main([
        "--n", "64", "--t-end", "0.001", "--dt", "1e-4",
        "--architecture", "cpu", "--output-dir", str(tmp_path),
        "--snapshots", "2", "--quiet",
    ])
    assert rc == 0
    assert (tmp_path / "snapshot.h5").exists()
    assert (tmp_path / "restart.npz").exists()


def test_cli_config_file(tmp_path):
    cfg = {"n": 32, "t_end": 0.0005, "dt": 1e-4, "architecture": "cpu",
           "output_dir": str(tmp_path / "out"), "quiet": True,
           "snapshots": 2, "seed": 3}
    cfg_path = tmp_path / "run.json"
    cfg_path.write_text(json.dumps(cfg))
    # a flag on the command line overrides the config, even at its default
    rc = cli.main(["--config", str(cfg_path), "--seed", "42069"])
    assert rc == 0
    assert (tmp_path / "out/snapshot.h5").exists()
    step = int(np.load(tmp_path / "out/restart.npz")["step"])
    assert step == 5


def test_cli_bad_flag_and_unknown_key(tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.main(["--kernel", "bogus"])
    with pytest.raises(SystemExit):         # the JAX package's 'tpu'
        cli.main(["--architecture", "tpu"])
    cfg_path = tmp_path / "run.json"
    cfg_path.write_text(json.dumps({"n": 32, "presicion": "float64"}))
    with pytest.raises(SystemExit):
        cli.main(["--config", str(cfg_path)])
    assert "presicion" in capsys.readouterr().err


def test_cli_default_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ([], ["--architecture", "gpu"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--n", "16", "--t-end", "1e-4", "--dt", "1e-4",
                      "--output-dir", str(tmp_path), "--quiet", *arch])


FLAGS = ["--n", "256", "--t-end", "0.002", "--dt", "1e-4", "--precision",
         "float64", "--no-snapshots", "--quiet", "--architecture", "cpu"]


def _final(out):
    return np.load(out / "restart.npz")["phase_space"]


def test_cli_float64_matches_jax(tmp_path):
    assert jax_cli(FLAGS + ["--output-dir", str(tmp_path / "j")]) == 0
    assert cli.main(FLAGS + ["--output-dir", str(tmp_path / "t")]) == 0
    want, got = _final(tmp_path / "j"), _final(tmp_path / "t")
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    # a JAX restart file starts a port run (and the other way round):
    # both CLIs from the same file end in the same state
    for src in ("j", "t"):
        ic = str(tmp_path / src / "restart.npz")
        ends = []
        for name, run in (("jj", jax_cli), ("tt", cli.main)):
            out = tmp_path / f"{name}_{src}"
            assert run(FLAGS + ["--ic-file", ic, "--output-dir",
                                str(out)]) == 0
            ends.append(_final(out))
        assert np.abs(ends[1] - ends[0]).max() <= \
            1e-10 * np.abs(ends[0]).max()
        np.testing.assert_array_equal(
            np.load(tmp_path / f"tt_{src}" / "restart.npz")["mass_arr"],
            np.load(ic)["mass_arr"])


def test_cli_npy_ic_and_continue(tmp_path):
    xv = np.random.default_rng(4).normal(size=(40, 6))
    np.save(tmp_path / "ic.npy", xv)
    base = ["--ic-file", str(tmp_path / "ic.npy"), "--dt", "1e-4",
            "--no-snapshots", "--quiet", "--architecture", "cpu",
            "--softening", "0.1", "--output-dir", str(tmp_path / "o")]
    assert cli.main(base + ["--t-end", "0.0005"]) == 0
    assert cli.main(base + ["--t-end", "0.0008", "--continue"]) == 0
    r = np.load(tmp_path / "o/restart.npz")
    assert int(r["step"]) == 8 and np.isfinite(r["phase_space"]).all()
    np.testing.assert_allclose(r["mass_arr"], 1e9 / 40)


def test_cli_external_potential_on_cpu(tmp_path):
    rc = cli.main(["--n", "64", "--t-end", "0.0003", "--dt", "1e-4",
                   "--architecture", "cpu", "--no-snapshots", "--quiet",
                   "--external-potential", DATA, "--output-dir",
                   str(tmp_path)])
    assert rc == 0
    assert np.isfinite(_final(tmp_path)).all()


def test_bench_main(monkeypatch):
    from nbody_streams_tpu_torch import bench_suite

    seen = []
    monkeypatch.setattr(bench_suite, "main", lambda argv: seen.append(argv))
    assert cli.bench_main(["-N", "4096"]) == 0
    assert seen == [["-N", "4096"]]
    # with no arguments: the bench module, which needs the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cli.bench_main([])
