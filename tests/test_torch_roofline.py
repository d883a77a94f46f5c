"""The port's measurement path on the CPU: the plain versions of the
roofline kernels, the probes, ``tile_config``, the tile sweep and the
bench suite.

On the CPU each roofline wrapper runs its plain torch version
(``_fma_chain_reference``, ``_rsqrt_chain_reference``,
``_tile_sol_reference``); tests/test_torch_cuda.py holds the kernels
against those versions on a card.  The JAX roofline bodies are closures
(benchmarks/tile_sweep.py:91-103), so the chains are held against a
numpy float32 loop of the recurrence, and the speed-of-light tile against
the JAX package's ``ops/pairwise`` acceleration.  Tolerances: 1e-5
relative for the chains and the tile (fp32 against numpy fp32 or the
fp64 oracle, after up to a few hundred roundings); 1e-6 * max between the
sorted path and the Pallas kernels (the TOL of test_torch_direct.py).
"""
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_streams_tpu.ops import pallas_direct as jpd
from nbody_streams_tpu.ops.pairwise import accel_tile as j_accel_tile
from nbody_streams_tpu_torch import bench, bench_suite
from nbody_streams_tpu_torch.benchmarks import sass, tile_sweep
from nbody_streams_tpu_torch.ops import cuda_direct as cd
from nbody_streams_tpu_torch.ops import probe
from nbody_streams_tpu_torch.ops import roofline as rl
from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
from nbody_streams_tpu_torch.species import PerformanceWarning

torch.set_num_threads(2)

G = 4.3e-6
TOL = 1e-6


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# the chains
# ---------------------------------------------------------------------------

def _numpy_chain(x, K, passes, link):
    """The recurrence of fma_chain_kernel / rsqrt_chain_kernel as a numpy
    float32 loop, one chain at a time."""
    f = np.float32
    v = x.copy()
    out = np.zeros_like(x)
    for _ in range(passes):
        acc = [v + f(c) for c in range(rl.CHAINS)]
        for _ in range(K // rl.CHAINS):
            acc = [link(a, v).astype(np.float32) for a in acc]
        total = acc[0]
        for a in acc[1:]:
            total = total + a
        v = x + total * f(rl.NUDGE)
        out = out + total
    return out


_LINKS = {
    "fma": (rl.fma_chain, lambda a, v: a * v + v),
    "rsqrt": (rl.rsqrt_chain, lambda a, v: 1.0 / np.sqrt(a + v)),
}


@pytest.mark.parametrize("name", ["fma", "rsqrt"])
def test_chain_reference_matches_numpy_loop(name):
    fn, link = _LINKS[name]
    x = np.random.default_rng(1).uniform(0.1, 0.5, (16, 24)).astype(
        np.float32)
    K, passes = 24, 3
    got = fn(torch.tensor(x), K, passes)
    want = _numpy_chain(x, K, passes, link)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert np.abs(got.numpy() / want - 1).max() < 1e-5


def test_fma_chain_stays_finite_on_the_probe_tile():
    """1.25 (the TPU's input) overflows the fma recurrence near K = 400;
    the probe tile's [0.1, 0.5] converges to v / (1 - v), and each of the
    passes adds its CHAINS chains' total."""
    x = probe.probe_tile("cpu", (4, 64))
    passes = 3
    y = rl.fma_chain(x, 512, passes)
    assert torch.isfinite(y).all()
    v = x.double()
    fixed = v / (1 - v)
    assert torch.allclose(y.double(), passes * rl.CHAINS * fixed, rtol=1e-5)


@pytest.mark.parametrize("name", ["fma_chain", "rsqrt_chain"])
def test_chain_output_moves_with_every_link_and_pass(name):
    """Below the fixed point (K = 16 on the probe tile) one link more or
    less, and one pass more or less, each change the output, so the
    kernel-vs-plain check at that K sees the work the kernel does."""
    fn = getattr(rl, name)
    x = probe.probe_tile("cpu", (4, 64))
    y = fn(x, 16, 2)
    for K, passes in ((12, 2), (20, 2), (16, 1), (16, 3)):
        assert _rel(fn(x, K, passes), y) > 1e-4


# ---------------------------------------------------------------------------
# the speed-of-light tile
# ---------------------------------------------------------------------------

def _sol_case(kind, nt=192, ns=128, seed=4):
    rng = np.random.default_rng(seed)
    pos_t = rng.normal(0, 1, (nt, 3))
    pos_s = rng.normal(0, 1, (ns, 3))
    gm = rng.uniform(0.5, 1.5, ns) * G
    h_t = rng.uniform(0.05, 0.3, nt)
    h_s = rng.uniform(0.05, 0.3, ns)
    t32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    tgt = cd._targets(t32(pos_t), cd._soft_pre(kind, t32(h_t)))
    src = cd._sources(t32(pos_s), t32(gm), cd._soft_pre(kind, t32(h_s)),
                      cd.BLOCK)
    # the oracle sees the fp32-rounded inputs in fp64
    r = lambda a: np.asarray(a, np.float32).astype(np.float64)  # noqa: E731
    return tgt, src, (r(pos_t), r(h_t), r(pos_s), r(gm), r(h_s))


@pytest.mark.parametrize("kind", ["newtonian", "spline"])
def test_tile_sol_reference_matches_jax_pairwise(kind):
    """Five blocks over 192 targets and two source tiles: the targets and
    the tiles both wrap.  Divided by reps, each block is the acceleration
    of its targets from its tile."""
    blocks, reps = 5, 3
    tgt, src, (pos_t, h_t, pos_s, gm, h_s) = _sol_case(kind)
    got = rl.tile_sol(tgt, src, kind, blocks, reps).double().numpy() / reps
    assert got.shape == (blocks * cd.BLOCK, 3)
    lane = np.arange(cd.BLOCK)
    want = []
    for b in range(blocks):
        i = (b * cd.BLOCK + lane) % pos_t.shape[0]
        j = (b % 2) * cd.BLOCK + lane
        want.append(np.asarray(j_accel_tile(
            kind, jnp.asarray(pos_t[i]), jnp.asarray(h_t[i]),
            jnp.asarray(i.astype(np.int32)), jnp.asarray(pos_s[j]),
            jnp.asarray(gm[j]), jnp.asarray(h_s[j]),
            jnp.asarray((10**6 + j).astype(np.int32)), eps2=1e-15)))
    assert _rel(got, np.concatenate(want)) < 1e-5


def _jax_moment_tile(tgt, src, i, j):
    """The TPU's moment tile, ``_tile_sum(mxu=True)`` (Newtonian, acc,
    folded; precision HIGHEST), of targets ``i`` against sources ``j``
    (64 each) with jnp arrays as the refs: (64, 4) un-finalised moments
    as float32 numpy."""
    t, s = tgt.numpy(), src.numpy()
    col = lambda a: jnp.asarray(a[:, None])          # noqa: E731
    row = lambda a: jnp.asarray(a[None, :])          # noqa: E731
    return np.asarray(jpd._tile_sum(
        "newtonian", "acc", False, 1e-15, cd.BLOCK, cd.BLOCK, 1,
        col(t[0, i]), col(t[1, i]), col(t[2, i]), col(t[3, i]), None,
        row(s[0, j]), row(s[1, j]), row(s[2, j]), row(s[3, j]),
        row(s[4, j]), 0, 0, mxu=True))


def test_tile_sol_moment_reference_matches_jax_tile_sum():
    """One block, one pass: the plain version of tile_sol_moment_kernel is
    the TPU's moment tile of the block's 64 targets against its source
    tile, within 3e-6 of max."""
    tgt, src, _ = _sol_case("newtonian", nt=64, ns=64)
    got = rl.tile_sol(tgt, src, "newtonian", 1, 1, mxu=True)
    assert got.shape == (cd.BLOCK, 4) and got.dtype == torch.float32
    lane = np.arange(cd.BLOCK)
    assert _rel(got, _jax_moment_tile(tgt, src, lane, lane)) < 3e-6


def test_tile_sol_moment_reference_matches_a_kahan_loop_of_jax_tiles():
    """Five blocks over 192 targets and two source tiles (the targets and
    the tiles both wrap), three passes: each pass the TPU's moment tile,
    a float32 Kahan step, and the targets nudged by the running moments
    (1e-30, as tile_sol_kernel), in a numpy loop; within 3e-6 of max."""
    blocks, reps = 5, 3
    tgt, src, _ = _sol_case("newtonian")
    got = rl.tile_sol(tgt, src, "newtonian", blocks, reps, mxu=True)
    assert got.shape == (blocks * cd.BLOCK, 4)
    f32, lane = np.float32, np.arange(cd.BLOCK)
    want = []
    for b in range(blocks):
        i = (b * cd.BLOCK + lane) % tgt.shape[1]
        j = (b % 2) * cd.BLOCK + lane
        t = tgt.clone()
        total = np.zeros((cd.BLOCK, 4), f32)
        comp = np.zeros_like(total)
        for _ in range(reps):
            part = _jax_moment_tile(t, src, i, j).astype(f32)
            y = part - comp
            new = total + y
            comp = (new - total) - y
            total = new
            for c in range(3):
                t[c, i] = torch.tensor(tgt[c, i].numpy()
                                       + total[:, c] * f32(rl.NUDGE))
        want.append(total)
    want = np.concatenate(want)
    assert _rel(got, want) < 3e-6
    # a pass more moves every moment: the plain version does each pass
    more = rl.tile_sol(tgt, src, "newtonian", blocks, reps + 1, mxu=True)
    assert np.all(np.abs(more.numpy() - got.numpy()) > 0)


def test_cpu_tensors_run_the_plain_versions():
    before = dict(rl.LAUNCHES)
    x = probe.probe_tile("cpu", (8, 8))
    assert torch.equal(rl.fma_chain(x, 8, 2), rl._fma_chain_reference(x, 8, 2))
    assert torch.equal(rl.rsqrt_chain(x, 8, 2),
                       rl._rsqrt_chain_reference(x, 8, 2))
    tgt, src, _ = _sol_case("spline")
    assert torch.equal(rl.tile_sol(tgt, src, "spline", 2, 2),
                       rl._tile_sol_reference(tgt, src, "spline", 2, 2))
    tgt, src, _ = _sol_case("newtonian")
    assert torch.equal(
        rl.tile_sol(tgt, src, "newtonian", 2, 2, mxu=True),
        rl._tile_sol_moment_reference(tgt, src, "newtonian", 2, 2))
    assert rl.LAUNCHES == before


def test_roofline_wrappers_check_their_operands():
    x = probe.probe_tile("cpu", (8, 8))
    with pytest.raises(ValueError, match="multiple of"):
        rl.fma_chain(x, 6, 1)
    with pytest.raises(ValueError, match="float32"):
        rl.rsqrt_chain(x.double(), 8, 1)
    tgt, src, _ = _sol_case("spline")
    with pytest.raises(ValueError, match="kind"):
        rl.tile_sol(tgt, src, "plummer", 1, 1)
    with pytest.raises(ValueError, match="multiple"):
        rl.tile_sol(tgt, src[:, :100].contiguous(), "spline", 1, 1)
    with pytest.raises(ValueError, match="positive"):
        rl.tile_sol(tgt, src, "spline", 0, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        rl.tile_sol_blocks("spline", "cpu")


def test_tile_sol_moment_checks_its_operands():
    """The moment tile takes the Newtonian law alone (kernel M's), and the
    operand checks of the force tile; full occupancy needs a card."""
    tgt, src, _ = _sol_case("newtonian")
    for kind in ("spline", "plummer"):
        with pytest.raises(ValueError, match="newtonian"):
            rl.tile_sol(tgt, src, kind, 1, 1, mxu=True)
        with pytest.raises(ValueError, match="Newtonian"):
            rl._tile_sol_moment_reference(tgt, src, kind, 1, 1)
    with pytest.raises(ValueError, match="multiple"):
        rl.tile_sol(tgt, src[:, :100].contiguous(), "newtonian", 1, 1,
                    mxu=True)
    with pytest.raises(ValueError, match="float32"):
        rl.tile_sol(tgt.double(), src, "newtonian", 1, 1, mxu=True)
    with pytest.raises(ValueError, match="positive"):
        rl.tile_sol(tgt, src, "newtonian", 1, 0, mxu=True)
    with pytest.raises(ValueError, match="CUDA device"):
        rl.tile_sol_blocks("newtonian", "cpu", mxu=True)
    with pytest.raises(ValueError, match="kind"):
        rl.tile_sol_blocks("spline", "cuda", mxu=True)


# ---------------------------------------------------------------------------
# probes and the bench (mirror the JAX side's tiny probe and bench tests,
# tests/test_physics.py:631-638 among them)
# ---------------------------------------------------------------------------

def test_delivered_tops_runs_tiny():
    tops = probe.delivered_tops(K=4, iters=8, device="cpu")
    assert np.isfinite(tops) and tops > 0


def test_bench_imports_and_probe_runs_tiny():
    torch_tops, cuda_tops = bench._capacity_probe(K=4, ITERS=8,
                                                  device="cpu")
    assert np.isfinite(torch_tops) and torch_tops > 0
    assert np.isfinite(cuda_tops) and cuda_tops > 0
    assert bench.BASELINE_GINT == 124.0
    assert callable(bench.main)


def test_bench_needs_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.measure("cpu")


# ---------------------------------------------------------------------------
# tile_config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sorted_case():
    """The sorted_case of test_torch_direct.py: N = 3,072, h = 0.02; with
    tm=64, tn=128 the band (12 rows) is a strict subset of 24 rows."""
    rng = np.random.default_rng(11)
    n = 3072
    pos = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    gm = (rng.uniform(0.5, 1.5, n) * G).astype(np.float32)
    return pos, gm, np.full(n, 0.02, np.float32)


def test_tile_config_reaches_the_sorted_path(sorted_case, monkeypatch):
    """DirectGravity(tile_config={'tm': 64, 'tn': 128}) against the Pallas
    sorted path at the same geometry.  The sorted path starts at N =
    16,384; it is lowered to this case's N so the Pallas side stays
    small."""
    pos, gm, soft = sorted_case
    monkeypatch.setattr(cd, "SORT_MIN_N", 2048)
    seen = []
    real = cd._self_sorted

    def spy(*args, **kw):
        seen.append((kw["tm"], kw["tn"]))
        return real(*args, **kw)

    monkeypatch.setattr(cd, "_self_sorted", spy)
    solver = DirectGravity(gm / G, soft, G=G, impl="cuda",
                           tile_config={"tm": 64, "tn": 128}, device="cpu")
    assert solver.impl == "cuda" and cd.uses_spatial_sort(solver.kernel,
                                                          solver.n)
    before = dict(cd.BRANCHES)
    got = solver.accel(torch.tensor(pos))
    assert seen == [(64, 128)]
    assert cd.BRANCHES["two_pass"] == before["two_pass"] + 1
    want = jpd._pallas_self_sorted(
        jnp.asarray(pos), jnp.asarray(gm), jnp.asarray(soft), "spline", True,
        "acc", 1e-15, interpret=True, max_sub=8, tm=64, tn=128)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("tile, match", [
    ({"tm": 64, "max_sub": 16}, "max_sub"),
    ({"mxu": True}, "mxu"),
    ({"tn": 128, "fold_mass": False}, "fold_mass"),
])
def test_tile_config_tpu_keys_warn(tile, match):
    """max_sub (the TPU's VMEM superblocks) has no CUDA meaning and warns;
    mxu and fold_mass choose kernel M's form and are kept, silently."""
    if match == "max_sub":
        with pytest.warns(PerformanceWarning, match=match):
            solver = DirectGravity(np.full(64, 1.0), 0.05, impl="cuda",
                                   tile_config=tile, device="cpu")
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            solver = DirectGravity(np.full(64, 1.0), 0.05, impl="cuda",
                                   tile_config=tile, device="cpu")
    assert match not in solver._tile or solver._tile[match] == tile[match]
    assert ("max_sub" in solver._tile) is False


def test_tile_config_is_checked():
    with pytest.raises(ValueError, match="unknown tile_config keys"):
        DirectGravity(np.full(64, 1.0), 0.05, tile_config={"bs": 4},
                      device="cpu")
    with pytest.raises(ValueError, match="multiples"):
        DirectGravity(np.full(64, 1.0), 0.05, tile_config={"tm": 100},
                      device="cpu")


def test_tile_config_off_the_sorted_path_warns():
    rng = np.random.default_rng(2)
    solver = DirectGravity(np.full(256, 1e5), 0.05, impl="cuda",
                           kernel="plummer", tile_config={"tn": 128},
                           device="cpu")
    pos = torch.tensor(rng.normal(size=(256, 3)), dtype=torch.float32)
    with pytest.warns(PerformanceWarning, match="slab-sorted"):
        got = solver.accel(pos)
    plain = DirectGravity(np.full(256, 1e5), 0.05, impl="cuda",
                          kernel="plummer", device="cpu").accel(pos)
    assert torch.equal(got, plain)


# ---------------------------------------------------------------------------
# the tile sweep and the bench suite run to the end on the CPU
# ---------------------------------------------------------------------------

def test_tile_sweep_runs_on_cpu(sorted_case):
    res = tile_sweep.sweep(3072, 1, [(64, 128)], device="cpu")
    rec = res[(64, 128)]
    assert rec["branch"] == "two_pass" and rec["device"] == "cpu"
    assert rec["acc"].shape == (3072, 3) and torch.isfinite(rec["acc"]).all()
    assert rec["ms_per_eval"] > 0 and rec["gint_per_s"] > 0
    with pytest.raises(SystemExit, match="unknown mode"):
        tile_sweep.main(["mxu"])


def test_tile_sweep_roofline_and_sol_run_on_cpu():
    r = tile_sweep.roofline("cpu", K=4, passes=2, reps=1)
    assert r["fma"]["g_ops_per_s"] == pytest.approx(
        2 * r["fma"]["g_lanes_per_s"])
    assert r["rsqrt"]["g_lanes_per_s"] > 0
    s = tile_sweep.sol("spline", blocks=2, reps=2, device="cpu",
                       timing_reps=1)
    assert s["g_pairs_per_s"] > 0 and s["blocks"] == 2
    assert {r["fma"]["device"], r["rsqrt"]["device"], s["device"]} == {"cpu"}


def test_tile_sweep_sol_mxu_and_solmxu_run_on_cpu(monkeypatch, capsys):
    """sol(mxu=True) runs the moment tile's plain version on a named CPU
    device; the solmxu mode runs it and the spline force tile, each at
    the base pass's shape and at full occupancy (here two blocks, a few
    passes: full occupancy is a card's), one JSON line each."""
    s = tile_sweep.sol("newtonian", blocks=2, reps=2, device="cpu",
                       timing_reps=1, mxu=True)
    assert s["mxu"] is True and s["blocks"] == 2 and s["device"] == "cpu"
    assert s["g_pairs_per_s"] > 0
    with pytest.raises(ValueError, match="kind"):
        tile_sweep.sol("spline", blocks=2, reps=2, device="cpu", mxu=True)
    calls = []
    real = tile_sweep.sol

    def sol(kind, blocks=None, device="cuda", mxu=False):
        calls.append((kind, blocks, mxu))
        return real(kind, 2 if blocks is None else blocks, 2, device, 1,
                    mxu)

    monkeypatch.setattr(tile_sweep, "sol", sol)
    monkeypatch.setattr(tile_sweep, "BASE_BLOCKS", 1)
    capsys.readouterr()
    tile_sweep.main(["solmxu", "--device", "cpu"])
    assert calls == [("newtonian", 1, True), ("newtonian", None, True),
                     ("spline", 1, False), ("spline", None, False)]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["metric"], r["mxu"]) for r in lines] == [
        ("newtonian_kahan_arith_speed_of_light", True)] * 2 + [
        ("spline_kahan_arith_speed_of_light", False)] * 2


def test_tile_sweep_moment_mode_runs_on_cpu():
    """The moment mode on a named CPU device at a small N: kernels M and F
    (their plain versions here), row 1, the ring's far tile in M's
    two-set form and row 2's Newtonian tile, and the moment tile at the
    base pass's shape (full occupancy is a card's)."""
    out = tile_sweep.moment_forms(n=4096, iters=1, device="cpu",
                                  sol_reps=2)
    assert set(out) == {*tile_sweep.MOMENT_FORMS, "row1", "2m",
                        "row2_newtonian_tile", "7m_base"}
    for name in (*tile_sweep.MOMENT_FORMS, "2m"):
        assert out[name]["rel"] < 1e-6 and out[name]["ms"] > 0
    assert out["7m_base"]["mxu"] is True
    assert {r["device"] for r in out.values()} == {"cpu"}


def test_measurement_clis_need_a_cuda_device_unless_told(monkeypatch):
    """Without a CUDA device the sweep and the suite raise instead of
    timing the CPU; only a CPU device named outright runs the plain
    versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tile_sweep.roofline, lambda: tile_sweep.sol("spline", 2),
               lambda: tile_sweep.sweep(1024, 1, [(64, 128)]),
               lambda: tile_sweep.main(["roofline"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_suite.main(["-N", "1024", "--sections", "1"])


def test_bench_suite_runs_on_cpu():
    out = bench_suite.main(["-N", "2048", "--reps", "1", "--sections",
                            "1,2,3", "--device", "cpu"])
    assert out["impl"] == "torch" and out["device"] == "cpu"
    assert ("spline", "float64") in out["section1"]
    assert out["section2"]["potential_ms"] > 0
    for row in out["section3"].values():
        assert row["max_rel_err"] < 3e-6


def test_bench_suite_has_no_sharded_row(capsys):
    """The sharded row (``--sharded``) is not part of ``main``'s sections:
    it is ``main_sharded``, the ring on 8 virtual shards of the card by
    default (raising without one), here on 8 CPU shards at a small N
    against the one-device solver."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            bench_suite.main_sharded(["--sharded", "-N", "64"])
    out = bench_suite.main_sharded(["--sharded", "-N", "1024", "--reps",
                                    "1", "--device", "cpu"])
    assert out["shards"] == 8 and out["device"] == "cpu"
    assert out["tile"] == "plain" and out["ms"] > 0
    assert out["max_rel_err"] < 2e-6
    assert "sharded ring 8-shard" in capsys.readouterr().out
    four = bench_suite.main_sharded(["-N", "512", "--reps", "1",
                                     "--shards", "4", "--device", "cpu"])
    assert four["shards"] == 4 and four["max_rel_err"] < 2e-6


def test_split_sweep_runs_on_cpu_and_needs_a_named_device(monkeypatch):
    recs = tile_sweep.split_sweep(4096, [None, 2], 1, "cpu")
    assert [(r["kernel"], r["splits"]) for r in recs] == [
        ("direct", "auto"), ("direct", 2), ("band", "auto"), ("band", 2)]
    assert {r["device"] for r in recs} == {"cpu"}
    assert recs[3]["blocks"] == 2 * 4096 // cd.BLOCK
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tile_sweep.split_sweep(4096, [1], 1)


# A cuobjdump -sass listing in miniature: the base pass's inner loop (two
# pairs a trip, branch to a label) and the band kernel's (one pair, branch
# to an address), with ptxas's -v report for the first.
_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_118direct_tile_kernelILi0ELi0ELb1ELb1EEEvPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x0 */
.L_x_1:
        /*0010*/                   LDS.128 R4, [UR4] ;  /* 0x0 */
        /*0020*/                   FADD R8, R4, -R2 ;  /* 0x0 */
        /*0030*/                   FFMA R9, R8, R8, R3 ;  /* 0x0 */
        /*0040*/                   MUFU.RSQ R10, R9 ;  /* 0x0 */
        /*0050*/                   FMUL R11, R10, R10 ;  /* 0x0 */
        /*0060*/                   MUFU.RSQ R12, R9 ;  /* 0x0 */
        /*0070*/                   NOP ;  /* 0x0 */
        /*0080*/               @P0 BRA `(.L_x_1) ;  /* 0x0 */
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;  /* 0x0 */
        /*00a0*/               @P1 BRA `(.L_x_0) ;  /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_111band_kernelILi0ELb1EEEvPKf
        /*0000*/                   FSETP.GEU.AND P0, PT, R1, R2, PT ;  /* 0x0 */
        /*0010*/                   MUFU.RSQ R10, R9 ;  /* 0x0 */
        /*0020*/              @!P0 BRA 0x0 ;  /* 0x0 */
"""
_LOG = """ptxas info    : Compiling entry function \
'_ZN12_GLOBAL__N_118direct_tile_kernelILi0ELi0ELb1ELb1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118direct
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 1280 bytes smem
"""


def test_sass_reader_counts_the_inner_loop(monkeypatch):
    monkeypatch.setattr(sass, "KERNELS", {
        "base": "direct_tile_kernelILi0ELi0ELb1ELb1E",
        "band": "band_kernelILi0ELb1E"})
    prof = sass.profile(_SASS, _LOG)
    base, band = prof["base"], prof["band"]
    assert base["pairs_per_trip"] == 2 and base["slots_per_pair"] == 3.5
    assert base["per_pair"] == {"BRA": 0.5, "FADD": 0.5, "FFMA": 0.5,
                                "FMUL": 0.5, "LDS": 0.5, "MUFU.RSQ": 1.0}
    assert (base["registers"], base["spill_bytes"]) == (40, 12)
    assert band["slots_per_pair"] == 3 and band["per_pair"]["FSETP"] == 1
    assert band["registers"] is None
    assert sass.opcode("@!P0 FSETP.GEU.AND P0, PT, R1, R2, PT") == "FSETP"
    monkeypatch.setattr(sass, "KERNELS", {"combine": "combine_kernel"})
    with pytest.raises(KeyError, match="combine"):
        sass.profile(_SASS, "")


# A moment kernel's step loop in miniature: each lane computes four pair
# factors a step (four MUFU.RSQ), splits them, and issues the tensor-core
# products; the staging loop before it holds no rsqrt.
_MOMENT_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_118moment_tile_kernelILi0ELb1ELb1ELb1ELb0EEEvPKf
.L_x_7:
        /*0000*/                   LDG.E R2, desc[UR4][R4.64] ;  /* 0x0 */
        /*0010*/                   STS [R3], R2 ;  /* 0x0 */
        /*0020*/               @P0 BRA `(.L_x_7) ;  /* 0x0 */
.L_x_8:
        /*0030*/                   LDS.128 R4, [R20] ;  /* 0x0 */
        /*0040*/                   FADD R8, R4, -R12 ;  /* 0x0 */
        /*0050*/                   MUFU.RSQ R9, R8 ;  /* 0x0 */
        /*0060*/                   MUFU.RSQ R10, R8 ;  /* 0x0 */
        /*0070*/                   MUFU.RSQ R11, R8 ;  /* 0x0 */
        /*0080*/                   MUFU.RSQ R13, R8 ;  /* 0x0 */
        /*0090*/                   LOP3.LUT R14, R9, 0xffffe000, RZ, 0xc0, !PT ;  /* 0x0 */
        /*00a0*/                   HMMA.1688.F32.TF32 R16, R24, R28, R16 ;  /* 0x0 */
        /*00b0*/                   HMMA.1688.F32.TF32 R16, R26, R28, R16 ;  /* 0x0 */
        /*00c0*/               @P1 BRA `(.L_x_8) ;  /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_122tile_sol_moment_kernelEPKfiS1_iifPf
.L_x_2:
        /*0000*/                   MUFU.RSQ R9, R8 ;  /* 0x0 */
        /*0010*/                   MUFU.RSQ R10, R8 ;  /* 0x0 */
        /*0020*/                   HMMA.1688.F32.TF32 R16, R24, R28, R16 ;  /* 0x0 */
        /*0030*/                   SHFL.IDX PT, R3, R16, R2, 0x1f ;  /* 0x0 */
        /*0040*/                   NOP ;  /* 0x0 */
        /*0050*/               @P1 BRA `(.L_x_2) ;  /* 0x0 */
"""


def test_sass_reader_reads_the_moment_kernels(monkeypatch):
    """The reader finds kernel M's and the moment tile's step loops by
    their new KERNELS entries (the loop with the rsqrts, not the staging
    loop) and counts slots a pair over the MUFU.RSQ a lane issues: four
    pairs a trip in M's loop."""
    labels = {"M": "moment_tile_kernel<ACC,fold,Kahan,skip,exact> "
                   "(M, base pass)",
              "7m": "tile_sol_moment_kernel"}
    assert set(labels.values()) <= set(sass.KERNELS)
    monkeypatch.setattr(sass, "KERNELS", {
        k: sass.KERNELS[v] for k, v in labels.items()})
    prof = sass.profile(_MOMENT_SASS, "")
    m, sol = prof["M"], prof["7m"]
    assert m["pairs_per_trip"] == 4 and m["slots_per_pair"] == 10 / 4
    assert m["per_pair"] == {"BRA": 0.25, "FADD": 0.25, "HMMA": 0.5,
                             "LDS": 0.25, "LOP3": 0.25, "MUFU.RSQ": 1.0}
    assert sol["pairs_per_trip"] == 2 and sol["slots_per_pair"] == 2.5
    assert sol["per_pair"]["SHFL"] == 0.5 and "NOP" not in sol["per_pair"]
