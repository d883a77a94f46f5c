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


def test_cpu_tensors_run_the_plain_versions():
    before = dict(rl.LAUNCHES)
    x = probe.probe_tile("cpu", (8, 8))
    assert torch.equal(rl.fma_chain(x, 8, 2), rl._fma_chain_reference(x, 8, 2))
    assert torch.equal(rl.rsqrt_chain(x, 8, 2),
                       rl._rsqrt_chain_reference(x, 8, 2))
    tgt, src, _ = _sol_case("spline")
    assert torch.equal(rl.tile_sol(tgt, src, "spline", 2, 2),
                       rl._tile_sol_reference(tgt, src, "spline", 2, 2))
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
    assert solver.spatial_sort_active
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
    with pytest.warns(PerformanceWarning, match=match):
        DirectGravity(np.full(64, 1.0), 0.05, impl="cuda", tile_config=tile,
                      device="cpu")


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


def test_bench_suite_has_no_sharded_row():
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        bench_suite.main_sharded()


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
