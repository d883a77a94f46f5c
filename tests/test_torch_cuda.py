"""The CUDA kernels against their plain torch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (max |kernel - plain| / max |plain|), the plain version called
with the kernel's split count S: 2e-6 with Kahan and 1e-5 without (fp32
sums in another order within a tile; rsqrt within 2 ulp on both sides);
3e-6 against the fp64 oracle (the JAX package's kernel-vs-oracle
tolerance); 1e-6 between the 'cuda' and 'torch' impls over 10 KDK steps.
The roofline chains: 1e-5 (the kernel contracts acc * v + v into one
FFMA, torch rounds twice; rsqrt within 2 ulp on both sides; the
recurrences contract, so the differences do not grow).  Every roofline
rate stays <= 1.05 x the card's peak (SM count x max clock): a higher
reading means work was deleted.
"""
import numpy as np
import pytest
import torch

from nbody_streams_tpu_torch import make_plummer_sphere
from nbody_streams_tpu_torch.integrate import (
    init_state,
    make_accel_fn,
    make_kdk_step,
    run_chunk,
)
from nbody_streams_tpu_torch.benchmarks import tile_sweep
from nbody_streams_tpu_torch.ops import cuda_direct as cd
from nbody_streams_tpu_torch.ops import probe
from nbody_streams_tpu_torch.ops import roofline as rl
from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
from nbody_streams_tpu_torch.ops.pairwise import compute_forces_direct

KINDS = ["newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline"]
G = 4.300917270069976e-06
H = 0.05


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc "
                    "(python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _rel(got, want):
    d = (got.double() - want.double()).abs().max()
    return float(d / want.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_direct_tile_kernel_matches_plain(dev, kind):
    """All laws x acc/pot x Kahan on/off at a ragged N = 3,000, at the
    wrapper's own S and at S = 1, 2 and 4."""
    rng = np.random.default_rng(5)
    n = 3000
    pos = torch.tensor(rng.normal(0, 1, (n, 3)), dtype=torch.float32,
                       device=dev)
    gm = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                      device=dev)
    pre = cd._soft_pre(kind, torch.tensor(rng.uniform(0.05, 0.3, n),
                                          dtype=torch.float32, device=dev))
    tgt, src = cd._targets(pos, pre), cd._sources(pos, gm, pre, cd.TN)
    own = cd.split_count("direct", n, src.shape[1], _sms(dev))
    assert own > 1
    for mode in ("acc", "pot"):
        for kahan in (True, False):
            args = (tgt, src, kind, mode, kahan, 1e-15, mode == "pot")
            for splits in (None, 1, 2, 4):
                before = cd.LAUNCHES["direct"]
                got = cd._direct_tile(*args, splits=splits)
                torch.cuda.synchronize()
                assert cd.LAUNCHES["direct"] == before + 1
                want = cd._direct_tile_reference(*args,
                                                 splits=splits or own)
                assert _rel(got, want) < (2e-6 if kahan else 1e-5)


def _bench_operands(dev):
    xv, m = make_plummer_sphere(65536, M_total=1e9, a=1.0, seed=2)
    pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    ps = pos[cd.slab_sort_key(pos)]
    h = torch.full((65536,), H, device=dev)
    hinv = cd._soft_pre("spline", h)
    gm = torch.full((65536,), m[0] * G, device=dev)
    first, width, rows = cd.band_window(ps[:, 0], h.max())
    nb = cd.band_rows(rows)
    assert int(width) <= nb
    start = first.clamp(0, rows - nb).to(torch.int32).contiguous()
    return cd._targets(ps, hinv), cd._sources(ps, gm, hinv, cd.TN), start, nb


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["acc", "pot"])
def test_two_pass_kernels_match_plain(dev, mode):
    """skip_band base pass and band pass at the bench case's N = 65,536,
    each at the S the wrapper picks (more than one at this N)."""
    tgt, src, start, nb = _bench_operands(dev)
    mask = mode == "pot"
    ns = src.shape[1]
    s_base = cd.split_count("direct", 65536, ns, _sms(dev), nb, cd.TN)
    s_band = cd.split_count("band", 65536, ns, _sms(dev), nb, cd.TN)
    assert s_base > 1 and s_band > 1
    base = cd._direct_tile(tgt, src, "newtonian", mode, True, 1e-15, mask,
                           nb, start)
    band = cd._band(tgt, src, start, mode, True, 1e-15, mask, cd.TM, cd.TN,
                    nb)
    torch.cuda.synchronize()
    assert _rel(base, cd._direct_tile_reference(
        tgt, src, "newtonian", mode, True, 1e-15, mask, nb, start,
        splits=s_base)) < 2e-6
    assert _rel(band, cd._band_reference(
        tgt, src, start, mode, True, 1e-15, mask, cd.TM, cd.TN, nb,
        splits=s_band)) < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["acc", "pot"])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_split_two_pass_kernels_match_plain(dev, splits, mode):
    """Both passes at a forced S, against their plain versions at that S,
    and the same bits on a repeated launch (the fixed-order combine)."""
    tgt, src, start, nb = _bench_operands(dev)
    mask = mode == "pot"
    runs = {"base": lambda: cd._direct_tile(
                tgt, src, "newtonian", mode, True, 1e-15, mask, nb, start,
                splits=splits),
            "band": lambda: cd._band(tgt, src, start, mode, True, 1e-15, mask,
                                     cd.TM, cd.TN, nb, splits=splits)}
    want = {"base": cd._direct_tile_reference(
                tgt, src, "newtonian", mode, True, 1e-15, mask, nb, start,
                splits=splits),
            "band": cd._band_reference(tgt, src, start, mode, True, 1e-15,
                                       mask, cd.TM, cd.TN, nb, splits)}
    for name, run in runs.items():
        got = run()
        again = run()
        torch.cuda.synchronize()
        assert _rel(got, want[name]) < 2e-6, name
        assert torch.equal(got, again), name


@pytest.mark.cuda
def test_rsqrt_ftz_matches_ieee_on_normal_arguments(dev):
    """rsqrt_ftz (the force kernels' rsqrt) gives rsqrtf's bits for every
    normal float32 from the least normal to the largest, and differs only
    below it, where it flushes the argument to zero."""
    rng = np.random.default_rng(1)
    x = np.concatenate([
        np.geomspace(np.finfo(np.float32).tiny, np.finfo(np.float32).max,
                     1 << 20),
        rng.uniform(1e-15, 1e4, 1 << 20)]).astype(np.float32)
    xt = torch.tensor(x, device=dev)
    ieee, ftz = cd._rsqrt_pair(xt)
    assert torch.equal(ieee, ftz)
    denormal = torch.tensor([1e-40, 1e-44], dtype=torch.float32, device=dev)
    ieee, ftz = cd._rsqrt_pair(denormal)
    assert torch.isfinite(ieee).all() and torch.isinf(ftz).all()


@pytest.mark.cuda
def test_sorted_path_matches_fp64_oracle(dev):
    xv, m = make_plummer_sphere(16384, M_total=1e9, a=1.0, seed=4)
    p = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    mt = torch.tensor(m, dtype=torch.float32, device=dev)
    ht = torch.full((16384,), H, dtype=torch.float32, device=dev)
    before = cd.BRANCHES["two_pass"]
    acc = cd.cuda_accel(p, mt, ht, G, "spline", True)
    assert cd.BRANCHES["two_pass"] == before + 1
    want = compute_forces_direct(p.double(), mt.double(), ht.double(), G=G,
                                 precision="float64")
    assert _rel(acc, want) < 3e-6


@pytest.mark.cuda
def test_kahan_beats_plain_fp32(dev):
    """One heavy near source first, then light far ones each below half an
    ulp of the running sum: plain fp32 drops them all."""
    n = 65536
    rng = np.random.default_rng(9)
    xs = np.empty((n, 3))
    xs[0] = (1.0, 0.0, 0.0)
    xs[1:] = (100.0, 0.0, 0.0) + rng.normal(0, 1.0, (n - 1, 3))
    gm = np.full(n, 5e-6)
    gm[0] = 1.0
    x32, g32 = (a.astype(np.float32).astype(np.float64) for a in (xs, gm))
    exact = (g32 / np.linalg.norm(x32, axis=1) ** 3 * x32[:, 0]).sum()
    tgt = cd._targets(torch.zeros((1, 3), device=dev),
                      torch.zeros(1, device=dev))
    src = cd._sources(torch.tensor(xs, dtype=torch.float32, device=dev),
                      torch.tensor(gm, dtype=torch.float32, device=dev),
                      torch.zeros(n, device=dev), cd.TN)
    # one stream (S = 1): splits would cut the run of light sources into
    # partial sums that plain fp32 no longer drops
    err = {k: abs(cd._direct_tile(tgt, src, "newtonian", "acc", k, 1e-15,
                                  splits=1)[0, 0].item() - exact) / exact
           for k in (True, False)}
    assert err[True] * 10 < err[False]


@pytest.mark.cuda
def test_cuda_impl_matches_torch_impl_over_kdk_steps(dev):
    xv, m = make_plummer_sphere(16384, M_total=1e9, a=1.0, seed=3)
    finals = {}
    for impl in ("cuda", "torch"):
        solver = DirectGravity(m, np.full(16384, H), impl=impl, device=dev)
        accel_fn = make_accel_fn(solver, solver.mass)
        presort = solver.spatial_sort_active
        state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, 0.0,
                           sort_fn=solver.sort_key if presort else None,
                           device=dev)
        finals[impl] = run_chunk(make_kdk_step(accel_fn, 2e-5, 0.0), state,
                                 10, presort=presort,
                                 presort_every=solver.presort_interval)
    for field in ("pos", "vel"):
        assert _rel(getattr(finals["cuda"], field),
                    getattr(finals["torch"], field)) < 1e-6


@pytest.mark.cuda
def test_band_window_outside_the_sources_gives_nan(dev):
    tgt, src, start, nb = _bench_operands(dev)
    bad = start.clone()
    bad[0] = src.shape[1] // cd.TN - nb + 1
    out = cd._band(tgt, src, bad, "acc", True, 1e-15, False, cd.TM, cd.TN,
                   nb).cpu()
    assert torch.isnan(out[:cd.TM]).all()
    assert torch.isfinite(out[cd.TM:]).all()


@pytest.mark.cuda
def test_wrapper_raises_on_bad_operands(dev):
    tgt = torch.zeros((4, 100), device=dev)
    src = torch.zeros((5, 100), device=dev)   # not a multiple of BLOCK
    with pytest.raises(ValueError, match="multiple"):
        cd._direct_tile(tgt, src, "spline", "acc", True, 1e-15)
    with pytest.raises(ValueError, match="one device"):
        cd._direct_tile(tgt, torch.zeros((5, 128)), "spline", "acc", True,
                        1e-15)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fma_chain", "rsqrt_chain"])
def test_chain_kernels_match_plain(dev, name):
    """At K = 256 the chains sit at their fixed point; at K = 16 every
    link still moves the output, so that check sees the links done."""
    x = probe.probe_tile(dev)
    for K, passes in ((256, 4), (16, 2)):
        before = rl.LAUNCHES[name]
        got = getattr(rl, name)(x, K, passes)
        torch.cuda.synchronize()
        assert rl.LAUNCHES[name] == before + 1
        want = getattr(rl, f"_{name}_reference")(x, K, passes)
        assert torch.isfinite(got).all()
        assert _rel(got, want) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["newtonian", "spline"])
def test_tile_sol_kernel_matches_plain(dev, kind):
    """Targets and source tiles both wrap (300 blocks over 5,000 targets
    and 64 tiles)."""
    tgt, src = tile_sweep.sol_operands(kind, 5000, 4096, dev)
    before = rl.LAUNCHES["tile_sol"]
    got = rl.tile_sol(tgt, src, kind, 300, 8)
    torch.cuda.synchronize()
    assert rl.LAUNCHES["tile_sol"] == before + 1
    assert _rel(got, rl._tile_sol_reference(tgt, src, kind, 300, 8)) < 2e-6


@pytest.mark.cuda
def test_roofline_rates_within_the_card_peak(dev):
    peaks = probe.card_peaks(dev)
    r = tile_sweep.roofline(dev, K=512, passes=256, reps=1)
    assert 0 < r["fma"]["g_ops_per_s"] * 1e9 <= 1.05 * peaks["fp32_ops_per_s"]
    assert 0 < r["rsqrt"]["g_lanes_per_s"] * 1e9 <= 1.05 * peaks["mufu_per_s"]
    for kind in ("newtonian", "spline"):
        s = tile_sweep.sol(kind, reps=64, device=dev, timing_reps=1)
        assert s["blocks"] >= peaks["sms"]
        # one MUFU rsqrt per pair at least
        assert 0 < s["g_pairs_per_s"] * 1e9 <= 1.05 * peaks["mufu_per_s"]


@pytest.mark.cuda
def test_tile_config_geometry_agrees_with_default(dev):
    xv, m = make_plummer_sphere(16384, M_total=1e9, a=1.0, seed=4)
    p = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    base = DirectGravity(m, np.full(16384, H), device=dev).accel(p)
    for tile in ({"tm": 256, "tn": 256}, {"tm": 128, "tn": 512}):
        got = DirectGravity(m, np.full(16384, H), device=dev,
                            tile_config=tile).accel(p)
        assert _rel(got, base) < 2e-6
