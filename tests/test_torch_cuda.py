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
reading means work was deleted.  The external fields: float32 on the card
against float64 on the CPU within chip_smoke.FIELD_TOL (four times the JAX
package's own float32 error at the same points), with no host sync inside
``force`` and with TF32 allowed; the CylSpline fit's two-set potential
kernel within 2e-6 of its plain version.  The potential forms: two-set
and self-masked within 2e-6 of plain, with h = 0 particles within 3e-6
of the fp64 oracle; the SASS of the acceleration forms keeps its slots a
pair, and the potential forms' hot loop has no self-mask test.  The
defaults of the entry
points land on the card; the SCF tier stays within chip_smoke.SCF_TOL of
float64 with TF32 switched on; the friction term runs without a host
sync, within chip_smoke.DF_TOL of float64.  The tree tier within 3e-6 of
the fp64 oracle; the spray window and an orbit, float32 on the card,
within chip_smoke.SPRAY_TOL of float64 on the CPU; unbinding's
self-potential within 2e-6 of its plain version.
"""
import copy

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
from nbody_streams_tpu_torch.potentials import fit

import chip_smoke
from nbody_streams_tpu_torch.benchmarks.fields import (
    field_builders, field_points)

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
                before = cd.LAUNCHES["single"]
                got = cd._direct_tile(*args, splits=splits)
                torch.cuda.synchronize()
                assert cd.LAUNCHES["single"] == before + 1
                want = cd._direct_tile_reference(*args,
                                                 splits=splits or own)
                assert _rel(got, want) < (2e-6 if kahan else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_potential_kernels_match_plain(dev, kind):
    """The potential forms: two-set with nt != ns (neither a multiple of
    64 for the targets), the sets sharing their first min(nt, ns)
    particles, mask off and on, at S = 1 and the wrapper's S; the
    self-masked single pass at N = 3,000.  The sorted path's passes are
    held in test_two_pass_kernels_match_plain and
    test_split_two_pass_kernels_match_plain."""
    rng = np.random.default_rng(12)
    n = 4500
    pos = torch.tensor(rng.normal(0, 1, (n, 3)), dtype=torch.float32,
                       device=dev)
    gm = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                      device=dev)
    pre = cd._soft_pre(kind, torch.tensor(rng.uniform(0.05, 0.3, n),
                                          dtype=torch.float32, device=dev))
    for nt, ns in ((3001, n), (n, 3001), (3000, 3000)):
        tgt = cd._targets(pos[:nt], pre[:nt])
        src = cd._sources(pos[:ns], gm[:ns], pre[:ns], cd.TN)
        own = cd.split_count("direct", nt, src.shape[1], _sms(dev))
        for mask in (False, True):
            for splits in (1, None):
                args = (tgt, src, kind, "pot", True, 1e-15, mask)
                got = cd._direct_tile(*args, splits=splits)
                want = cd._direct_tile_reference(*args,
                                                 splits=splits or own)
                assert torch.isfinite(got).all()
                assert _rel(got, want) < 2e-6, (nt, ns, mask, splits)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_zero_softening_self_potential_matches_fp64(dev, kind):
    """A quarter of the particles at h = 0, where a missed self pair is
    -G m / sqrt(eps2): the self-masked potential is finite and within 3e-6
    of the fp64 oracle, single pass at N = 3,000 and, for the spline, the
    sorted two-pass path at N = 16,384."""
    from nbody_streams_tpu_torch.ops.pairwise import compute_potential_direct

    for n in (3000, 16384) if kind == "spline" else (3000,):
        xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=5)
        p = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
        mt = torch.tensor(m, dtype=torch.float32, device=dev)
        h = torch.full((n,), H, dtype=torch.float32, device=dev)
        h[::4] = 0.0
        before = cd.BRANCHES["two_pass"]
        phi = cd.cuda_potential(p, mt, h, G, kind, True)
        assert cd.BRANCHES["two_pass"] == before + (n >= cd.SORT_MIN_N)
        want = compute_potential_direct(p.double(), mt.double(), h.double(),
                                        G=G, kernel=kind,
                                        precision="float64")
        assert torch.isfinite(phi).all()
        assert _rel(phi, want) < 3e-6


@pytest.mark.cuda
def test_sass_slots_a_pair(dev):
    """The acceleration forms keep their instruction sequence (14.5 slots a
    pair in the base pass, 32.1 in the band pass), and the potential
    forms' hot loop has no self-mask compare or select."""
    from nbody_streams_tpu_torch.benchmarks import sass

    prof = sass.library_profile()
    base = prof["direct_tile_kernel<NEWTONIAN,ACC,Kahan,skip> (base pass)"]
    band = prof["band_kernel<ACC,Kahan> (band pass)"]
    assert base["slots_per_pair"] == 14.5
    assert round(band["slots_per_pair"], 1) == 32.1
    for label, r in prof.items():
        if "POT" in label:
            # the mask is an integer compare a pair (the loop's own is
            # one a trip); the laws other than the spline select nothing
            assert r["per_pair"].get("ISETP", 0) < 0.5, label
            spline = "SPLINE" in label or label.startswith("band")
            assert spline or "FSEL" not in r["per_pair"], label


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
    before = dict(cd.LAUNCHES)
    base = cd._direct_tile(tgt, src, "newtonian", mode, True, 1e-15, mask,
                           nb, start)
    band = cd._band(tgt, src, start, mode, True, 1e-15, mask, cd.TM, cd.TN,
                    nb)
    torch.cuda.synchronize()
    # the base pass counts as "base", not as the single pass
    assert cd.LAUNCHES == dict(before, base=before["base"] + 1,
                               band=before["band"] + 1)
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


@pytest.fixture(scope="module")
def fields():
    # module fixtures are set up before ``dev`` can skip: skip here too
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return {name: (build(), times)
            for name, (build, times) in field_builders().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(chip_smoke.FIELD_TOL))
def test_field_on_card_matches_fp64(dev, fields, name):
    """Float32 on the card vs float64 on the CPU at 8,192 points, each
    time of the field, with no host sync inside force."""
    pot64, times = fields[name]
    gpu = copy.deepcopy(pot64).to(dev, torch.float32)
    x = field_points(8192)
    xg = torch.tensor(x, device=dev)
    tol_f, tol_p = chip_smoke.FIELD_TOL[name]
    for t in times:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            f = gpu.force(xg, t)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert f.is_cuda and f.dtype == torch.float32
        want = pot64.force(torch.tensor(x.astype(np.float64)), t)
        assert _rel(f.cpu(), want) < tol_f
        phi = gpu.potential(xg, t).cpu()
        want = pot64.potential(torch.tensor(x.astype(np.float64)), t)
        assert _rel(phi, want) < tol_p


@pytest.mark.cuda
def test_cylspline_tf32_cannot_enter(dev, fields):
    """The bicubic contraction is elementwise: allowing TF32 matmuls
    changes nothing."""
    pot64, _ = fields["FIRE BFE"]
    cyl = copy.deepcopy(pot64.components[1]).to(dev, torch.float32)
    x = field_points(8192)
    xg = torch.tensor(x, device=dev)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = cyl.force(xg)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = cyl.force(xg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.equal(on, off)
    want = pot64.components[1].force(torch.tensor(x.astype(np.float64)))
    assert _rel(on.cpu(), want) < chip_smoke.FIELD_TOL["FIRE BFE"][0]


@pytest.mark.cuda
def test_fit_two_set_kernel_matches_plain(dev):
    """fit_cylspline_from_particles on the card: its two-set potential
    kernel (plummer, Kahan) vs the plain version at the kernel's S on the
    fit's own probe grid, and the tables vs the plain version's."""
    xv, m = make_plummer_sphere(8192, M_total=1e9, a=1.0, seed=4)
    pos = xv[:, :3]
    before = cd.LAUNCHES["single"]
    on_card = fit.fit_cylspline_from_particles(pos, m, softening=H,
                                               device=dev)
    assert cd.LAUNCHES["single"] == before + 1
    plain = fit.fit_cylspline_from_particles(pos, m, softening=H,
                                             device="cpu")
    assert _rel(torch.tensor(on_card.phi), torch.tensor(plain.phi)) < 2e-6
    probes = fit.cylspline_grid(pos)[3]
    pre = cd._soft_pre("plummer", torch.zeros(len(probes), device=dev))
    tgt = cd._targets(torch.tensor(probes, dtype=torch.float32, device=dev),
                      pre)
    src = cd._sources(
        torch.tensor(pos, dtype=torch.float32, device=dev),
        torch.tensor(m * G, dtype=torch.float32, device=dev),
        cd._soft_pre("plummer", torch.full((len(m),), H, device=dev)),
        cd.TN)
    splits = cd.split_count("direct", tgt.shape[1], src.shape[1], _sms(dev))
    got = cd._direct_tile(tgt, src, "plummer", "pot", True, 1e-15)
    want = cd._direct_tile_reference(tgt, src, "plummer", "pot", True, 1e-15,
                                     splits=splits)
    assert _rel(got, want) < 2e-6


@pytest.mark.cuda
def test_loaders_build_on_the_card(dev):
    """The loaders and the *GPU names build on the card by default, and
    positions that are not tensors are evaluated there."""
    from nbody_streams_tpu_torch import potentials as P

    x = field_points(64).astype(np.float64)
    for pot in (P.make_potential(type="NFW", mass=1e12, scaleRadius=20.0),
                P.NFWPotentialGPU(mass=1e12, scaleRadius=20.0),
                P.load_potential_ini(P.mw_lmc_data_dir().parent
                                     / "MWPotential22.ini")):
        assert all(b.is_cuda for b in pot.buffers())
        f = pot.force(x)
        assert f.is_cuda and f.dtype == torch.float64


@pytest.mark.cuda
def test_defaults_land_on_the_card(dev):
    """DirectGravity, compute_forces_direct / compute_potential_direct of
    numpy input, the SCF solvers, make_king_potential and init_state of
    numpy input build and evaluate on the card unless asked for the CPU,
    and from_jax_state carries a state (its friction state too) onto the
    card."""
    from nbody_streams_tpu_torch import compute_forces_direct as forces
    from nbody_streams_tpu_torch import compute_potential_direct as pot
    from nbody_streams_tpu_torch.fast_sims import make_king_potential
    from nbody_streams_tpu_torch.integrate import from_jax_state
    from nbody_streams_tpu_torch.ops.scf import (
        CompositeSCFGravity, SCFGravity)

    xv, m = make_plummer_sphere(512, M_total=1e9, a=1.0, seed=1)
    solver = DirectGravity(m, np.full(512, H))
    assert solver.device.type == "cuda" and solver.impl == "cuda"
    assert solver.mass.is_cuda
    accel_fn = make_accel_fn(solver, solver.mass)
    state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, 0.0)
    assert state.pos.is_cuda and state.acc.is_cuda
    cpu = DirectGravity(m, np.full(512, H), device="cpu")
    state = init_state(xv[:, :3], xv[:, 3:], make_accel_fn(cpu, cpu.mass),
                       cpu.mass, 0.0, device="cpu")
    assert not state.pos.is_cuda and not state.acc.is_cuda
    for fn in (forces, pot):
        assert fn(xv[:, :3], m, H).is_cuda
        assert not fn(xv[:, :3], m, H, device="cpu").is_cuda
    pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    for s in (SCFGravity(m, a=1.0),
              CompositeSCFGravity(m, groups=[(slice(0, 512), {"a": 1.0})])):
        assert s.mass.is_cuda and s.accel(pos).is_cuda
    king = make_king_potential(1e5, 0.01, W0=5.0)
    assert all(b.is_cuda for b in king.buffers())
    assert king.force(xv[:8, :3] * 0.01).is_cuda
    arrays = {k: np.zeros((512, 3), np.float32) for k in
              ("pos", "vel", "pos_c", "vel_c", "acc", "ext_acc")}
    state = from_jax_state(dict(arrays, step=np.int32(0)),
                           extra_state={"a_df": np.zeros(3), "t_prev": 0.0})
    assert state.pos.is_cuda and state.extra_state["a_df"].is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["allow_tf32", "precision_high"])
def test_scf_fp32_with_tf32_on(dev, how):
    """With TF32 switched on globally the SCF contractions stay IEEE fp32:
    float32 within chip_smoke.SCF_TOL of float64 (TF32 would put the
    potential ~6e-4 off), and the caller's setting comes back."""
    from nbody_streams_tpu_torch.ops.scf import SCFGravity

    xv, m = make_plummer_sphere(65536, M_total=1e9, a=1.0, seed=7)
    p64 = torch.tensor(xv[:, :3], device=dev)
    s64 = SCFGravity(m, a=1.0, precision="float64")
    want = (s64.accel(p64), s64.potential(p64))
    s32 = SCFGravity(m, a=1.0)
    before = torch.get_float32_matmul_precision()
    try:
        if how == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        got = (s32.accel(p64.float()), s32.potential(p64.float()))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
        torch.backends.cuda.matmul.allow_tf32 = before != "highest"
    for g, w, tol in zip(got, want, chip_smoke.SCF_TOL):
        assert _rel(g, w) < tol


@pytest.mark.cuda
def test_friction_on_the_card_matches_fp64_without_sync(dev):
    """The bound_phi friction term on the card in float32, under
    torch.cuda.set_sync_debug_mode('error'), against float64 on the CPU
    within chip_smoke.DF_TOL (the Plummer self-potential as phi)."""
    from nbody_streams_tpu_torch.friction import make_df_force_extra
    from nbody_streams_tpu_torch.potentials import NFWPotential

    xv, m = make_plummer_sphere(65536, M_total=5e9, a=0.5, seed=4)
    r = np.linalg.norm(xv[:, :3], axis=1)
    phi = -G * 5e9 / np.sqrt(r ** 2 + 0.25)
    xv[:, 0] += 40.0
    xv[:, 4] += 120.0
    host = NFWPotential(mass=1e12, scaleRadius=20.0)
    kw = dict(M_sat=5e9, update_interval=10, com_method="bound_phi",
              t_start=0.0, t_end=1.5)
    out = {}
    for where, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        fx = make_df_force_extra(host, **kw).to(where, dtype)
        p, v, mm, ph = (torch.tensor(a, dtype=dtype, device=where)
                        for a in (xv[:, :3], xv[:, 3:], m, phi))
        st = fx.init_state(p, v, mm, 0.2)
        if where == dev:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out[dtype] = fx(st, p, v, mm, 0.202, phi=ph, step=10)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    acc32, st32 = out[torch.float32]
    acc64, st64 = out[torch.float64]
    assert acc32.is_cuda and acc32.dtype == torch.float32
    a32, a64 = st32["a_df"].double().cpu(), st64["a_df"]
    assert float((a32 - a64).norm() / a64.norm()) < chip_smoke.DF_TOL
    assert torch.equal(st32["bound"].cpu(), st64["bound"])


@pytest.mark.cuda
def test_tree_gravity_on_the_card_matches_fp64(dev):
    """tree_gravity_gpu on the card (its default) launches the single-pass
    kernel twice (acceleration, self-masked potential) and stays within
    3e-6 of the fp64 oracle."""
    import nbody_streams_tpu_torch as nst
    from nbody_streams_tpu_torch.ops.pairwise import compute_potential_direct

    n = 4096
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=5)
    before = cd.LAUNCHES["single"]
    acc, phi = nst.tree_gravity_gpu(xv[:, :3], m, eps=H, G=G)
    assert cd.LAUNCHES["single"] == before + 2
    args = [torch.tensor(a, dtype=torch.float64, device=dev)
            for a in (xv[:, :3], m, np.full(n, H))]
    want = (compute_forces_direct(*args, G=G, kernel="plummer",
                                  precision="float64"),
            compute_potential_direct(*args, G=G, kernel="plummer",
                                     precision="float64"))
    for got, ref in zip((acc, phi), want):
        assert got.dtype == np.float32
        assert _rel(torch.as_tensor(got), ref.cpu()) < 3e-6


@pytest.mark.cuda
def test_spray_and_orbit_fp32_on_the_card_match_fp64_cpu(dev):
    """The spray window (chip_smoke.spray_window, at 400 particles) and a
    fixed-step orbit in MWPotential22, float32 on the card against float64
    on the CPU within chip_smoke.SPRAY_TOL."""
    from nbody_streams_tpu_torch import fast_sims as fs
    from nbody_streams_tpu_torch.potentials import load_potential_ini

    mw = load_potential_ini(chip_smoke.MW22)
    mw_cpu = load_potential_ini(chip_smoke.MW22, device="cpu")
    case = chip_smoke.spray_window(num_particles=400)
    got = fs.create_particle_spray_stream(mw, **case, dtype=torch.float32)
    want = fs.create_particle_spray_stream(mw_cpu, **case,
                                           dtype=torch.float64, device="cpu")
    sat = case["sat_cen_present"]
    _, orb32 = fs.integrate_orbit(mw, sat, 0.0, -0.2, n_steps=200,
                                  dtype=torch.float32)
    _, orb64 = fs.integrate_orbit(mw_cpu, sat, 0.0, -0.2, n_steps=200,
                                  dtype=torch.float64, device="cpu")
    for key, a, b in (("rewind", got["prog_xv"], want["prog_xv"]),
                      ("rewind", orb32, orb64),
                      ("stream", got["part_xv"][:, -1],
                       want["part_xv"][:, -1])):
        assert np.isfinite(a).all()
        for sl, tol in zip((slice(0, 3), slice(3, 6)),
                           chip_smoke.SPRAY_TOL[key]):
            err = np.abs(a[:, sl] - b[:, sl]).max() / np.abs(b[:, sl]).max()
            assert err <= tol, (key, sl, err)


@pytest.mark.cuda
def test_self_potential_on_the_card_matches_plain(dev):
    """Unbinding's direct self-potential on the card (the single-pass
    kernel's potential form, one launch) within 2e-6 of its plain version
    on the CPU."""
    from nbody_streams_tpu_torch.utils.main import _self_potential

    xv, m = make_plummer_sphere(5000, M_total=1e9, a=1.0, seed=6)
    before = cd.LAUNCHES["single"]
    got = _self_potential(xv[:, :3], m, softening=H, G=G)
    assert cd.LAUNCHES["single"] == before + 1
    want = _self_potential(xv[:, :3], m, softening=H, G=G, device="cpu")
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6
