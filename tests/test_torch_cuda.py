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
sync, within chip_smoke.DF_TOL of float64; its centre term replayed from
a CUDA graph within 1e-6 of the eager term on the card, and eager where
the field reads the host.  The tree tier within 3e-6 of
the fp64 oracle; the spray window and an orbit, float32 on the card,
within chip_smoke.SPRAY_TOL of float64 on the CPU; unbinding's
self-potential within 2e-6 of its plain version.  The SPH render on the
card within chip_smoke.RENDER_TOL of the same render on the CPU, holding
the frame's mass within chip_smoke.MASS_TOL; the native host library's
kNN on the card machine within chip_smoke.KNN_TOL of cKDTree.  The
scale drivers: the flagship stopped and resumed within 1e-6 of max of an
unbroken run, gate1m's |dE/E| < 1e-4.  The MW + LMC satellite at
N = 262,145 on the two passes in every evaluation, its force within 3e-6
of the fp64 oracle; the stream deployment's King cluster at N = 262,144
in McMillan17 on the single pass in every evaluation, its band windows
wider than the band, its force within 3e-6 of the fp64 oracle.  The program's spans: 95% of their
stored times within 50 us of the profiler's events with CUDA activity on,
the median within 10 us, and at least 90% of a traced 65,536-body run's device idle time under one.
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
        state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, 0.0,
                           device=dev)
        finals[impl] = run_chunk(make_kdk_step(accel_fn, 2e-5, 0.0), state,
                                 10)
    for field in ("pos", "vel"):
        assert _rel(getattr(finals["cuda"], field),
                    getattr(finals["torch"], field)) < 1e-6


@pytest.mark.cuda
def test_satellite_steps_take_the_two_pass_path(dev):
    """The flagship's satellite (its three components, Eddington DF) at
    N = 262,145 in the MW + LMC field with friction, dt = 5e-4: the
    solver sorts the drifted positions it is given, so every evaluation
    takes the two passes, where the order one drift old overflows the
    band; the force on the final state is within 3e-6 of the float64 sum
    at 4,096 targets."""
    from nbody_streams_tpu_torch.benchmarks import flagship2m as fl
    from nbody_streams_tpu_torch.friction import make_df_force_extra
    from nbody_streams_tpu_torch.potentials.mwlmc import (
        load_mw_lmc_potential)
    from nbody_streams_tpu_torch.run import run_copies
    from nbody_streams_tpu_torch.species import _build_particle_arrays

    n, steps, dt, t0 = 262_145, 4, 5e-4, -0.1
    xv, species = fl.build_ics(n, seed=7, device=dev)
    mass, soft = _build_particle_arrays(species)
    field = load_mw_lmc_potential(device=dev)[0]
    fx = make_df_force_extra(field, M_sat=float(mass.sum()), G=G,
                             t_start=t0, t_end=t0 + steps * dt,
                             coulomb_mode="variable", update_interval=10)
    field, fx = run_copies(field, fx, mass, dev, torch.float32)
    solver = DirectGravity(mass, soft, G=G, kernel="spline", device=dev)
    accel_fn = make_accel_fn(solver, solver.mass, field, 1, fx)
    step_fn = make_kdk_step(accel_fn, dt, t0)
    before = dict(cd.BRANCHES)
    state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, t0,
                       force_extra=fx, device=dev)
    prev = run_chunk(step_fn, state, steps - 1)
    last = step_fn(prev)
    got = solver.accel(last.pos)
    assert cd.BRANCHES["single_pass"] == before["single_pass"]
    assert cd.BRANCHES["two_pass"] == before["two_pass"] + steps + 2
    h = solver.softening.max()
    stale_order = cd.slab_sort_key(prev.pos)
    _, stale, rows = cd.band_window(last.pos[stale_order][:, 0], h)
    _, own, _ = cd.band_window(last.pos[cd.slab_sort_key(last.pos)][:, 0],
                               h)
    assert int(own) <= cd.band_rows(rows) < int(stale)
    idx = np.random.default_rng(0).choice(n, 4096, replace=False)
    want = chip_smoke.direct64_at(last.pos, G * mass, soft, idx, dev,
                                  "spline", "acc", chunk=(1024, 131072))
    rel = np.abs(got[idx].double().cpu().numpy() - want).max()
    assert rel / np.abs(want).max() < 3e-6


def _king_cluster(n):
    """The stream deployment's King cluster (W0 = 5, r_c = 0.02 kpc, 5e6
    Msun) of ``n`` bodies at (14, 0, 6) kpc, (30, 150, -10) km/s."""
    from nbody_streams_tpu_torch.fast_sims.king import sample_king

    xv, m = sample_king(n, mass=5e6, r_core=0.02, W0=5.0, seed=2)
    xv[:, :3] += np.array([14.0, 0.0, 6.0])
    xv[:, 3:] += np.array([30.0, 150.0, -10.0])
    return xv, m


@pytest.mark.cuda
def test_king_cluster_steps_take_two_passes_on_a_widened_band(dev):
    """The stream deployment's King cluster (h = 0.004 kpc) at N = 262,144
    in the static McMillan17 field, dt = 5e-4, 3 steps: its core outgrows
    the static band, so every evaluation widens the band to its widest
    window and takes the two passes (the band each call ran is its
    window); the final force is within 3e-6 of the float64 sum at 4,096
    targets."""
    from nbody_streams_tpu_torch.potentials import make_potential
    from nbody_streams_tpu_torch.potentials.mwlmc import mw_lmc_data_dir
    from nbody_streams_tpu_torch.run import run_copies

    n, steps, dt, t0, h = 262_144, 3, 5e-4, 0.0, 0.004
    xv, m = _king_cluster(n)
    mass, soft = torch.as_tensor(m), torch.full((n,), h, dtype=torch.float64)
    field = make_potential(
        file=mw_lmc_data_dir() / "McMillan17_streams.ini", device=dev)
    field, _ = run_copies(field, None, mass, dev, torch.float32)
    solver = DirectGravity(mass, soft, G=G, kernel="spline", device=dev)
    accel_fn = make_accel_fn(solver, solver.mass, field, 1)
    step_fn = make_kdk_step(accel_fn, dt, t0)
    before = dict(cd.BRANCHES)
    state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, t0,
                       device=dev)
    last = run_chunk(step_fn, state, steps)
    got = solver.accel(last.pos)
    took = {k: cd.BRANCHES[k] - before[k] for k in before}
    assert took["two_pass"] == took["widened"] == steps + 2
    assert took["single_pass"] == 0
    assert took["window_rows"] == took["band_rows"] > 0
    idx = np.random.default_rng(0).choice(n, 4096, replace=False)
    want = chip_smoke.direct64_at(last.pos, G * mass, soft, idx, dev,
                                  "spline", "acc", chunk=(1024, 131072))
    rel = np.abs(got[idx].double().cpu().numpy() - want).max()
    assert rel / np.abs(want).max() < 3e-6


@pytest.mark.cuda
def test_king_cluster_at_a_million_runs_its_window_as_the_band(dev):
    """The King cluster at the stream cell's N = 2^20 (h = 0.004 kpc), one
    evaluation: the widest window outgrows the static band (128 of 2,048
    rows) but not BAND_MAX_SHARE of the rows, so the call widens the band
    to the window and takes the two passes, within 3e-6 of the float64
    sum at 4,096 targets."""
    n, h = 1 << 20, 0.004
    xv, m = _king_cluster(n)
    mass, soft = torch.as_tensor(m), torch.full((n,), h, dtype=torch.float64)
    solver = DirectGravity(mass, soft, G=G, kernel="spline", device=dev)
    pos = torch.as_tensor(xv[:, :3], dtype=torch.float32, device=dev)
    _, width, rows = cd.band_window(pos[cd.slab_sort_key(pos), 0], h)
    width = int(width)
    assert cd.band_rows(rows) < width <= cd.BAND_MAX_SHARE * rows
    before = dict(cd.BRANCHES)
    got = solver.accel(pos)
    took = {k: cd.BRANCHES[k] - before[k] for k in before}
    assert (took["two_pass"], took["single_pass"], took["widened"]) == (1, 0,
                                                                        1)
    assert took["band_rows"] == took["window_rows"] == width
    idx = np.random.default_rng(0).choice(n, 4096, replace=False)
    want = chip_smoke.direct64_at(pos, G * mass, soft, idx, dev, "spline",
                                  "acc", chunk=(1024, 131072))
    rel = np.abs(got[idx].double().cpu().numpy() - want).max()
    assert rel / np.abs(want).max() < 3e-6


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
def test_tile_sol_moment_kernel_matches_plain(dev):
    """The moment tile's speed of light (tile_sol_moment_kernel, kernel
    M's step loop): 300 blocks over 5,000 targets and 64 tiles, 8 passes,
    against its plain version within chip_smoke.MOMENT_TOL (the moments
    before the finalisation: no cancellation to excuse); one launch."""
    tgt, src = tile_sweep.sol_operands("newtonian", 5000, 4096, dev)
    before = rl.LAUNCHES["tile_sol_moment"]
    got = rl.tile_sol(tgt, src, "newtonian", 300, 8, mxu=True)
    torch.cuda.synchronize()
    assert rl.LAUNCHES["tile_sol_moment"] == before + 1
    want = rl._tile_sol_moment_reference(tgt, src, "newtonian", 300, 8)
    assert torch.isfinite(got).all()
    assert _rel(got, want) < chip_smoke.MOMENT_TOL


@pytest.mark.cuda
def test_tile_sol_moment_rates_within_the_card_peaks(dev):
    """At full occupancy the moment tile's pair rate stays within 1.05 x
    the MUFU peak (one rsqrt a pair) and its TF32 rate within 1.05 x the
    tensor cores' dense peak."""
    peaks = probe.card_peaks(dev)
    s = tile_sweep.sol("newtonian", reps=64, device=dev, timing_reps=1,
                       mxu=True)
    assert s["mxu"] is True and s["blocks"] >= peaks["sms"]
    rate = s["g_pairs_per_s"] * 1e9
    assert 0 < rate <= 1.05 * peaks["mufu_per_s"]
    assert (rate * chip_smoke.TENSOR_FLOPS["fold"]
            <= 1.05 * chip_smoke.PEAK_TF32)


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


def _satellite_friction(fx, where, dtype, calls=25, t0=-0.02, dt=1e-3):
    """``calls`` consecutive friction calls on a 4,096-body satellite at
    (52, 0, 35) kpc, t from ``t0`` by ``dt`` (a refresh every 10 calls;
    from -0.02 the LMC's table has a breakpoint at -0.015625): each
    call's a_df in float64 on the CPU, the replays each call added, and
    the last state."""
    from nbody_streams_tpu_torch import friction as tf

    rng = np.random.default_rng(3)
    xv = np.concatenate([rng.normal(0.0, 1.0, (4096, 3)) + [52, 0, 35],
                         rng.normal(0.0, 20.0, (4096, 3))
                         + [-35, 95, -40]], 1)
    r = np.linalg.norm(xv[:, :3] - [52, 0, 35], axis=1)
    phi = -G * 2.25e9 / np.sqrt(r ** 2 + 1.0)
    p, v, m, ph = (torch.tensor(a, dtype=dtype, device=where)
                   for a in (xv[:, :3], xv[:, 3:],
                             np.full(4096, 2.25e9 / 4096), phi))
    st = fx.init_state(p, v, m, t0)
    out, replays = [], []
    for k in range(calls):
        before = tf.GRAPHS["replayed"]
        _, st = fx(st, p, v, m, t0 + (k + 1) * dt, phi=ph, step=k)
        out.append(st["a_df"].double().cpu())
        replays.append(tf.GRAPHS["replayed"] - before)
    return torch.stack(out), replays, st


@pytest.mark.cuda
@pytest.mark.parametrize("com_method", ["shrinking_sphere", "bound_phi"])
def test_friction_graph_matches_eager_and_fp64(dev, monkeypatch,
                                              com_method):
    """The friction's centre term in the MW + LMC field, replayed from
    its CUDA graph over 25 calls (three refreshes, a breakpoint of the
    LMC's trajectory crossed): within 1e-6 of the eager term on the card
    and within chip_smoke.DF_TOL of float64 on the CPU, a replay in every
    call from the second on, and a carried state that shares no memory
    with the graph."""
    from nbody_streams_tpu_torch import friction as tf
    from nbody_streams_tpu_torch.potentials.mwlmc import (
        load_mw_lmc_potential)

    field = load_mw_lmc_potential(device="cpu")[0]
    kw = dict(M_sat=2.25e9, G=G, update_interval=10, t_start=-0.02,
              t_end=0.0, com_method=com_method)
    fx = tf.make_df_force_extra(field, **kw).to(dev, torch.float32)
    graph, replays, st = _satellite_friction(fx, dev, torch.float32)
    assert replays == [0] + [1] * 24
    # the state carried on is the caller's: filling the graph's output
    # leaves it as it was
    kept = st["a_df"].clone()
    fx._graph.out.fill_(float("nan"))
    assert torch.equal(st["a_df"], kept)

    class _NoCapture:
        def __init__(self, *args):
            raise RuntimeError("no capture")

    monkeypatch.setattr(tf, "_CentreGraph", _NoCapture)
    fallback = tf.GRAPHS["fallback"]
    fx = tf.make_df_force_extra(field, **kw).to(dev, torch.float32)
    with pytest.warns(RuntimeWarning, match="stays eager"):
        eager, replays, _ = _satellite_friction(fx, dev, torch.float32)
    assert replays == [0] * 25 and fx._graph is False
    assert tf.GRAPHS["fallback"] == fallback + 1
    fx = tf.make_df_force_extra(field, **kw).to("cpu", torch.float64)
    want, _, _ = _satellite_friction(fx, "cpu", torch.float64)
    assert float(((graph - eager).norm(dim=1)
                  / eager.norm(dim=1)).max()) < 1e-6
    assert float(((graph - want).norm(dim=1)
                  / want.norm(dim=1)).max()) < chip_smoke.DF_TOL


@pytest.mark.cuda
def test_friction_graph_falls_back_where_the_field_reads_the_host(dev):
    """A field whose potential reads its time back to the host cannot be
    captured: the run counts a fallback and stays eager, with the eager
    results of the same field that does not read, and the next run
    captures again."""
    from nbody_streams_tpu_torch import friction as tf
    from nbody_streams_tpu_torch.potentials import NFWPotential

    class HostReadNFW(NFWPotential):
        def _phi(self, arr, t):
            return super()._phi(arr, t) * (1.0 + 0.0 * float(t))

    kw = dict(M_sat=2.25e9, G=G, update_interval=10, t_start=-0.02,
              t_end=0.0)
    before = dict(tf.GRAPHS)
    fx = tf.make_df_force_extra(HostReadNFW(mass=1e12, scaleRadius=20.0),
                                **kw).to(dev, torch.float32)
    with pytest.warns(RuntimeWarning, match="stays eager"):
        got, replays, _ = _satellite_friction(fx, dev, torch.float32,
                                              calls=5)
    assert fx._graph is False and replays == [0] * 5
    assert tf.GRAPHS["fallback"] == before["fallback"] + 1
    assert tf.GRAPHS["captured"] == before["captured"]
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    host = NFWPotential(mass=1e12, scaleRadius=20.0)
    fx = tf.make_df_force_extra(host, **kw).to(dev, torch.float32)
    graph, replays, _ = _satellite_friction(fx, dev, torch.float32, calls=5)
    assert replays == [0, 1, 1, 1, 1]
    fx = tf.make_df_force_extra(host, **kw).to("cpu", torch.float64)
    want, _, _ = _satellite_friction(fx, "cpu", torch.float64, calls=5)
    for a in (got, graph):
        assert float(((a - want).norm(dim=1)
                      / want.norm(dim=1)).max()) < chip_smoke.DF_TOL
    assert float(((got - graph).norm(dim=1)
                  / graph.norm(dim=1)).max()) < 1e-6


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


@pytest.mark.cuda
def test_render_on_the_card_matches_cpu(dev):
    from nbody_streams_tpu_torch.viz import sph

    npix = chip_smoke.RENDER_NPIX
    xv, m = make_plummer_sphere(65_536, M_total=1e9, a=1.0, seed=3)
    pos = xv[:, :3]
    h = sph.get_smoothing_lengths(pos[:, :2])
    img, ext = sph.render_surface_density(pos, m, npix=npix, smoothing=h)
    ref, ext_cpu = sph.render_surface_density(pos, m, npix=npix,
                                              smoothing=h, arch="cpu")
    assert ext == ext_cpu and np.isfinite(img).all()
    assert _rel(torch.as_tensor(img), torch.as_tensor(ref)) \
        <= chip_smoke.RENDER_TOL
    area = (ext[1] - ext[0]) * (ext[3] - ext[2]) / npix ** 2
    want = chip_smoke.frame_mass(pos[:, :2], m, h, ext, npix)
    assert abs(img.sum() * area - want) / want <= chip_smoke.MASS_TOL
    args = chip_smoke.splat_args(pos[:, :2], m, h, ext, npix, dev)
    assert sph._splat(*args).is_cuda


@pytest.mark.cuda
def test_native_knn_on_the_card_machine(dev):
    from nbody_streams_tpu_torch import native

    assert native.build(verbose=False)
    xv, _ = make_plummer_sphere(262_144, M_total=1e9, a=1.0, seed=8)
    pos = xv[:, :3]
    want = native.knn_radius_ckdtree(pos, 32)
    got = native.knn_radius(pos, 32)
    assert np.max(np.abs(got - want) / want) <= chip_smoke.KNN_TOL
    order = native.morton_argsort(pos)
    assert np.array_equal(np.sort(order), np.arange(len(pos)))


# ---------------------------------------------------------------------------
# the ring over virtual shards of the card
# ---------------------------------------------------------------------------

def _ring_case(n, seed=2, sort=True):
    from nbody_streams_tpu_torch.parallel.sharded import (
        slab_sort_for_sharding)

    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=seed)
    h = np.full(n, H)
    if sort:
        xv, m, h = slab_sort_for_sharding(xv, m, h)
    return xv, m, h


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 8193])
def test_ring_on_virtual_shards_matches_one_card(dev, n):
    """The ring over ['cuda:0'] * 4 against the one-card solver, force and
    potential, within 2e-6 * max; at N = 8,193 the ring pads 3 ghost rows
    inside the solver: N rows in, N rows out."""
    xv, m, h = _ring_case(n)
    ring = DirectGravity(m, h, G=G, impl="sharded", devices=["cuda:0"] * 4)
    one = DirectGravity(m, h, G=G, impl="cuda", device=dev)
    assert ring._sharded.use_kernels and ring._sharded.npad == n + (-n) % 4
    pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    before = cd.LAUNCHES["single"]
    for mode in ("accel", "potential"):
        got = getattr(ring, mode)(pos)
        assert got.is_cuda and torch.isfinite(got).all()
        assert got.shape[0] == n
        assert _rel(got, getattr(one, mode)(pos)) < 2e-6
    assert cd.LAUNCHES["single"] - before >= 2 * 16


@pytest.mark.cuda
def test_ring_far_tiles_on_the_card(dev):
    from nbody_streams_tpu_torch.parallel.sharded import TILES

    for sort, expect_far in ((True, True), (False, False)):
        xv, m, h = _ring_case(65_536, sort=sort)
        ring = DirectGravity(m, h, G=G, impl="sharded",
                             devices=["cuda:0"] * 8)
        before = TILES["newtonian"]
        ring.accel(torch.tensor(xv[:, :3], dtype=torch.float32, device=dev))
        far = TILES["newtonian"] - before
        assert (far >= 32) if expect_far else (far == 0), far


@pytest.mark.cuda
def test_ring_method_tree_run_on_the_card(dev, tmp_path):
    """20 steps of run_simulation(method='tree') over ['cuda:0'] * 4 at an
    uneven N (3 ghost rows) against method='direct' on the card."""
    from nbody_streams_tpu_torch import Species, run_simulation

    n = 8193
    xv, m, _ = _ring_case(n, seed=3)
    sp = [Species.dark(N=n, mass=float(m[0]), softening=H)]
    kw = dict(time_start=0.0, time_end=20 * 2e-5, dt=2e-5,
              architecture="gpu", save_snapshots=False, verbose=False)
    before = cd.LAUNCHES["single"]
    tree = run_simulation(xv, sp, method="tree", devices=["cuda:0"] * 4,
                          output_dir=str(tmp_path / "t"), **kw)["dark"]
    assert cd.LAUNCHES["single"] - before == 21 * 16
    direct = run_simulation(xv, sp, method="direct",
                            output_dir=str(tmp_path / "d"), **kw)["dark"]
    assert tree.shape == (n, 6) and np.isfinite(tree).all()
    scale = np.abs(direct[:, :3]).max()
    assert np.abs(tree[:, :3] - direct[:, :3]).max() < 1e-5 * scale


@pytest.mark.cuda
def test_flagship_resumes_on_the_card(dev, tmp_path):
    """The flagship driver at N = 16,385 on the card: 2 steps, then a
    resumed 2 (the restart file carries the Kahan compensations and the
    friction's state), against an unbroken 4-step run within 1e-6 of max;
    the summary counts 4 steps over 2 attempts."""
    from nbody_streams_tpu_torch import nbody_io
    from nbody_streams_tpu_torch.benchmarks import flagship2m as fl

    n, steps = 16385, 4
    kw = dict(device=dev, save_snapshots=nbody_io.H5PY_AVAILABLE)
    before = dict(cd.LAUNCHES)
    whole = fl.run(n, steps, out=tmp_path / "whole", **kw)
    assert sum(cd.LAUNCHES.values()) > sum(before.values())
    fl.run(n, steps, out=tmp_path / "split", _stop_step=2, **kw)
    assert nbody_io._load_restart(tmp_path / "split")[2] == 2
    split = fl.run(n, steps, out=tmp_path / "split", **kw)
    assert list(split) == ["dark", "stars", "bh"]
    for name in whole:
        assert np.isfinite(split[name]).all()
        for sl in (slice(0, 3), slice(3, 6)):
            scale = np.abs(whole[name][:, sl]).max()
            assert (np.abs(split[name][:, sl] - whole[name][:, sl]).max()
                    <= 1e-6 * scale)
    total = fl.summary(tmp_path / "split")
    assert total["steps"] == steps and total["attempts"] == 2


@pytest.mark.cuda
def test_gate1m_on_the_card(dev, tmp_path):
    """northstar's gate1m at N = 16,384 for 4 steps on the card by
    default: |dE/E| < 1e-4 from its float64 bracket, through the sorted
    path's kernels, with the card's peak memory in its line."""
    from nbody_streams_tpu_torch.benchmarks import northstar as ns

    before = dict(cd.LAUNCHES)
    rec = ns.run_gate1m(n=16384, steps=4, out=tmp_path / "g")
    assert rec["value"] < 1e-4 and rec["steps"] == 4
    assert rec["device"] == torch.cuda.get_device_name(dev)
    assert rec["peak_hbm_gb"] > 0
    assert cd.LAUNCHES["base"] > before["base"]


# ---------------------------------------------------------------------------
# kernels M and F (csrc/moment.cu): the tensor-core forms
# ---------------------------------------------------------------------------

def _moment_operands(dev):
    """The bench case's sorted operands on the frame the moment forms take
    (centred on the centroid, as cuda_direct._self_sorted centres)."""
    tgt, src, start, nb = _bench_operands(dev)
    n = tgt.shape[1]
    mean = tgt[:3].mean(1, keepdim=True)
    tgt = tgt.clone()
    src = src.clone()
    tgt[:3] -= mean
    src[:3, :n] -= mean
    return tgt, src, start, nb


MOMENT_FORMS = {"fold": ("acc", True, False), "unfold": ("acc", False, False),
                "fast": ("acc", True, True), "fast_pot": ("pot", True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(MOMENT_FORMS))
def test_moment_base_pass_matches_plain(dev, form):
    """Kernel M (folded, unfolded) and F (acc, pot) as the base pass at the
    bench case, at the wrapper's S and at S = 1, against their plain
    versions: M within chip_smoke.MOMENT_TOL, F within
    chip_smoke.FAST_TOL (its cross term's order of products); the same
    bits on a repeated launch; one launch counted under its form."""
    mode, fold, fast = MOMENT_FORMS[form]
    tgt, src, start, nb = _moment_operands(dev)
    tol = chip_smoke.FAST_TOL[mode] if fast else chip_smoke.MOMENT_TOL
    splits = cd.split_count("direct", 65536, src.shape[1], _sms(dev), nb,
                            cd.TN)
    for s in (splits, 1):
        before = dict(cd.LAUNCHES)
        got = cd._moment_tile(tgt, src, "newtonian", mode, True, 1e-15,
                              fold, fast, nb=nb, start=start, splits=s)
        again = cd._moment_tile(tgt, src, "newtonian", mode, True, 1e-15,
                                fold, fast, nb=nb, start=start, splits=s)
        torch.cuda.synchronize()
        key = "fast" if fast else "moment"
        assert cd.LAUNCHES == dict(before, **{key: before[key] + 2})
        want = cd._moment_tile_reference(tgt, src, "newtonian", mode, True,
                                         1e-15, fold, fast, nb=nb,
                                         start=start, splits=s)
        assert torch.isfinite(got).all()
        assert _rel(got, want) < tol, (s, _rel(got, want))
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("gap", [0.5, None], ids=["near", "far"])
def test_moment_two_set_matches_plain(dev, gap):
    """Kernel M's two-set form (the ring's far tiles: the Newtonian law on
    disjoint blocks) at a ragged shape against its plain version at the
    same S: chip_smoke.MOMENT_TOL with Kahan and 1e-5 without.  "near" is
    the closest block the ring's far test lets through: its x-interval
    ``gap`` = 0.5 beyond the targets', more than the widest softening
    (0.3); "far" is shifted by 6 on every axis.  (Blocks that interleave,
    which the far test keeps on the VPU form, cancel as |x| / |dx| in the
    finalisation: 1.4e-5 kernel vs plain at a shift of 2, PERF.md.)"""
    rng = np.random.default_rng(3)
    nt = 3000
    pos_t = torch.tensor(rng.normal(0, 1, (nt, 3)), dtype=torch.float32,
                         device=dev)
    h_t = torch.tensor(rng.uniform(0.05, 0.3, nt), dtype=torch.float32,
                       device=dev)
    gm_t = torch.tensor(rng.uniform(0.5, 2.0, nt) * 0.43,
                        dtype=torch.float32, device=dev)
    if gap is None:
        pos_s = pos_t[:2000] + 6.0
    else:
        pos_s = pos_t[:2000].clone()
        pos_s[:, 0] += pos_t[:, 0].max() - pos_s[:, 0].min() + gap
    pre = cd._soft_pre("newtonian", h_t)
    tgt = cd._targets(pos_t, pre)
    src = cd._sources(pos_s, gm_t[:2000], pre[:2000], cd.BLOCK)
    splits = cd.split_count("direct", nt, src.shape[1], _sms(dev))
    for kahan, tol in ((True, chip_smoke.MOMENT_TOL), (False, 1e-5)):
        before = cd.LAUNCHES["moment_2set"]
        got = cd._moment_tile(tgt, src, "newtonian", "acc", kahan, 1e-15)
        torch.cuda.synchronize()
        assert cd.LAUNCHES["moment_2set"] == before + 1
        want = cd._moment_tile_reference(tgt, src, "newtonian", "acc",
                                         kahan, 1e-15, splits=splits)
        assert torch.isfinite(got).all()
        assert _rel(got, want) < tol, (kahan, _rel(got, want))


@pytest.mark.cuda
def test_moment_forms_match_fp64(dev):
    """The sorted path with kernel M (folded and not) and the VPU form
    against the fp64 oracle at N = 16,384: 3e-6 (the JAX package's
    tolerance); kernel F within its tier's bound (1e-4)."""
    xv, m = make_plummer_sphere(16384, M_total=1e9, a=1.0, seed=4)
    p = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    mt = torch.tensor(m, dtype=torch.float32, device=dev)
    ht = torch.full((16384,), H, dtype=torch.float32, device=dev)
    want = compute_forces_direct(p.double(), mt.double(), ht.double(), G=G,
                                 precision="float64")
    for kw, tol in ((dict(tile={"mxu": True}), 3e-6),
                    (dict(tile={"mxu": True, "fold_mass": False}), 3e-6),
                    (dict(fast=True), 1e-4)):
        got = cd.cuda_accel(p, mt, ht, G, "spline", True, **kw)
        assert _rel(got, want) < tol, (kw, _rel(got, want))


@pytest.mark.cuda
def test_solver_options_take_the_moment_kernels(dev):
    """DirectGravity on the card: tile_config {'mxu': True} launches
    kernel M (unfolded with target_drift=1e-8), float32_fast kernel F
    (acc and pot), the default and target_drift=1e-8 alone neither; the
    band pass runs in every case."""
    xv, m = make_plummer_sphere(65536, M_total=1e9, a=1.0, seed=2)
    pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    cases = {"default": ({}, {"base": 2}),
             "mxu": (dict(tile_config={"mxu": True}),
                     {"moment": 1, "base": 1}),
             "drift": (dict(target_drift=1e-8), {"base": 2}),
             "drift_mxu": (dict(target_drift=1e-8,
                                tile_config={"mxu": True}),
                           {"moment": 1, "base": 1}),
             "fast": (dict(precision="float32_fast"), {"fast": 2})}
    for name, (kw, want) in cases.items():
        solver = DirectGravity(m, H, G=G, impl="cuda", device=dev, **kw)
        before = dict(cd.LAUNCHES)
        solver.accel(pos)
        solver.potential(pos)
        torch.cuda.synchronize()
        got = {k: cd.LAUNCHES[k] - before[k] for k in cd.LAUNCHES}
        assert got == {k: want.get(k, 0) + (2 if k == "band" else 0)
                       for k in cd.LAUNCHES}, (name, got)


@pytest.mark.cuda
def test_ring_mxu_on_virtual_shards_matches_one_card(dev):
    """ShardedDirect(mxu=True) over ['cuda:0'] * 4 on the slab-sorted case
    at (120, -80, 40): its far tiles through kernel M's two-set form,
    within 2e-6 * max of the one-card sorted path."""
    xv, m, h = _ring_case(65_536)
    xv = xv + np.array([120.0, -80.0, 40.0, 0.0, 0.0, 0.0])
    ring = DirectGravity(m, h, G=G, impl="sharded", devices=["cuda:0"] * 4,
                         sharded_opts={"mxu": True})
    one = DirectGravity(m, h, G=G, impl="cuda", device=dev)
    pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    before = cd.LAUNCHES["moment_2set"]
    got = ring.accel(pos)
    torch.cuda.synchronize()
    assert cd.LAUNCHES["moment_2set"] - before >= 4
    assert _rel(got, one.accel(pos)) < 2e-6


WINDOW = "test.window"


def _traced_plummer(dev, tmp_path, tag, steps=100, annotate=False):
    """A 65,536-body Plummer run (the ``plummer_iso.n65k`` cell's shape)
    of ``steps`` steps under the profiler with CUDA activity, inside a
    ``WINDOW`` span, the program's spans in the profiler's trace too with
    ``annotate``; returns (the profile, the program's spans)."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from nbody_streams_tpu_torch import Species, run_simulation, telemetry

    n, dt = 65536, 2e-5
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=8)
    sp = [Species.dark(N=n, mass=float(m[0]), softening=0.05)]
    telemetry.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, (
            telemetry.annotating() if annotate
            else contextlib.nullcontext()):
        with record_function(WINDOW):
            run_simulation(xv, sp, 0.0, steps * dt, dt, architecture="gpu",
                           restart_interval=steps - 1, save_snapshots=False,
                           output_dir=str(tmp_path / tag), verbose=False)
            torch.cuda.synchronize()
    return prof, telemetry.spans()


def _idle_gaps(prof):
    """The device's idle gaps ((start, end) ns) inside the ``WINDOW``
    span: the window less the union of its kernels, copies and fills (the
    profiler's annotation ranges on the device left out)."""
    events = prof.profiler.kineto_results.events()
    w0, w1 = next((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events if e.name() == WINDOW
                  and str(e.device_type()).endswith("CPU"))
    def kind(e):
        kind = getattr(e, "activity_type", None)
        return str(kind()).lower() if callable(kind) else ""

    busy = sorted(
        (max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1))
        for e in events if str(e.device_type()).endswith("CUDA")
        and "annotation" not in kind(e))
    busy = [(a, b) for a, b in busy if b > a]
    gaps, end = [], w0
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


@pytest.mark.cuda
def test_spans_follow_the_profiler_with_cuda_activity(dev, tmp_path):
    """The stored spans against the profiler's own events for them, CUDA
    activity on: 95% within 50 us, the median within 10 us
    (tests/test_torch_telemetry.py on the CPU)."""
    _traced_plummer(dev, tmp_path, "warm", steps=21, annotate=True)
    prof, spans = _traced_plummer(dev, tmp_path, "run", steps=21,
                                  annotate=True)
    names = {s[0] for s in spans}
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() in names
                     and str(e.device_type()).endswith("CPU")),
                    key=lambda e: e.start_ns())
    assert [e.name() for e in events] == [s[0] for s in spans]
    late = np.asarray([(s[1] - e.start_ns(),
                        s[2] - e.start_ns() - e.duration_ns())
                       for s, e in zip(spans, events)])
    assert np.mean(np.abs(late) < 50_000, 0).min() >= 0.95, late
    assert np.median(np.abs(late), 0).max() < 10_000, late


@pytest.mark.cuda
def test_spans_cover_the_idle_time_of_a_traced_run(dev, tmp_path):
    """At least 90% of the device's idle time in a traced 65,536-body run
    falls under some span of the program, which stays out of the
    profiler's events (the device's included) outside ``annotating()``."""
    _traced_plummer(dev, tmp_path, "warm", steps=21)
    prof, spans = _traced_plummer(dev, tmp_path, "run")
    names = {s[0] for s in spans}
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name() in names]
    gaps = _idle_gaps(prof)
    total = sum(b - a for a, b in gaps)
    # the outermost spans follow one another: their overlaps with the gaps
    # add up to the idle time under some span
    under = sum(max(0, min(b, s[2]) - max(a, s[1]))
                for s in spans if s[3] < 0 for a, b in gaps)
    assert total > 0
    assert under >= 0.9 * total, (under, total)
