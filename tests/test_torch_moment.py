"""The port's tensor-core forms of the direct kernels (kernels M and F of
``csrc/moment.cu``) against the JAX package's matrix-unit forms, on the CPU.

The counterpart of tests/test_pallas.py:224-461.  On CPU tensors the
wrappers run the kernels' plain versions (``_moment_tile_reference``); the
JAX side runs its Pallas kernels in interpret mode.  Inputs are made with
numpy from a seed and handed to both.  The sorted path runs at n <= 4,096
with tm = 64, tn = 128 (the JAX side's max_sub = 8), so that the base pass
covers most source rows (rows >> band).

Tolerances, each against max |reference|:
- the moment form vs the JAX moment form, the fp64 sum and the VPU form:
  3e-6, the JAX package's tolerance.  The moment form itself is the
  largest term: at the n = 4,096 geometry below it is 2.5e-6 from fp64,
  where the VPU form is 8e-7 (the finalisation P[:3] - x_t P[3] cancels
  as |x_t| / |dx| for the pairs just outside the band);
- the fast tier: the JAX test's guarantees (finite; per target max < 0.5,
  median < 5e-3 for acc and < 1e-3 for pot), and the port's fast tier
  within FAST_TOL of the JAX fast tier (measured 2.5e-5 per target and
  5.7e-6 of scale for acc, 3.0e-7 for pot: the expanded r^2's rounding
  differs with the order of its cross term's products);
- the end-to-end run: 1e-6 * max |x| and |v|, as tests/test_torch_sim.py.
"""
import functools
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nbody_streams_tpu as jst
import nbody_streams_tpu_torch as tst
from nbody_streams_tpu.ops import pallas_direct as jpd
from nbody_streams_tpu.ops.dispatch import DirectGravity as JDirect
from nbody_streams_tpu_torch.ops import cuda_direct as cd
from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
from nbody_streams_tpu_torch.ops.pairwise import (
    compute_forces_direct,
    compute_potential_direct,
)
from nbody_streams_tpu_torch.species import PerformanceWarning

torch.set_num_threads(2)

G = 4.3e-6
TOL = 3e-6
#: the port's fast tier vs the JAX fast tier: (per target, of scale)
FAST_TOL = {"acc": (1e-4, 2e-5), "pot": (2e-6, 1e-6)}
TILE = dict(tm=64, tn=128)
JAX_TILE = dict(interpret=True, tm=64, tn=128, max_sub=8)


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / np.abs(want).max()


def _port_sorted(pos, gm, soft, mode, **kw):
    return cd._self_sorted(torch.tensor(pos), torch.tensor(gm),
                           torch.tensor(soft), "spline", True, mode, 1e-15,
                           **TILE, **kw).double().numpy()


def _jax_sorted(pos, gm, soft, mode, **kw):
    return np.asarray(jpd._pallas_self_sorted(
        jnp.asarray(pos), jnp.asarray(gm), jnp.asarray(soft), "spline", True,
        mode, 1e-15, **JAX_TILE, **kw), np.float64)


def _gauss(seed, n=4096, center=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(0, 1.0, (n, 3)) + np.asarray(center)).astype(np.float32)
    gm = (rng.uniform(0.5, 1.5, n) * G).astype(np.float32)
    return pos, gm, np.full(n, 0.05, np.float32)


@pytest.fixture
def moment_calls(monkeypatch):
    """The calls of ``_moment_tile`` by (mode, fold, fast, nb > 0): the CPU
    path launches nothing, so the route is read from the wrapper's
    arguments."""
    calls = []
    real = cd._moment_tile

    def spy(tgt, src, kind, mode, kahan, eps2, fold=True, fast=False,
            nb=0, **kw):
        calls.append((mode, fold, fast, nb > 0))
        return real(tgt, src, kind, mode, kahan, eps2, fold, fast, nb, **kw)

    monkeypatch.setattr(cd, "_moment_tile", spy)
    return calls


# ---------------------------------------------------------------------------
# kernel M: the moment base pass, its potential and its two-set form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("center", [(0.0, 0.0, 0.0), (120.0, -80.0, 40.0)],
                         ids=["centred", "offset"])
def test_moment_base_pass_matches_jax(center, moment_calls):
    """The moment base pass against the JAX moment form and the VPU form.
    The offset case holds the centring: uncentred, the finalisation at
    |x| ~ 150 costs ~2 digits (pallas_direct.py:685-695)."""
    pos, gm, soft = _gauss(11, center=center)
    got = _port_sorted(pos, gm, soft, "acc", mxu=True)
    assert moment_calls == [("acc", True, False, True)]
    vpu = _port_sorted(pos, gm, soft, "acc")
    assert not np.array_equal(got, vpu)      # the moment form ran
    assert _rel(got, vpu) < TOL
    assert _rel(got, _jax_sorted(pos, gm, soft, "acc", mxu=True)) < TOL
    ref = compute_forces_direct(
        torch.tensor(pos, dtype=torch.float64),
        torch.tensor(gm, dtype=torch.float64),
        torch.tensor(soft, dtype=torch.float64), G=1.0, precision="float64")
    assert _rel(got, ref) < TOL


def test_moment_potential_row_sum_matches(moment_calls):
    """mxu=True in potential mode is the row sum the VPU form already is
    (routed there, bitwise), within 3e-6 of the JAX moment row sum and of
    the fp64 oracle (self pair excluded)."""
    pos, gm, soft = _gauss(17)
    got = _port_sorted(pos, gm, soft, "pot", mxu=True)
    assert moment_calls == []
    np.testing.assert_array_equal(got, _port_sorted(pos, gm, soft, "pot"))
    assert _rel(got, _jax_sorted(pos, gm, soft, "pot", mxu=True)) < TOL
    orc = compute_potential_direct(
        torch.tensor(pos, dtype=torch.float64),
        torch.tensor(gm, dtype=torch.float64),
        torch.tensor(soft, dtype=torch.float64), G=1.0, precision="float64")
    assert _rel(got, orc) < TOL


def _two_set(offset):
    """300 Newtonian targets about the origin and 500 sources about
    (offset, offset, offset), h = 0.05: (pos_t, h_t, pos_s, gm_s, h_s)."""
    rng = np.random.default_rng(23)
    nt, ns = 300, 500
    pos_t = rng.normal(0, 1.0, (nt, 3)).astype(np.float32)
    pos_s = (rng.normal(0, 1.0, (ns, 3)) + offset).astype(np.float32)
    gm_s = (rng.uniform(0.5, 1.5, ns) * G).astype(np.float32)
    return (pos_t, np.full(nt, 0.05, np.float32), pos_s, gm_s,
            np.full(ns, 0.05, np.float32))


@pytest.mark.parametrize("offset", [3.0, 8.0], ids=["near", "far"])
def test_moment_2set_matches_jax(offset):
    """cuda_accel_2set(mxu=True), the ring's far-tile form, on disjoint
    blocks (the near blocks overlap at their edges: the finalisation
    cancels more there) against the JAX moment form and the VPU form:
    3e-6."""
    args = [torch.tensor(a) for a in _two_set(offset)]
    got = cd.cuda_accel_2set(*args, "newtonian", True,
                             mxu=True).double().numpy()
    vpu = cd.cuda_accel_2set(*args, "newtonian", True).double().numpy()
    want = np.asarray(jpd.pallas_accel_2set(
        *map(jnp.asarray, _two_set(offset)), "newtonian", True,
        interpret=True, mxu=True), np.float64)
    assert not np.array_equal(got, vpu)
    assert _rel(got, vpu) < TOL
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("form", ["spline", "pot", "fast"])
def test_moment_2set_rejects_other_forms(form):
    """The two-set moment form is built for its one caller, the ring's far
    tiles: the folded Newtonian acceleration.  Another law, the potential
    and the fast tier raise (the JAX package's form takes any law; the
    port keeps the others on the VPU forms)."""
    pos_t, h_t, pos_s, gm_s, h_s = map(torch.tensor, _two_set(8.0))
    tgt = cd._targets(pos_t, h_t)
    src = cd._sources(pos_s, gm_s, h_s, cd.BLOCK)
    with pytest.raises(ValueError, match="moment form"):
        if form == "spline":
            cd.cuda_accel_2set(pos_t, h_t, pos_s, gm_s, h_s, "spline", True,
                               mxu=True)
        else:
            mode = "pot" if form == "pot" else "acc"
            cd._moment_tile(tgt, src, "newtonian", mode, True, 1e-15,
                            fast=form == "fast")


@pytest.mark.parametrize("mode", ["acc", "pot"])
def test_fold_mass_unfold_matches(mode, moment_calls):
    """fold_mass=False (the target_drift tier) keeps G m in the pair factor;
    it agrees with the folded form to fp32 round-off and, for acc, sums
    other roundings (pot is folded in both: the same sum), and matches the
    JAX unfolded form."""
    pos, gm, soft = _gauss(29)
    folded = _port_sorted(pos, gm, soft, mode, mxu=True)
    unfolded = _port_sorted(pos, gm, soft, mode, mxu=True, fold_mass=False)
    if mode == "acc":
        assert moment_calls == [("acc", True, False, True),
                                ("acc", False, False, True)]
        assert not np.array_equal(folded, unfolded)
        want = _jax_sorted(pos, gm, soft, mode, mxu=True, fold_mass=False)
        assert _rel(unfolded, want) < TOL
    else:
        assert moment_calls == []
        np.testing.assert_array_equal(folded, unfolded)
    assert _rel(unfolded, folded) < TOL


def test_target_drift_selects_unfolded_moments():
    """DirectGravity(target_drift=): below 1e-7 on impl='cuda' the moment
    form, where one is asked for, is the unfolded one (fold_mass off, as
    the JAX package sets it); the form itself stays the default's (the
    VPU form: kernel M loses to it on the card, PERF.md), and mxu=True
    with it takes M unfolded; looser targets change nothing; an explicit
    choice wins; geometry merges; non-positive raises."""
    n = 16384
    m, soft = np.full(n, 1e5), np.full(n, 0.05)

    def mk(**kw):
        return DirectGravity(m, soft, kernel="spline", impl="cuda",
                             device="cpu", **kw)

    assert mk(target_drift=1e-8).tile_config == {"fold_mass": False}
    assert "mxu" not in mk(target_drift=1e-8)._tile
    assert mk(target_drift=1e-5).tile_config is None
    explicit = mk(target_drift=1e-8, tile_config={"fold_mass": True})
    assert explicit.tile_config == {"fold_mass": True}
    on = mk(target_drift=1e-8, tile_config={"mxu": True})
    assert on.tile_config == {"mxu": True, "fold_mass": False}
    off = mk(target_drift=1e-8, tile_config={"mxu": False})
    assert off.tile_config == {"mxu": False, "fold_mass": False}
    merged = mk(target_drift=1e-8, tile_config={"tm": 256})
    assert merged.tile_config == {"tm": 256, "fold_mass": False}
    assert merged._tile == {"tm": 256, "fold_mass": False}
    # the torch oracle and the fast tier keep their own sums
    assert DirectGravity(m, soft, impl="torch", device="cpu",
                         target_drift=1e-8).tile_config is None
    fast = mk(target_drift=1e-8, precision="float32_fast",
              tile_config={"tn": 128})
    assert fast.tile_config == {"tn": 128}
    with pytest.raises(ValueError, match="target_drift"):
        mk(target_drift=0.0)
    with pytest.raises(ValueError, match="tile_config"):
        mk(tile_config={"fold": False})
    jax_tight = JDirect(m, soft, kernel="spline", impl="pallas",
                        target_drift=1e-8)
    assert jax_tight.tile_config == {"fold_mass": False}
    assert mk(target_drift=1e-8).tile_config == jax_tight.tile_config


def test_solver_routes_mxu_and_target_drift(moment_calls, monkeypatch):
    """DirectGravity takes kernel M for tile_config {'mxu': True} on the
    sorted path, acc only, and unfolded with target_drift; the default,
    target_drift alone among them, takes the VPU form."""
    monkeypatch.setattr(cd, "SORT_MIN_N", 2048)
    pos, gm, soft = _gauss(5)
    p = torch.tensor(pos)

    def solver(**kw):
        return DirectGravity(gm / G, soft, G=G, impl="cuda", device="cpu",
                             **kw)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        default = solver(tile_config=TILE)
        default.accel(p)
        assert moment_calls == []
        mxu = solver(tile_config={**TILE, "mxu": True})
        got = mxu.accel(p)
        mxu.potential(p)
        drift = solver(tile_config=TILE, target_drift=1e-8)
        drift.accel(p)
        assert len(moment_calls) == 1
        drift_mxu = solver(tile_config={**TILE, "mxu": True},
                           target_drift=1e-8)
        drift_mxu.accel(p)
    assert moment_calls == [("acc", True, False, True),
                            ("acc", False, False, True)]
    want = _jax_sorted(pos, gm, soft, "acc", mxu=True)
    assert _rel(got.double().numpy(), want) < TOL


# ---------------------------------------------------------------------------
# kernel F: the float32_fast tier
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clustered():
    """test_pallas.py::test_fast_tier_bounded_and_finite's data at 4,096:
    a core with heavy-tailed outliers out to 300 length units."""
    rng = np.random.default_rng(31)
    n = 4096
    r = 1.0 / np.sqrt(rng.uniform(1e-5, 1.0, n))
    u = rng.normal(size=(n, 3))
    pos = (u / np.linalg.norm(u, axis=1, keepdims=True)
           * np.minimum(r, 300.0)[:, None]).astype(np.float32)
    gm = (rng.uniform(0.5, 1.5, n) * G).astype(np.float32)
    return pos, gm, np.full(n, 0.05, np.float32)


def _fast_err(mode, fast, ref):
    if mode == "acc":
        den = np.linalg.norm(ref, axis=1)
        return (np.linalg.norm(fast - ref, axis=1)
                / np.maximum(den, den.mean() * 1e-3))
    return np.abs(fast - ref) / np.abs(ref).mean()


@pytest.mark.parametrize("mode, med_tol", [("acc", 5e-3), ("pot", 1e-3)])
def test_fast_tier_bounded_and_finite(clustered, mode, med_tol,
                                      moment_calls):
    """Kernel F's guarantees: finite, no blowup from the far outliers (the
    r^2 >= dx_x^2 + eps2 clamp), bounded typical error; and within
    FAST_TOL of the JAX fast tier."""
    pos, gm, soft = clustered
    ref = _port_sorted(pos, gm, soft, mode)
    fast = _port_sorted(pos, gm, soft, mode, fast=True)
    assert moment_calls == [(mode, True, True, True)]
    assert np.isfinite(fast).all()
    err = _fast_err(mode, fast, ref)
    assert err.max() < 0.5, err.max()
    assert np.median(err) < med_tol, np.median(err)
    want = _jax_sorted(pos, gm, soft, mode, fast=True)
    per_target, of_scale = FAST_TOL[mode]
    assert _fast_err(mode, fast, want).max() < per_target
    assert _rel(fast, want) < of_scale


def test_fast_tier_rejects_mxu_false_tile():
    """float32_fast builds r^2 on the moment path: tile mxu=False fails at
    construction, and at the sorted path's entry."""
    n = 16384
    m, soft = np.full(n, 1e5), np.full(n, 0.05)
    with pytest.raises(ValueError, match="mxu"):
        DirectGravity(m, soft, kernel="spline", precision="float32_fast",
                      impl="cuda", device="cpu", tile_config={"mxu": False})
    pos, gm, h = _gauss(3, n=1024)
    with pytest.raises(ValueError, match="mxu=False"):
        _port_sorted(pos, gm, h, "acc", fast=True, mxu=False)


def test_fast_tier_warns_only_off_the_sorted_path():
    """On the sorted spline path float32_fast is kernel F, with no warning;
    off it (another law, a small N, the torch oracle) it runs as plain
    float32 and says so, as the JAX package does."""
    big = (np.full(16384, 1e5), np.full(16384, 0.05))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        solver = DirectGravity(*big, precision="float32_fast", impl="cuda",
                               device="cpu")
    assert solver.fast and not solver.kahan
    for kw in (dict(kernel="plummer", impl="cuda"), dict(impl="torch")):
        with pytest.warns(PerformanceWarning, match="runs as plain"):
            DirectGravity(*big, precision="float32_fast", device="cpu", **kw)
    with pytest.warns(PerformanceWarning, match="N=512"):
        DirectGravity(np.full(512, 1.0), 0.05, precision="float32_fast",
                      impl="cuda", device="cpu")


# ---------------------------------------------------------------------------
# the ring's far tiles
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slab():
    """1,024 particles at (120, -80, 40), h = 0.01, slab-sorted: on 8
    shards every non-adjacent ring block is far."""
    from nbody_streams_tpu_torch.parallel import sharded as tsh

    rng = np.random.default_rng(41)
    n = 1024
    pos = rng.normal(0, 1, (n, 3)) + np.array([120.0, -80.0, 40.0])
    return tsh.slab_sort_for_sharding(pos, rng.uniform(0.5, 2.0, n) * 1e5,
                                      np.full(n, 0.01))


@pytest.mark.parametrize("mode", ["accel", "potential"])
def test_ring_mxu_matches_jax_ring(slab, mode, moment_calls):
    """ShardedDirect(mxu=True) over 8 CPU shards on the kernel route (the
    kernels' plain versions) against the JAX ring with use_pallas=True,
    interpret=True, mxu=True on the 8-device CPU mesh: the far blocks in
    the moment form on a frame centred on the real centroid; the
    potential's tiles the row sum."""
    pos, mass, soft = slab
    port = DirectGravity(mass, soft, G=G, impl="sharded", devices=["cpu"] * 8,
                         sharded_opts={"use_kernels": True, "mxu": True})
    assert port._sharded.mxu
    got = getattr(port, mode)(torch.tensor(pos, dtype=torch.float32))
    jx = JDirect(mass, soft, G=G, impl="sharded", devices=jax.devices(),
                 sharded_opts=dict(use_pallas=True, interpret=True,
                                   mxu=True))
    want = np.asarray(getattr(jx, mode)(jnp.asarray(pos, jnp.float32)),
                      float)
    if mode == "accel":
        far = [c for c in moment_calls if not c[3]]
        assert len(far) >= 64 // 2 and len(far) == len(moment_calls)
    else:
        assert moment_calls == []
    assert _rel(got.double().numpy(), want) < 2e-6


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

def test_run_simulation_float32_fast_matches_jax(tmp_path, monkeypatch,
                                                 moment_calls):
    """run_simulation(precision='float32_fast') at N = 16,384 (the sorted
    path's threshold) for 1 KDK step against the JAX run of the same tier
    (its Pallas kernels in interpret mode): kernel F on every force, no
    warning, within 1e-6 of max |x| and |v| (test_torch_sim.py's
    tolerance)."""
    monkeypatch.setattr(jpd, "pallas_accel",
                        functools.partial(jpd.pallas_accel, interpret=True))
    monkeypatch.setattr(jpd, "pallas_potential",
                        functools.partial(jpd.pallas_potential,
                                          interpret=True))
    n, dt, steps = 16384, 2e-5, 1
    xv, m = tst.make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    species = [tst.Species.dark(N=n, mass=float(m[0]), softening=0.05)]
    jsp = [jst.Species(s.name, s.N, s.mass, s.softening) for s in species]
    want = jst.run_simulation(
        xv, jsp, 0.0, steps * dt, dt, architecture="cpu", impl="pallas",
        output_dir=str(tmp_path / "jax"), verbose=False, snapshots=1,
        precision="float32_fast")["dark"]
    with warnings.catch_warnings():
        warnings.simplefilter("error", PerformanceWarning)
        got = tst.run_simulation(
            xv, species, 0.0, steps * dt, dt, architecture="cpu",
            impl="cuda", output_dir=str(tmp_path / "port"), verbose=False,
            snapshots=1, precision="float32_fast")["dark"]
    assert moment_calls and all(c[1:] == (True, True, True)
                                for c in moment_calls)
    assert got.shape == (n, 6) and np.isfinite(got).all()
    for sl in (slice(0, 3), slice(3, 6)):
        scale = np.abs(want[:, sl]).max()
        assert np.abs(got[:, sl] - want[:, sl]).max() < 1e-6 * scale


# ---------------------------------------------------------------------------
# the TF32 trap, at the source
# ---------------------------------------------------------------------------

def test_every_mma_goes_through_3xtf32():
    """A single TF32 pass keeps ~3 decimal digits (the Hopper form of the
    TPU's bf16 trap, test_pallas.py::test_mxu_contractions_pin_operand_
    precision), invisible to any CPU test.  So in csrc/ the mma
    instruction is issued in one place, mma_tf32_1pass, which only the two
    3xTF32 forms call, twice each, so that the hi.hi, hi.lo and lo.hi
    products all reach the fragment: mma_3xtf32_cols (A split, against
    B's hi and lo halves in its columns 0-3 and 4-7) and mma_3xtf32_k4 (B
    split, against A's hi and lo halves in the contraction's two halves).
    Every operand the moment tile hands them is split hi/lo: the pair
    factors, the moment columns, F's source and target coordinates."""
    csrc = Path(cd.__file__).resolve().parent.parent / "csrc"
    sources = {p.name: p.read_text() for p in sorted(csrc.glob("*.cu*"))}
    issue = {n: len(re.findall(r'"mma\.sync\b', s))
             for n, s in sources.items()}
    assert issue == {**{n: 0 for n in sources}, "direct_math.cuh": 1}
    math = sources["direct_math.cuh"]

    def body(head):
        text = math[math.index(head):]
        return text[:text.index("\n}\n")]

    pairs = r"mma_tf32_1pass\(d, (\w+), (\w+)\)"
    cols = body("void mma_3xtf32_cols(")
    assert re.findall(pairs, cols) == [("a_lo", "b"), ("a_hi", "b")]
    k4 = body("void mma_3xtf32_k4(")
    assert re.findall(pairs, k4) == [("a", "lo"), ("a", "hi")]
    assert "lo[2] = {b.z, b.w}, hi[2] = {b.x, b.y}" in k4
    calls = sum(len(re.findall(r"\bmma_tf32_1pass\(", s))
                for s in sources.values())
    assert calls == 1 + 2 + 2      # its definition and the forms' calls
    # the split rounds hi to TF32 and keeps lo = a - hi exactly
    split = body("void split_tf32(")
    assert "+ 0x1000u) & 0xffffe000u" in split
    assert "a - __uint_as_float(hi)" in split
    # the moment tile's products, each on split operands
    moment = sources["moment_math.cuh"]
    forms = ("mma_3xtf32_cols", "mma_3xtf32_k4")
    assert {n: len(re.findall(rf"\b{n}\(", moment)) for n in forms} == {
        n: 1 for n in forms}
    for n in forms:   # defined in direct_math.cuh, called in the tile alone
        users = [f for f, s in sources.items() if re.search(rf"\b{n}\(", s)]
        assert users == ["direct_math.cuh", "moment_math.cuh"]
    assert re.search(r"mma_3xtf32_cols\(acc, a_hi, a_lo, b\)", moment)
    assert re.search(r"split_tf32\(factor<MODE, FOLD>\([^;]*a_hi\[e\], "
                     r"a_lo\[e\]\)", moment)
    assert "split_tf32(m[c], s.bm[c][k], s.bm[c + 4][k])" in moment
    # F's source coordinates: the k4 form's b = {hi, hi, lo, 0}
    assert "split_tf32(xyz[c], hi, lo);" in moment
    assert "s.cc[c][k] = make_uint4(hi, hi, lo, 0u);" in moment
    assert "split_tf32(coord(a, t), q.x[0], q.x[2])" in moment
    assert "split_tf32(coord(b, t), q.x[1], q.x[3])" in moment
