"""The CUDA path's host side and the plain versions of its kernels against
the JAX package's Pallas path, run in interpret mode on the CPU.

On the CPU each kernel wrapper runs its plain torch version
(``_direct_tile_reference``, ``_band_reference``); tests/test_torch_cuda.py
holds the kernels themselves against those versions on a card.  Inputs are
made with numpy from a seed and cast explicitly to float32 on both sides.
Tolerances: 1e-6 * max between the port and the JAX package (fp32 sums in
another order); 5e-6 * max between orders of the sorted path (a permuted
order reorders the fp32 sums over all sources).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_streams_tpu.ops import pallas_direct as jpd
from nbody_streams_tpu.ops.pairwise import (
    compute_forces_direct as j_forces,
    compute_potential_direct as j_potential,
)
from nbody_streams_tpu_torch.ops import cuda_direct as cd
from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
from nbody_streams_tpu_torch.species import PerformanceWarning

torch.set_num_threads(2)

KINDS = ["newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline"]
TOL = 1e-6
G = 4.3e-6


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.fixture(scope="module")
def cluster():
    """N = 700: ragged in both the target and the source dimension."""
    rng = np.random.default_rng(5)
    n = 700
    pos = rng.normal(0, 1, (n, 3)).astype(np.float32)
    gm = (rng.uniform(0.5, 2.0, n) * 1e5 * G).astype(np.float32)
    soft = rng.uniform(0.05, 0.3, n).astype(np.float32)
    return pos, gm, soft


@pytest.fixture(scope="module")
def sorted_case():
    """N = 3,072, h = 0.02: with tm=64, tn=128 the band (12 rows) is a
    strict subset of the 24 source rows and the two-pass branch runs."""
    rng = np.random.default_rng(11)
    n = 3072
    pos = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    gm = (rng.uniform(0.5, 1.5, n) * G).astype(np.float32)
    return pos, gm, np.full(n, 0.02, np.float32)


SORT_KW = dict(tm=64, tn=128)


@pytest.fixture(scope="module")
def jax_sorted_acc(sorted_case):
    pos, gm, soft = sorted_case
    return np.asarray(jpd._pallas_self_sorted(
        _j(pos), _j(gm), _j(soft), "spline", True, "acc", 1e-15,
        interpret=True, max_sub=8, **SORT_KW), np.float64)


# ---------------------------------------------------------------------------
# plain versions of the kernels vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["acc", "pot"])
def test_direct_tile_reference_matches_pallas(cluster, kind, mode):
    pos, gm, soft = cluster
    mask = mode == "pot"
    want = jpd._pallas_direct(_j(pos), _j(soft), _j(pos), _j(gm), _j(soft),
                              kind, True, mode, 1e-15, interpret=True,
                              mask_self=mask)
    got = cd._direct(_t(pos), _t(soft), _t(pos), _t(gm), _t(soft), kind,
                     True, mode, 1e-15, mask_self=mask)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("mode", ["acc", "pot"])
def test_direct_tile_reference_without_kahan(cluster, mode):
    pos, gm, soft = cluster
    mask = mode == "pot"
    want = jpd._pallas_direct(_j(pos), _j(soft), _j(pos), _j(gm), _j(soft),
                              "spline", False, mode, 1e-15, interpret=True,
                              mask_self=mask)
    got = cd._direct(_t(pos), _t(soft), _t(pos), _t(gm), _t(soft), "spline",
                     False, mode, 1e-15, mask_self=mask)
    assert _rel(got, want) < TOL


def _band_setup(cluster):
    pos, gm, soft = cluster
    tm = tn = 128
    nb = 2
    rows = -(-pos.shape[0] // tn)
    start = np.random.default_rng(8).integers(
        0, rows - nb + 1, -(-pos.shape[0] // tm)).astype(np.int32)
    return pos, gm, soft, tm, tn, nb, start


@pytest.mark.parametrize("mode", ["acc", "pot"])
def test_skip_band_reference_matches_pallas(cluster, mode):
    """The Newtonian base pass with each tile's band rows left out."""
    pos, gm, soft, tm, tn, nb, start = _band_setup(cluster)
    mask = mode == "pot"
    want = jpd._pallas_direct(_j(pos), _j(soft), _j(pos), _j(gm), _j(soft),
                              "newtonian", True, mode, 1e-15, tm=tm, tn=tn,
                              max_sub=2, interpret=True, mask_self=mask,
                              skip_band=nb, band_start=jnp.asarray(start))
    got = cd._direct(_t(pos), _t(soft), _t(pos), _t(gm), _t(soft),
                     "newtonian", True, mode, 1e-15, tm=tm, tn=tn,
                     mask_self=mask, skip_band=nb,
                     band_start=torch.tensor(start))
    full = cd._direct(_t(pos), _t(soft), _t(pos), _t(gm), _t(soft),
                      "newtonian", True, mode, 1e-15, tm=tm, tn=tn,
                      mask_self=mask)
    assert _rel(got, want) < TOL
    assert _rel(got, full) > 1e-3      # the band rows really were left out


@pytest.mark.parametrize("mode", ["acc", "pot"])
@pytest.mark.parametrize("kahan", [True, False])
def test_band_reference_matches_pallas(cluster, mode, kahan):
    pos, gm, soft, tm, tn, nb, start = _band_setup(cluster)
    mask = mode == "pot"
    hinv = np.where(soft > 0, 1.0 / soft, np.inf).astype(np.float32)
    want = jpd._pallas_band_correction(
        _j(pos), _j(gm), _j(hinv), jnp.asarray(start), mode, 1e-15, tm, tn,
        nb, interpret=True, mask_self=mask, kahan=kahan)
    tgt = cd._targets(_t(pos), _t(hinv))
    src = cd._sources(_t(pos), _t(gm), _t(hinv), tn)
    got = cd._band(tgt, src, torch.tensor(start), mode, kahan, 1e-15, mask,
                   tm, tn, nb)
    assert _rel(got, want) < TOL


# ---------------------------------------------------------------------------
# source-stream splits: each target's stream shared among S partial sums
# and combined in order.  Tolerance TOL (1e-6 * max) against the Pallas
# kernels: the splits reorder the fp32 sums, nothing else.
# ---------------------------------------------------------------------------

SPLITS = [1, 2, 3, 5]


def _split_band_setup(cluster, nb):
    """tm = tn = 128 over N = 700: 6 source rows (12 tiles), one band
    start per target tile."""
    pos, gm, soft = cluster
    tm = tn = 128
    rows = -(-pos.shape[0] // tn)
    start = np.random.default_rng(8).integers(
        0, rows - nb + 1, -(-pos.shape[0] // tm)).astype(np.int32)
    return pos, gm, soft, tm, tn, start


@pytest.fixture(scope="module")
def pallas_base_pass(cluster):
    """The Pallas skip_band base pass with 2 band rows (4 of 12 tiles), per
    mode."""
    pos, gm, soft, tm, tn, start = _split_band_setup(cluster, 2)
    return {mode: np.asarray(jpd._pallas_direct(
        _j(pos), _j(soft), _j(pos), _j(gm), _j(soft), "newtonian", True,
        mode, 1e-15, tm=tm, tn=tn, max_sub=2, interpret=True,
        mask_self=mode == "pot", skip_band=2, band_start=jnp.asarray(start)))
        for mode in ("acc", "pot")}


@pytest.mark.parametrize("mode", ["acc", "pot"])
@pytest.mark.parametrize("splits", SPLITS)
def test_split_base_pass_matches_pallas(cluster, pallas_base_pass, splits,
                                        mode):
    """8 non-band tiles a target: S = 3 and 5 do not divide them, and for
    every band start but the first some split holds tiles on both sides of
    the band."""
    pos, gm, soft, tm, tn, start = _split_band_setup(cluster, 2)
    pre = cd._soft_pre("newtonian", _t(soft))
    tgt = cd._targets(_t(pos), pre)
    src = cd._sources(_t(pos), _t(gm), pre, tn)
    got = cd._direct_tile(tgt, src, "newtonian", mode, True, 1e-15,
                          mode == "pot", 2, torch.tensor(start), tm, tn,
                          splits=splits)
    assert _rel(got, pallas_base_pass[mode]) < TOL
    # a split straddles the band: its share of the 8 non-band tiles runs
    # across the band's first tile index
    lo = start.astype(np.int64) * (tn // cd.BLOCK)
    bounds = [s * 8 // splits for s in range(splits + 1)]
    straddles = any(b0 < l < b1 for l in lo
                    for b0, b1 in zip(bounds, bounds[1:]))
    assert straddles == (splits < 8 and (lo > 0).any())


@pytest.mark.parametrize("mode", ["acc", "pot"])
@pytest.mark.parametrize("splits", SPLITS)
def test_split_band_pass_matches_pallas(cluster, splits, mode):
    """5 band rows of 128: S = 2, 3 share them unevenly, S = 5 one each."""
    pos, gm, soft, tm, tn, start = _split_band_setup(cluster, 5)
    hinv = np.where(soft > 0, 1.0 / soft, np.inf).astype(np.float32)
    mask = mode == "pot"
    want = jpd._pallas_band_correction(
        _j(pos), _j(gm), _j(hinv), jnp.asarray(start), mode, 1e-15, tm, tn,
        5, interpret=True, mask_self=mask, kahan=True)
    tgt = cd._targets(_t(pos), _t(hinv))
    src = cd._sources(_t(pos), _t(gm), _t(hinv), tn)
    got = cd._band(tgt, src, torch.tensor(start), mode, True, 1e-15, mask,
                   tm, tn, 5, splits=splits)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("kind,mode", [("spline", "pot"),
                                       ("dehnen_k2", "acc")])
def test_split_single_pass_matches_pallas(cluster, kind, mode):
    """The single pass (no band) shares its 12 tiles among 5 splits; the
    potential keeps its self mask."""
    pos, gm, soft = cluster
    mask = mode == "pot"
    want = jpd._pallas_direct(_j(pos), _j(soft), _j(pos), _j(gm), _j(soft),
                              kind, True, mode, 1e-15, interpret=True,
                              mask_self=mask)
    pre = cd._soft_pre(kind, _t(soft))
    tgt = cd._targets(_t(pos), pre)
    src = cd._sources(_t(pos), _t(gm), pre, cd.TN)
    got = cd._direct_tile(tgt, src, kind, mode, True, 1e-15, mask,
                          splits=5)
    assert _rel(got, want) < TOL


def _one_stream_base(tgt, src, kind, mode, kahan, eps2, mask_self, nb, start,
                     tm, tn):
    """The single-stream sum of the base pass as it was before the splits:
    every tile in order, the band's tiles skipped."""
    nt, ns = tgt.shape[1], src.shape[1]
    xt, yt, zt, pt = (tgt[k][:, None] for k in range(4))
    total = torch.zeros((nt, 3 if mode == "acc" else 1))
    comp = torch.zeros_like(total)
    i = torch.arange(nt)[:, None]
    lane = torch.arange(cd.BLOCK)[None, :]
    lo = start.to(torch.int64)[i // tm] * tn
    for j0 in range(0, ns, cd.BLOCK):
        part = cd._pair_sum(kind, mode, eps2, xt, yt, zt, pt,
                            *(src[k, j0:j0 + cd.BLOCK][None, :]
                              for k in range(5)),
                            self_pair=(i == j0 + lane) if mask_self else None)
        total, comp = cd._kahan_step(total, comp, part, kahan,
                                     (j0 < lo) | (j0 >= lo + nb * tn))
    return total if mode == "acc" else total[:, 0]


def _one_stream_band(tgt, src, start, mode, kahan, eps2, mask_self, tm, tn,
                     nb):
    """The single-stream band sum before the splits: rows in order."""
    nt = tgt.shape[1]
    xt, yt, zt, pt = (tgt[k][:, None] for k in range(4))
    total = torch.zeros((nt, 3 if mode == "acc" else 1))
    comp = torch.zeros_like(total)
    i = torch.arange(nt)
    row0 = start.to(torch.int64)[i // tm]
    for b in range(nb):
        j = ((row0 + b) * tn)[:, None] + torch.arange(tn)[None, :]
        part = cd._pair_sum("spline", mode, eps2, xt, yt, zt, pt,
                            *(src[k][j] for k in range(5)),
                            self_pair=(j == i[:, None]) if mask_self else None)
        total, comp = cd._kahan_step(total, comp, part, kahan)
    return total if mode == "acc" else total[:, 0]


@pytest.mark.parametrize("mode", ["acc", "pot"])
@pytest.mark.parametrize("kahan", [True, False])
def test_one_split_is_the_single_stream_sum_bit_for_bit(cluster, mode,
                                                        kahan):
    pos, gm, soft, tm, tn, start = _split_band_setup(cluster, 2)
    mask = mode == "pot"
    st = torch.tensor(start)
    pre = cd._soft_pre("newtonian", _t(soft))
    tgt = cd._targets(_t(pos), pre)
    src = cd._sources(_t(pos), _t(gm), pre, tn)
    assert torch.equal(
        cd._direct_tile_reference(tgt, src, "newtonian", mode, kahan, 1e-15,
                                  mask, 2, st, tm, tn, splits=1),
        _one_stream_base(tgt, src, "newtonian", mode, kahan, 1e-15, mask, 2,
                         st, tm, tn))
    hinv = cd._soft_pre("spline", _t(soft))
    tgt = cd._targets(_t(pos), hinv)
    src = cd._sources(_t(pos), _t(gm), hinv, tn)
    assert torch.equal(
        cd._band_reference(tgt, src, st, mode, kahan, 1e-15, mask, tm, tn, 2,
                           splits=1),
        _one_stream_band(tgt, src, st, mode, kahan, 1e-15, mask, tm, tn, 2))


def test_split_of_follows_the_kernel_shares():
    """Unit k of n lies in split s exactly when s*n // S <= k < (s+1)*n // S
    (csrc split_range), for shares that divide and that do not."""
    for n in range(1, 21):
        for splits in range(1, 8):
            for s in range(splits):
                for k in range(s * n // splits, (s + 1) * n // splits):
                    assert cd._split_of(k, n, splits) == s


def test_split_count_is_a_function_of_the_launch_shape_and_sms():
    """S from (N, SM count) alone: the same inputs give the same S; S = 1
    once the target blocks alone make SPLIT_WAVES waves; no split sums
    fewer than MIN_SPLIT_TILES tiles."""
    def base(n, sms):
        ns = -(-n // cd.TN) * cd.TN
        return cd.split_count("direct", n, ns, sms,
                              cd.band_rows(ns // cd.TN), cd.TN)

    def band(n, sms):
        ns = -(-n // cd.TN) * cd.TN
        return cd.split_count("band", n, ns, sms, cd.band_rows(ns // cd.TN),
                              cd.TN)

    assert [base(n, 132) for n in (16384, 65536, 262144, 1048576)] == \
        [20, 12, 3, 1]
    assert [band(n, 132) for n in (16384, 65536, 262144, 1048576)] == \
        [12, 12, 4, 1]
    assert base(65536, 132) == base(65536, 132)
    assert base(65536, 12) == 1            # 1,024 blocks: 4 waves of 12 SMs
    assert cd.split_count("direct", 1, 65536, 132) == 1024 // \
        cd.MIN_SPLIT_TILES
    for n in (4096, 16384, 65536, 131072):
        ns = -(-n // cd.TN) * cd.TN
        nb = cd.band_rows(ns // cd.TN)
        s = base(n, 132)
        assert (ns // cd.BLOCK - nb * cd.TN // cd.BLOCK) // s >= \
            cd.MIN_SPLIT_TILES or s == 1
        assert 1 <= band(n, 132) <= nb
    with pytest.raises(ValueError, match="kernel"):
        cd.split_count("single", 65536, 65536, 132)


def test_self_sorted_two_pass_with_splits_matches_pallas(sorted_case,
                                                         jax_sorted_acc):
    """The sorted path's two passes with S = 2 and 3 (the band of 12 rows
    in 2 and 3 shares, the 12 non-band rows' 24 tiles likewise)."""
    pos, gm, soft = sorted_case
    ps, gs, hs = _t(pos), _t(gm), _t(soft)
    order = cd.slab_sort_key(ps)
    ps, gs, hs = ps[order], gs[order], hs[order]
    hinv = cd._soft_pre("spline", hs)
    first, width, rows = cd.band_window(ps[:, 0], hs.max(), **SORT_KW)
    nb = cd.band_rows(rows)
    assert int(width) <= nb
    start = first.clamp(0, rows - nb).to(torch.int32)
    tgt, src = cd._targets(ps, hinv), cd._sources(ps, gs, hinv, SORT_KW["tn"])
    for splits in (2, 3):
        out = (cd._direct_tile(tgt, src, "newtonian", "acc", True, 1e-15,
                               False, nb, start, splits=splits, **SORT_KW)
               + cd._band(tgt, src, start, "acc", True, 1e-15, False,
                          nb=nb, splits=splits, **SORT_KW))
        got = torch.empty_like(out)
        got[order] = out
        assert _rel(got, jax_sorted_acc) < TOL


# ---------------------------------------------------------------------------
# the sorted two-pass path
# ---------------------------------------------------------------------------

def _branches():
    return dict(cd.BRANCHES)


def test_self_sorted_two_pass_matches_pallas(sorted_case, jax_sorted_acc):
    pos, gm, soft = sorted_case
    before = _branches()
    got = cd._self_sorted(_t(pos), _t(gm), _t(soft), "spline", True, "acc",
                          1e-15, **SORT_KW)
    assert cd.BRANCHES["two_pass"] == before["two_pass"] + 1
    assert _rel(got, jax_sorted_acc) < TOL


def test_self_sorted_potential_matches_pallas(sorted_case):
    pos, gm, soft = sorted_case
    want = jpd._pallas_self_sorted(_j(pos), _j(gm), _j(soft), "spline",
                                   True, "pot", 1e-15, interpret=True,
                                   max_sub=8, **SORT_KW)
    before = _branches()
    got = cd._self_sorted(_t(pos), _t(gm), _t(soft), "spline", True, "pot",
                          1e-15, **SORT_KW)
    assert cd.BRANCHES["two_pass"] == before["two_pass"] + 1
    assert _rel(got, want) < TOL


def test_self_sorted_fallback_matches_pallas(sorted_case):
    """Softening comparable to the system size: the band cannot hold the
    windows, and the single-pass spline kernel runs instead."""
    pos, gm, _ = sorted_case
    hbig = np.full(pos.shape[0], 5.0, np.float32)
    want = jpd._pallas_self_sorted(_j(pos), _j(gm), _j(hbig), "spline", True,
                                   "acc", 1e-15, interpret=True, max_sub=8,
                                   **SORT_KW)
    before = _branches()
    got = cd._self_sorted(_t(pos), _t(gm), _t(hbig), "spline", True, "acc",
                          1e-15, **SORT_KW)
    assert cd.BRANCHES["single_pass"] == before["single_pass"] + 1
    assert cd.BRANCHES["two_pass"] == before["two_pass"]
    assert _rel(got, want) < TOL


@pytest.fixture(scope="module")
def king_case():
    """The stream deployment's King cluster (W0 = 5, r_c = h = 0.02) at N =
    4,096: with tm=64, tn=128 its widest band window (19 of 32 rows)
    outgrows the static band (12 rows), so the port widens the band to
    the window and runs the two passes, where the JAX package falls back
    to its single pass."""
    from nbody_streams_tpu_torch.fast_sims.king import sample_king

    xv, m = sample_king(4096, mass=5e6, r_core=0.02, W0=5.0, seed=2)
    return (xv[:, :3].astype(np.float32), (G * m).astype(np.float32),
            np.full(4096, 0.02, np.float32))


@pytest.mark.parametrize("mode,form", [
    ("acc", {}), ("pot", {}), ("acc", {"mxu": True}),
    ("acc", {"mxu": True, "fold_mass": False}), ("acc", {"fast": True}),
    ("pot", {"fast": True})],
    ids=["acc", "pot", "acc-mxu", "acc-mxu-unfolded", "acc-fast", "pot-fast"])
def test_widened_two_passes_match_pallas_single_pass_and_fp64(king_case, mode,
                                                              form):
    """The widened band's two passes, in the VPU base pass and the moment
    forms (kernel M folded and not, kernel F), against the JAX package's
    ``_pallas_self_sorted`` in the same form (its single pass there: its
    band is static) and the float64 oracle, both within TOL."""
    pos, gm, soft = king_case
    order = cd.slab_sort_key(_t(pos))
    _, width, rows = cd.band_window(_t(pos)[order, 0], float(soft.max()),
                                    **SORT_KW)
    assert cd.band_rows(rows) < int(width) <= cd.BAND_MAX_SHARE * rows
    before = _branches()
    got = cd._self_sorted(_t(pos), _t(gm), _t(soft), "spline", True, mode,
                          1e-15, **SORT_KW, **form)
    took = {k: cd.BRANCHES[k] - before[k] for k in before}
    assert (took["two_pass"], took["single_pass"], took["widened"]) == (1, 0,
                                                                        1)
    assert took["band_rows"] == took["window_rows"] == int(width)
    jform = {k: v for k, v in form.items() if k != "fold_mass"}
    want = jpd._pallas_self_sorted(_j(pos), _j(gm), _j(soft), "spline", True,
                                   mode, 1e-15, interpret=True, max_sub=8,
                                   **SORT_KW, **jform)
    assert _rel(got, want) < TOL
    oracle = j_forces if mode == "acc" else j_potential
    ref = oracle(np.asarray(pos, np.float64), np.asarray(gm, np.float64),
                 np.asarray(soft, np.float64), G=1.0, precision="float64",
                 kernel="spline")
    assert _rel(got, ref) < TOL


def test_stale_shuffled_and_drifter_orders_stay_exact(sorted_case,
                                                      jax_sorted_acc):
    """Any permutation is exact on the sorted path: the band windows are
    recomputed from the actual positions (mirrors the JAX package's
    test_sorted_path_stale_order_is_exact)."""
    pos, gm, soft = sorted_case
    rng = np.random.default_rng(12)
    tp, tg, ts = _t(pos), _t(gm), _t(soft)
    run = lambda p, order=None: cd._self_sorted(   # noqa: E731
        p, tg, ts, "spline", True, "acc", 1e-15, order=order,
        **SORT_KW).double().numpy()
    ref = run(tp)
    assert _rel(ref, jax_sorted_acc) < TOL

    past = tp + torch.tensor(rng.normal(0, 0.02, pos.shape),
                             dtype=torch.float32)
    stale = cd.slab_sort_key(past)
    shuf = torch.tensor(rng.permutation(pos.shape[0]))
    # drifter: one particle crossed the whole system since the sort, and
    # landed inside the spline support of the x-max particle
    drift = pos.copy()
    lo, hi = int(np.argmin(drift[:, 0])), int(np.argmax(drift[:, 0]))
    drift[lo] = drift[hi] + np.array([0.012, 0.012, 0.0], np.float32)
    ref_drift = run(_t(drift))
    for p, order, r in ((tp, cd.slab_sort_key(tp), ref), (tp, stale, ref),
                        (tp, shuf, ref),
                        (_t(drift), cd.slab_sort_key(tp), ref_drift)):
        assert _rel(run(p, order), r) < 5e-6


def test_zero_softening_gives_no_nan(cluster):
    pos, gm, _ = cluster
    zero = torch.zeros(pos.shape[0])
    acc = cd.cuda_accel(_t(pos), _t(gm), zero, 1.0, "newtonian", False)
    assert torch.isfinite(acc).all()
    # h = 0 on the sorted spline path: 1/h = inf selects Newtonian
    acc = cd.cuda_accel(_t(pos), _t(gm), zero, 1.0, "spline", True,
                        spatial_sort=True, **SORT_KW)
    assert torch.isfinite(acc).all()


def test_potential_with_zero_softening_particles_matches_oracle(cluster):
    """h = 0 particles: the in-kernel self mask avoids the cancellation an
    outside self-term subtraction would cause (3e-6 * max vs the fp64
    oracle, the JAX package's kernel-vs-oracle tolerance)."""
    pos, gm, soft = cluster
    s = soft.copy()
    s[:50] = 0.0
    m = gm / G
    got = cd.cuda_potential(_t(pos), _t(m), _t(s), G, "spline", True)
    want = j_potential(pos.astype(np.float64), m.astype(np.float64),
                       s.astype(np.float64), G=G, kernel="spline",
                       precision="float64")
    assert _rel(got, want) < 3e-6


@pytest.mark.parametrize("kind", ["plummer", "spline"])
def test_public_accel_matches_fp64_oracle(cluster, kind):
    pos, gm, soft = cluster
    m = gm / G
    got = cd.cuda_accel(_t(pos), _t(m), _t(soft), G, kind, True)
    want = j_forces(pos.astype(np.float64), m.astype(np.float64),
                    soft.astype(np.float64), G=G, kernel=kind,
                    precision="float64")
    assert _rel(got, want) < 3e-6


def test_cpu_tensors_run_the_plain_versions(cluster):
    """On the CPU the wrappers take the plain versions and launch nothing."""
    pos, gm, soft = cluster
    before = dict(cd.LAUNCHES)
    pre = cd._soft_pre("spline", _t(soft))
    tgt, src = cd._targets(_t(pos), pre), cd._sources(_t(pos), _t(gm), pre,
                                                      cd.TN)
    got = cd._direct_tile(tgt, src, "spline", "acc", True, 1e-15)
    want = cd._direct_tile_reference(tgt, src, "spline", "acc", True, 1e-15)
    assert torch.equal(got, want)
    assert cd.LAUNCHES == before


def test_geometry_and_operands_are_checked(cluster):
    pos, gm, soft = cluster
    with pytest.raises(ValueError, match="multiples"):
        cd._self_sorted(_t(pos), _t(gm), _t(soft), "spline", True, "acc",
                        1e-15, tm=100, tn=128)
    pre = cd._soft_pre("plummer", _t(soft))
    tgt = cd._targets(_t(pos), pre)
    with pytest.raises(ValueError, match="src must be"):
        cd._direct_tile(tgt, tgt, "plummer", "acc", True, 1e-15)
    src = cd._sources(_t(pos), _t(gm), pre, cd.TN)
    with pytest.raises(ValueError, match="start must be"):
        cd._direct_tile(tgt, src, "newtonian", "acc", True, 1e-15, nb=2,
                        start=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="splits"):
        cd._direct_tile(tgt, src, "plummer", "acc", True, 1e-15, splits=0)


# ---------------------------------------------------------------------------
# DirectGravity
# ---------------------------------------------------------------------------

def test_direct_gravity_impls_and_tiers():
    n = 64
    m, h = np.full(n, 1e5), np.full(n, 0.05)
    cpu = dict(device="cpu")
    assert DirectGravity(m, h, **cpu).impl == "torch"     # auto on the CPU
    assert DirectGravity(m, h, impl="cuda", **cpu).impl == "cuda"
    assert DirectGravity(m, h, impl="cuda", precision="float64",
                         **cpu).impl == "torch"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DirectGravity(m, h, impl="xla", **cpu)
    # the ring: over the devices given, the first of them the solver's
    ring = DirectGravity(m, h, impl="sharded", devices=["cpu"] * 2)
    assert ring.impl == "sharded" and ring.device == torch.device("cpu")
    assert DirectGravity(m, h, devices=["cpu"] * 2).impl == "sharded"
    with pytest.raises(ValueError, match="impl"):
        DirectGravity(m, h, impl="pallas", **cpu)
    # float32_fast off the sorted spline path (here the torch oracle at
    # N = 64) runs as plain float32 and says so
    with pytest.warns(PerformanceWarning, match="runs as plain 'float32'"):
        fast = DirectGravity(m, h, precision="float32_fast", **cpu)
    assert fast.dtype == torch.float32 and not fast.kahan and fast.fast
    assert DirectGravity(m, h, target_drift=1e-8,
                         **cpu).target_drift == 1e-8
    with pytest.raises(ValueError, match="target_drift"):
        DirectGravity(m, h, target_drift=0.0, **cpu)


def test_direct_gravity_default_device_is_the_card():
    """With no device= the solver is built on the card: without one it
    raises, naming the CPU option; device='cpu' runs the torch oracle."""
    m, h = np.full(64, 1e5), np.full(64, 0.05)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DirectGravity(m, h)
    solver = DirectGravity(m, h, device="cpu")
    assert solver.device.type == "cpu" and solver.impl == "torch"


def test_direct_gravity_sorted_path_properties(monkeypatch):
    """The solver takes the sorted path on the spline at N >= SORT_MIN_N
    with impl='cuda', and hands it no order: the path sorts the positions
    it is given.  Smaller N and the oracle stay off it, and a position
    array of another length raises."""
    seen = []

    def spy(pos, *args, **kw):
        seen.append((pos.shape[0], kw.get("order")))
        return torch.zeros_like(pos if args[4] == "acc" else pos[:, 0])

    monkeypatch.setattr(cd, "_self_sorted", spy)
    pos = torch.tensor(np.random.default_rng(0).normal(size=(16384, 3)),
                       dtype=torch.float32)
    big = DirectGravity(np.full(16384, 1.0), 0.05, impl="cuda",
                        device="cpu")
    big.accel(pos)
    big.potential(pos)
    assert seen == [(16384, None)] * 2
    small = DirectGravity(np.full(512, 1.0), 0.05, impl="cuda",
                          device="cpu")
    small.accel(pos[:512])
    oracle = DirectGravity(np.full(1024, 1.0), 0.05, impl="torch",
                           device="cpu")
    oracle.accel(pos[:1024])
    assert len(seen) == 2
    with pytest.raises(ValueError, match="pos shape"):
        small.accel(torch.zeros(10, 3))
    with pytest.raises(ValueError, match="pos shape"):
        small.accel(torch.zeros(520, 3))


@pytest.mark.parametrize("mode", ["accel", "potential"])
def test_direct_gravity_sorted_path_sorts_its_own_input(monkeypatch, mode):
    """On the sorted path (its threshold lowered to N = 3,072, band
    geometry 64 x 128) ``DirectGravity.accel`` / ``.potential`` equal
    ``cuda_accel`` / ``cuda_potential`` given the slab order of the same
    positions bit for bit, the solver's call opening its own
    ``dispatch.sort`` before the branch read."""
    from torch.profiler import ProfilerActivity, profile

    from nbody_streams_tpu_torch import telemetry

    monkeypatch.setattr(cd, "SORT_MIN_N", 2048)
    rng = np.random.default_rng(11)
    n = 3072
    solver = DirectGravity(rng.uniform(0.5, 2.0, n) * 1e5, np.full(n, 0.02),
                           G=G, impl="cuda", device="cpu",
                           tile_config={"tm": 64, "tn": 128})
    pos = torch.tensor(rng.normal(0, 1, (n, 3)), dtype=torch.float32)
    wrapper = cd.cuda_accel if mode == "accel" else cd.cuda_potential
    before = dict(cd.BRANCHES)
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = getattr(solver, mode)(pos)
        own = [sp[0] for sp in telemetry.spans()]
        want = wrapper(pos, solver.mass, solver.softening, solver.G,
                       solver.kernel, solver.kahan, solver.eps2,
                       order=cd.slab_sort_key(pos), tm=64, tn=128)
    assert own == ["dispatch.sort", "dispatch.sync"]
    assert [sp[0] for sp in telemetry.spans()][2:] == ["dispatch.sync"]
    assert cd.BRANCHES["two_pass"] == before["two_pass"] + 2
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["accel", "potential"])
def test_direct_gravity_cuda_impl_matches_torch_impl(cluster, mode):
    pos, gm, soft = cluster
    m = gm / G
    a = getattr(DirectGravity(m, soft, G=G, impl="cuda", device="cpu"),
                mode)(_t(pos))
    b = getattr(DirectGravity(m, soft, G=G, impl="torch", device="cpu"),
                mode)(_t(pos))
    assert _rel(a, b) < TOL
