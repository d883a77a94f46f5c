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


# ---------------------------------------------------------------------------
# DirectGravity
# ---------------------------------------------------------------------------

def test_direct_gravity_impls_and_tiers():
    n = 64
    m, h = np.full(n, 1e5), np.full(n, 0.05)
    assert DirectGravity(m, h).impl == "torch"            # auto on the CPU
    assert DirectGravity(m, h, impl="cuda").impl == "cuda"
    assert DirectGravity(m, h, impl="cuda", precision="float64").impl \
        == "torch"
    for impl in ("xla", "sharded"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DirectGravity(m, h, impl=impl)
    with pytest.raises(ValueError, match="impl"):
        DirectGravity(m, h, impl="pallas")
    with pytest.warns(PerformanceWarning, match="float32_fast"):
        fast = DirectGravity(m, h, precision="float32_fast")
    assert fast.dtype == torch.float32 and not fast.kahan
    assert DirectGravity(m, h, target_drift=1e-8).target_drift == 1e-8
    with pytest.raises(ValueError, match="target_drift"):
        DirectGravity(m, h, target_drift=0.0)


def test_direct_gravity_sorted_path_properties():
    big = DirectGravity(np.full(16384, 1.0), 0.05, impl="cuda")
    assert big.spatial_sort_active and big.presort_interval == 1
    pos = torch.tensor(np.random.default_rng(0).normal(size=(16384, 3)),
                       dtype=torch.float32)
    assert torch.equal(big.sort_key(pos), torch.argsort(pos[:, 0],
                                                        stable=True))
    small = DirectGravity(np.full(512, 1.0), 0.05, impl="cuda")
    assert not small.spatial_sort_active and small.presort_interval is None
    oracle = DirectGravity(np.full(16384, 1.0), 0.05, impl="torch")
    assert not oracle.spatial_sort_active
    with pytest.raises(ValueError, match="pos shape"):
        small.accel(torch.zeros(10, 3))


@pytest.mark.parametrize("mode", ["accel", "potential"])
def test_direct_gravity_cuda_impl_matches_torch_impl(cluster, mode):
    pos, gm, soft = cluster
    m = gm / G
    a = getattr(DirectGravity(m, soft, G=G, impl="cuda"), mode)(_t(pos))
    b = getattr(DirectGravity(m, soft, G=G, impl="torch"), mode)(_t(pos))
    assert _rel(a, b) < TOL
