"""Hand-written CUDA all-pairs forces and potentials, and their host side.

Counterpart of ``nbody_streams_tpu/ops/pallas_direct.py``.  Two kernels in
``csrc/direct.cu`` carry the default direct-summation path, and one in
``csrc/moment.cu`` the TPU's matrix-unit forms:

* ``direct_tile_kernel`` (``_direct_tile``): every target against every
  source, five softening laws, acceleration or potential, Kahan across
  staged source tiles on or off, and optionally ``skip_band``: each target
  tile leaves out its band of near source rows.  It replaces the TPU's
  ``_direct_kernel``.
* ``band_kernel`` (``_band``): the full spline over exactly those band
  rows.  It replaces the TPU's ``_band_kernel``.
* ``moment_tile_kernel`` (``_moment_tile``): the same sums as moments on
  the tensor cores, P = S @ G m [x y z 1] finalised as a_i = P[:3] -
  x_i P[3] (kernel M; ``fold_mass=False`` keeps G m in S), and with
  ``fast`` r^2 expanded with its cross term on the tensor cores (kernel
  F, the ``float32_fast`` tier, acc and pot).  It replaces the TPU's
  ``_direct_kernel`` with ``mxu`` / ``mxu_r2``, for the Newtonian law
  and no self pair: the sorted base pass and the ring's far tiles.

Each splits every target block's source stream across S blocks (the
base pass its tiles outside the band, the band pass its band rows), so
that N = 65,536 fills the card; ``split_count`` picks S from the launch
shape and the card's SM count, S = 1 once the target blocks alone make
four waves.  For S > 1 the wrapper allocates the scratch of the partial
sums and the kernel's second launch, ``combine_kernel``, adds them in a
fixed order (``moment_finalise_kernel`` for the moment forms, which also
finalise).

In potential mode ``mask_self`` excludes the pairs at identical index.
Such a pair can lie only in a block's diagonal tile (the source tile whose
first index is the block's first target index, as tiles and target blocks
both start at multiples of BLOCK), so the kernels test for it there alone.

Beside each wrapper is its plain torch version (``_direct_tile_reference``,
``_band_reference``, ``_moment_tile_reference``), with the same masking,
splits and Kahan grouping.  A wrapper runs the plain version only for
tensors on the CPU; for a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches by form: ``base``
(``direct_tile_kernel`` with the band skip), ``single`` (without it: the
single pass and the two-set calls), ``band``, ``moment`` (kernel M as the
base pass), ``moment_2set`` (kernel M's two-set form, the ring's far
tiles) and ``fast`` (kernel F as the base pass, acc or pot).
``BRANCHES`` counts the sorted path's calls by branch (``two_pass``,
``single_pass``) and sums their widest band window and band width in
source rows (``window_rows``, ``band_rows``).

The host side mirrors the TPU path: for the spline at N >= 16384 the
particles are sorted along x (``slab_sort_key``), a band window of source
rows is found for each target tile, and when every window fits the static
band width ``nb`` the Newtonian base pass (``skip_band``) plus the spline
band pass run; otherwise the single-pass spline kernel does.  Every pair is
evaluated exactly once with its exact factor either way.  The base pass
takes kernel M with ``tile={'mxu': True}`` and kernel F with ``fast``;
both centre the coordinates first.  By default it stays in the s*dx form
(``mxu=None`` is the VPU form here, where the TPU defaults to its matrix
unit: ROADMAP Queue 3).

Masses arrive pre-multiplied by G.  Pair rule ``h_eff = max(h_i, h_j)``
and ``eps2`` regularisation match ``ops/pairwise.py`` (the oracle).
"""
from __future__ import annotations

import warnings

import torch

from ..constants import KERNEL_IDS, PAIRWISE_EPS2, validate_kernel
from ..telemetry import span
from .pairwise import kahan_add

__all__ = ["cuda_accel", "cuda_potential", "cuda_accel_2set",
           "cuda_potential_2set", "uses_spatial_sort", "slab_sort_key",
           "split_count", "LAUNCHES", "BRANCHES"]

# Band geometry of the sorted path: targets per band tile and sources per
# band row.  The band tile bounds each target's window of near source rows;
# both must be multiples of BLOCK.
TM = 512
TN = 512
# Targets per CUDA block and sources per staged tile (csrc/direct_math.cuh).
BLOCK = 64
# The spline takes the sorted two-pass path from this N on.
SORT_MIN_N = 16384

# Source-stream splits (split_count): a wave of the card is
# RESIDENT_BLOCKS blocks of BLOCK a SM (48 registers a thread; the
# occupancy API gives 20 for tile_sol_kernel, the same registers and
# shared memory); a grid aims at SPLIT_WAVES waves, and no split sums
# fewer than MIN_SPLIT_TILES staged tiles.  `tile_sweep splits` measured
# the choice (PERF.md).
RESIDENT_BLOCKS = 20
SPLIT_WAVES = 4
MIN_SPLIT_TILES = 8

#: Kernel launches, counted by the wrappers where they launch (plain ints).
LAUNCHES = {"base": 0, "single": 0, "band": 0, "moment": 0,
            "moment_2set": 0, "fast": 0}
#: Which branch the sorted path picked (``two_pass`` or the ``single_pass``
#: fallback), counted where it picks, so its launches are in LAUNCHES; and
#: beside them two running sums over the same calls: ``window_rows``, each
#: call's widest band window in source rows (the width the branch read
#: brings to the host), and ``band_rows``, each call's band width ``nb``.
#: Their ratio says how far the windows outgrow the band.
BRANCHES = {"two_pass": 0, "single_pass": 0, "window_rows": 0,
            "band_rows": 0}

_MODES = {"acc": 0, "pot": 1}


# ---------------------------------------------------------------------------
# Pair factors from the per-particle softening quantity (see _soft_pre)
# ---------------------------------------------------------------------------

def _force_pre(kind, r2, pre):
    """Force factor with the pair quantity ``pre`` (csrc force_pre)."""
    if kind == "plummer":
        inv = torch.rsqrt(r2 + pre)
        return inv * inv * inv
    if kind == "dehnen_k1":
        inv = torch.rsqrt(r2 + pre)
        inv_d = inv * inv
        inv_d32 = inv_d * inv
        return inv_d32 + 1.5 * pre * (inv_d32 * inv_d)
    if kind == "dehnen_k2":
        inv = torch.rsqrt(r2 + pre)
        inv_d = inv * inv
        inv_d32 = inv_d * inv
        inv_d52 = inv_d32 * inv_d
        return (inv_d32 + 1.5 * pre * inv_d52
                + 3.75 * (pre * pre) * (inv_d52 * inv_d))
    if kind == "newtonian":
        inv = torch.rsqrt(r2)
        return inv * inv * inv
    if kind == "spline":
        # pre = 1/h (inf for h == 0: q = inf selects the Newtonian branch)
        inv_r = torch.rsqrt(r2)
        r = r2 * inv_r
        newton = inv_r * inv_r * inv_r
        h3inv = pre * pre * pre
        q = r * pre
        q2 = q * q
        inner = h3inv * (q2 * (32.0 * q - 38.4) + 10.666666666666666)
        outer = h3inv * (
            21.333333333333333
            + q * (-48.0 + q * (38.4 - 10.666666666666667 * q))
        ) - 0.0666666666666667 * newton
        soft = torch.where(q <= 0.5, inner, outer)
        return torch.where(q >= 1.0, newton, soft)
    raise ValueError(kind)


def _pot_pre(kind, r2, pre):
    """Potential factor with the pair quantity ``pre`` (csrc pot_pre)."""
    if kind == "plummer":
        return -torch.rsqrt(r2 + pre)
    if kind == "dehnen_k1":
        inv = torch.rsqrt(r2 + pre)
        return -inv - 0.5 * pre * (inv * inv * inv)
    if kind == "dehnen_k2":
        inv = torch.rsqrt(r2 + pre)
        inv_d32 = inv * inv * inv
        inv_d52 = inv_d32 * inv * inv
        return -inv - 0.5 * pre * inv_d32 - 0.375 * (pre * pre) * inv_d52
    if kind == "newtonian":
        return -torch.rsqrt(r2)
    if kind == "spline":
        inv_r = torch.rsqrt(r2)
        r = r2 * inv_r
        q = r * pre
        q2 = q * q
        # q^2 nesting of the inner branch (see ops/kernels.py)
        inner = (-2.8 + q2 * (5.333333333333333
                              + q2 * (6.4 * q - 9.6))) * pre
        outer = (
            -3.2
            + q2 * (10.666666666666666
                    + q * (-16.0 + q * (9.6 - 2.1333333333333333 * q)))
        ) * pre + 0.06666666666666667 * inv_r
        soft = torch.where(q <= 0.5, inner, outer)
        return torch.where(q >= 1.0, -inv_r, soft)
    raise ValueError(kind)


def _pair_pre(kind, pre_t, pre_s):
    # h_eff = max(h_i, h_j): min of 1/h for the spline, max of h^2 otherwise
    if kind == "spline":
        return torch.minimum(pre_t, pre_s)
    return torch.maximum(pre_t, pre_s)


def _soft_pre(kind, h):
    """Per-particle softening quantity: 1/h (inf for h = 0) for the
    spline, h^2 otherwise."""
    if kind == "spline":
        return torch.where(h > 0, 1.0 / h, torch.inf)
    return h * h


# ---------------------------------------------------------------------------
# Operand layout shared by the kernels and their plain versions
# ---------------------------------------------------------------------------

def _targets(pos, pre):
    """(4, nt) float32 rows x, y, z, pre."""
    return torch.cat([pos.T, pre[None, :]]).to(torch.float32).contiguous()


def _sources(pos, gmass, pre, tn):
    """(5, ns_pad) float32 rows x, y, z, G*m, pre, zero-padded to a
    multiple of ``tn`` (zero mass contributes exactly nothing)."""
    n = pos.shape[0]
    ns_pad = -(-n // tn) * tn
    src = torch.zeros((5, ns_pad), dtype=torch.float32, device=pos.device)
    src[:3, :n] = pos.T
    src[3, :n] = gmass
    src[4, :n] = pre
    return src


def _check_geometry(tm, tn):
    if tm <= 0 or tn <= 0 or tm % BLOCK or tn % BLOCK:
        raise ValueError(f"tm={tm} and tn={tn} must be positive multiples "
                         f"of {BLOCK}")


def _check_operands(tgt, src, start, nb, tm, tn):
    _check_geometry(tm, tn)
    for name, t, rows in (("tgt", tgt, 4), ("src", src, 5)):
        if (t.dtype != torch.float32 or t.ndim != 2 or t.shape[0] != rows
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"({rows}, n) tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if src.device != tgt.device:
        raise ValueError("tgt and src must be on one device")
    if src.is_cuda and src.data_ptr() % 16:
        raise ValueError("src must be 16-byte aligned (the potential "
                         "kernels load float4s)")
    if src.shape[1] % (tn if nb else BLOCK):
        raise ValueError(f"source count {src.shape[1]} must be a multiple of "
                         f"{tn if nb else BLOCK}")
    if nb:
        n_tiles = -(-tgt.shape[1] // tm)
        if (start is None or start.dtype != torch.int32
                or start.device != tgt.device or not start.is_contiguous()
                or start.shape != (n_tiles,)):
            raise ValueError(f"start must be a contiguous int32 ({n_tiles},) "
                             "tensor on the operands' device")
        if nb * tn > src.shape[1]:
            raise ValueError(f"band of {nb} rows exceeds the sources")


def _kernel_lib():
    from . import _build

    lib = _build.library()
    if lib.nbody_block_size() != BLOCK:
        raise RuntimeError(f"kernel library BLOCK {lib.nbody_block_size()} "
                           f"!= {BLOCK}")
    return lib


def _pair_sum(kind, mode, eps2, xt, yt, zt, pt, xs, ys, zs, gm, ps,
              self_pair=None):
    """Plain version of ``tile_sum`` (csrc/direct_math.cuh): targets
    (nt, 1) against sources broadcast to (nt, k), plain fp32 over axis 1;
    (nt, 3) for acc, (nt, 1) for pot, where ``self_pair`` (bool) zeroes
    the self pairs."""
    dx, dy, dz = xs - xt, ys - yt, zs - zt
    r2 = dx * dx + (dy * dy + (dz * dz + eps2))
    pre = _pair_pre(kind, pt, ps)
    if mode == "acc":
        s = gm * _force_pre(kind, r2, pre)
        return torch.stack([(s * dx).sum(1), (s * dy).sum(1),
                            (s * dz).sum(1)], dim=1)
    s = gm * _pot_pre(kind, r2, pre)
    if self_pair is not None:
        s = torch.where(self_pair, 0.0, s)
    return s.sum(1, keepdim=True)


def _kahan_step(total, comp, part, kahan, keep=None):
    """One accumulation step (Kahan two-sum or plain); ``keep`` (bool,
    broadcastable) leaves rows untouched where False, as a skipped tile."""
    t, c = kahan_add(total, comp, part) if kahan else (total + part, comp)
    if keep is None:
        return t, c
    return torch.where(keep, t, total), torch.where(keep, c, comp)


# ---------------------------------------------------------------------------
# direct_tile_kernel and its plain version
# ---------------------------------------------------------------------------

def _split_of(k, n, splits):
    """The split whose share of ``n`` units holds unit ``k``: split s
    takes ``[s*n // splits, (s+1)*n // splits)`` (csrc split_range)."""
    return ((k + 1) * splits - 1) // n


def _combine(total, comp, kahan):
    """Plain version of ``combine_kernel``: the (S, ...) partials added in
    the order s = 0..S-1; the running compensation takes ``comp[s]``
    before ``total[s]`` is added (Kahan tiers)."""
    out, c = total[0], comp[0]
    for s in range(1, total.shape[0]):
        if kahan:
            out, c = kahan_add(out, c + comp[s], total[s])
        else:
            out = out + total[s]
    return out


def _tile_walk(tgt, src, width, kahan, nb, start, tm, tn, splits, part_of):
    """The tile walk of the plain versions of ``direct_tile_kernel`` and
    ``moment_tile_kernel``: all targets at once, one staged tile of BLOCK
    sources per step (``part_of(j0)``: its (nt, width) sum), Kahan across
    tiles; with ``nb`` the tiles inside each target tile's band
    ``[start*tn, (start+nb)*tn)`` are left out.  The tiles a target sums
    are shared in order among ``splits`` partial sums, which ``_combine``
    adds: (nt, width)."""
    nt, ns = tgt.shape[1], src.shape[1]
    tiles = ns // BLOCK
    dev = tgt.device
    total = torch.zeros((splits, nt, width), dtype=tgt.dtype, device=dev)
    comp = torch.zeros_like(total)
    rows = torch.arange(nt, device=dev)
    lo = torch.zeros(nt, dtype=torch.int64, device=dev)
    band = torch.zeros_like(lo)       # each target's band tiles [lo, +band)
    if nb:
        first = start.to(torch.int64)[rows // tm] * (tn // BLOCK)
        lo = first.clamp(0, tiles)
        band = (first + nb * (tn // BLOCK)).clamp(0, tiles) - lo
    count = (tiles - band).clamp(min=1)
    for jt in range(tiles):
        part = part_of(jt * BLOCK)
        keep = (jt < lo) | (jt >= lo + band)
        k = torch.where(jt < lo, jt, jt - band)
        s = _split_of(k, count, splits).clamp(0, splits - 1)
        t, c = _kahan_step(total[s, rows], comp[s, rows], part, kahan,
                           keep[:, None])
        total[s, rows], comp[s, rows] = t, c
    return _combine(total, comp, kahan)


def _self_lanes(nt, j0, device):
    """(nt, BLOCK) bool: target i is source j0 + lane."""
    rows = torch.arange(nt, device=device)[:, None]
    return rows == j0 + torch.arange(BLOCK, device=device)[None, :]


def _direct_tile_reference(tgt, src, kind, mode, kahan, eps2,
                           mask_self=False, nb=0, start=None, tm=TM, tn=TN,
                           splits=1):
    """Plain torch version of ``direct_tile_kernel``: plain fp32 within a
    staged tile, Kahan across tiles, the band and the splits of
    ``_tile_walk``."""
    xt, yt, zt, pt = (tgt[k][:, None] for k in range(4))

    def part_of(j0):
        return _pair_sum(kind, mode, eps2, xt, yt, zt, pt,
                         *(src[k, j0:j0 + BLOCK][None, :] for k in range(5)),
                         self_pair=_self_lanes(tgt.shape[1], j0, tgt.device)
                         if mask_self else None)

    out = _tile_walk(tgt, src, 3 if mode == "acc" else 1, kahan, nb, start,
                     tm, tn, splits, part_of)
    return out if mode == "acc" else out[:, 0]


def split_count(kernel, nt, ns, sms, nb=0, tn=TN):
    """S, the blocks that share each target block's source stream in
    ``kernel`` ('direct' or 'band') for ``nt`` targets and ``ns`` sources
    (``nb`` band rows of ``tn``) on a card of ``sms`` SMs.

    S = 1 when the target blocks alone make SPLIT_WAVES waves of
    RESIDENT_BLOCKS a SM; otherwise about the S that makes them, each
    split taking ``units // S`` units (source tiles, or whole band rows)
    but no fewer than MIN_SPLIT_TILES tiles."""
    if kernel == "direct":
        units, per_unit = ns // BLOCK - nb * (tn // BLOCK), 1
    elif kernel == "band":
        units, per_unit = nb, tn // BLOCK
    else:
        raise ValueError(f"kernel must be 'direct' or 'band', got {kernel!r}")
    want = -(-SPLIT_WAVES * RESIDENT_BLOCKS * sms // -(-nt // BLOCK))
    if want <= 1 or units <= 1:
        return 1
    per = max(units // want, -(-MIN_SPLIT_TILES // per_unit), 1)
    return -(-units // per)


def _splits(kernel, tgt, src, nb, tn, splits):
    """The wrapper's S: ``splits`` if given, else ``split_count`` for the
    card that holds the operands, 1 on the CPU."""
    if splits is None and tgt.is_cuda:
        sms = torch.cuda.get_device_properties(
            tgt.device).multi_processor_count
        splits = split_count(kernel, tgt.shape[1], src.shape[1], sms, nb, tn)
    elif splits is None:
        splits = 1
    if not 1 <= splits <= 65535:
        raise ValueError(f"splits={splits} must be in [1, 65535]")
    return int(splits)


def _scratch(splits, out):
    """The (2, S, out.numel()) partial sums of S > 1 (None for S = 1)."""
    if splits == 1:
        return None
    return torch.empty((2, splits, out.numel()), dtype=torch.float32,
                       device=out.device)


def _direct_tile(tgt, src, kind, mode, kahan, eps2, mask_self=False, nb=0,
                 start=None, tm=TM, tn=TN, splits=None):
    """All-pairs sum of ``tgt`` (4, nt) against ``src`` (5, ns) through
    ``direct_tile_kernel``; (nt, 3) for acc, (nt,) for pot.  ``splits``
    forces S (default: ``split_count`` on a card, 1 on the CPU)."""
    validate_kernel(kind)
    _check_operands(tgt, src, start, nb, tm, tn)
    splits = _splits("direct", tgt, src, nb, tn, splits)
    if not tgt.is_cuda:
        return _direct_tile_reference(tgt, src, kind, mode, kahan, eps2,
                                      mask_self, nb, start, tm, tn, splits)
    from . import _build

    nt, ns = tgt.shape[1], src.shape[1]
    out = torch.empty((nt, 3) if mode == "acc" else (nt,),
                      dtype=torch.float32, device=tgt.device)
    part = _scratch(splits, out)
    with torch.cuda.device(tgt.device):
        rc = _kernel_lib().nbody_direct(
            KERNEL_IDS[kind], _MODES[mode], int(kahan), int(nb),
            tgt.data_ptr(), nt, src.data_ptr(), ns,
            None if start is None else start.data_ptr(), tm, tn,
            int(mask_self), float(eps2), splits,
            None if part is None else part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "direct_tile_kernel")
    LAUNCHES["base" if nb else "single"] += 1
    return out


# ---------------------------------------------------------------------------
# band_kernel and its plain version
# ---------------------------------------------------------------------------

def _band_reference(tgt, src, start, mode, kahan, eps2, mask_self, tm, tn,
                    nb, splits=1):
    """Plain torch version of ``band_kernel``: for each target, the full
    spline over the ``nb`` source rows of ``tn`` from its tile's
    ``start``; plain fp32 within a row, Kahan across rows.  The rows are
    shared in order among ``splits`` partial sums, which ``_combine``
    adds."""
    nt = tgt.shape[1]
    xt, yt, zt, pt = (tgt[k][:, None] for k in range(4))
    width = 3 if mode == "acc" else 1
    total = torch.zeros((splits, nt, width), dtype=tgt.dtype,
                        device=tgt.device)
    comp = torch.zeros_like(total)
    i = torch.arange(nt, device=tgt.device)
    row0 = start.to(torch.int64)[i // tm]
    lane = torch.arange(tn, device=tgt.device)[None, :]
    for b in range(nb):
        j = ((row0 + b) * tn)[:, None] + lane           # (nt, tn)
        part = _pair_sum("spline", mode, eps2, xt, yt, zt, pt,
                         *(src[k][j] for k in range(5)),
                         self_pair=(j == i[:, None]) if mask_self else None)
        s = _split_of(b, nb, splits)
        total[s], comp[s] = _kahan_step(total[s], comp[s], part, kahan)
    out = _combine(total, comp, kahan)
    return out if mode == "acc" else out[:, 0]


def _band(tgt, src, start, mode, kahan, eps2, mask_self, tm, tn, nb,
          splits=None):
    """Spline band pass through ``band_kernel``: (nt, 3) or (nt,).  A
    window outside the sources (``start`` < 0 or ``start + nb`` past the
    last row) gives NaN for that tile's targets on the card.  ``splits``
    forces S (default: ``split_count`` on a card, 1 on the CPU)."""
    if nb <= 0:
        raise ValueError(f"band width nb={nb} must be positive")
    _check_operands(tgt, src, start, nb, tm, tn)
    splits = _splits("band", tgt, src, nb, tn, splits)
    if not tgt.is_cuda:
        return _band_reference(tgt, src, start, mode, kahan, eps2,
                               mask_self, tm, tn, nb, splits)
    from . import _build

    nt, ns = tgt.shape[1], src.shape[1]
    out = torch.empty((nt, 3) if mode == "acc" else (nt,),
                      dtype=torch.float32, device=tgt.device)
    part = _scratch(splits, out)
    with torch.cuda.device(tgt.device):
        rc = _kernel_lib().nbody_band(
            _MODES[mode], int(kahan), int(nb), tgt.data_ptr(), nt,
            src.data_ptr(), ns, start.data_ptr(), tm, tn, int(mask_self),
            float(eps2), splits, None if part is None else part.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "band_kernel")
    LAUNCHES["band"] += 1
    return out


# ---------------------------------------------------------------------------
# moment_tile_kernel (kernels M and F) and its plain version
# ---------------------------------------------------------------------------

class _fp32_matmul:
    """Products in full fp32 on the card: ``torch.backends.cuda.matmul.
    allow_tf32 = False`` inside the block (restored after), so that the
    plain version of a tensor-core kernel is no TF32 product itself."""

    def __enter__(self):
        self._was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._was


def _check_moment_form(kind, mode, fold, fast, nb):
    """The forms ``moment_tile_kernel`` is built in (``nbody_moment``),
    all with the Newtonian law and no self pair: the sorted base pass
    (``nb`` > 0; the band holds every self pair) as kernel M (acc, folded
    or not) or kernel F (``fast``: acc, or pot); the two-set acc (``nb`` =
    0), folded: the ring's far tiles, whose blocks are never the targets'
    own."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'acc' or 'pot', got {mode!r}")
    if kind != "newtonian":
        raise ValueError("the moment forms take the Newtonian law (the "
                         f"ring's far tiles, the sorted base pass); got "
                         f"kind={kind!r}")
    if not nb and (mode != "acc" or not fold or fast):
        raise ValueError("the two-set moment form is the folded "
                         "acceleration (fast needs the sorted base pass)")
    if mode == "pot" and not fast:
        raise ValueError("the potential's moment form is kernel F's "
                         "(fast=True); the plain row sum runs on "
                         "direct_tile_kernel")


def _moment_tile_reference(tgt, src, kind, mode, kahan, eps2, fold=True,
                           fast=False, nb=0, start=None, tm=TM, tn=TN,
                           splits=1):
    """Plain torch version of ``moment_tile_kernel``: per staged tile the
    pair factors S (r^2 expanded with ``fast``) and the moments S @ B in
    fp32 (``_fp32_matmul``), Kahan across tiles, the band and splits of
    ``_tile_walk``, then acc = P[:, :3] - x_t P[:, 3] or phi = P[:, 0]."""
    xt, yt, zt, pt = (tgt[k][:, None] for k in range(4))
    if fast:
        t3 = tgt[:3].T
        a_t = xt * xt + (yt * yt + (zt * zt + eps2))

    def part_of(j0):
        xs, ys, zs, gm, ps = (src[k, j0:j0 + BLOCK][None, :]
                              for k in range(5))
        if fast:
            cross = t3 @ src[:3, j0:j0 + BLOCK]
            b_s = xs * xs + (ys * ys + zs * zs)
            dxx = xs - xt
            r2 = torch.maximum(a_t + (b_s - 2.0 * cross), dxx * dxx + eps2)
        else:
            dx, dy, dz = xs - xt, ys - yt, zs - zt
            r2 = dx * dx + (dy * dy + (dz * dz + eps2))
        pre = _pair_pre(kind, pt, ps)
        if mode == "acc":
            s = _force_pre(kind, r2, pre)
            if fold:
                b = torch.cat([gm * xs, gm * ys, gm * zs, gm])
            else:
                s = gm * s
                b = torch.cat([xs, ys, zs, torch.ones_like(xs)])
        else:
            s, b = _pot_pre(kind, r2, pre), gm
        return s @ b.T

    with _fp32_matmul():
        p = _tile_walk(tgt, src, 4 if mode == "acc" else 1, kahan, nb,
                       start, tm, tn, splits, part_of)
    if mode == "acc":
        return p[:, :3] - tgt[:3].T * p[:, 3:4]
    return p[:, 0]


def _moment_tile(tgt, src, kind, mode, kahan, eps2, fold=True, fast=False,
                 nb=0, start=None, tm=TM, tn=TN, splits=None):
    """The moment sums of ``tgt`` (4, nt) against ``src`` (5, ns) through
    ``moment_tile_kernel`` and its finalisation: (nt, 3) for acc, (nt,)
    for pot.  The forms: ``_check_moment_form``.  The caller centres the
    coordinates.  ``splits`` forces S (default: ``split_count`` on a
    card, 1 on the CPU)."""
    validate_kernel(kind)
    _check_operands(tgt, src, start, nb, tm, tn)
    _check_moment_form(kind, mode, fold, fast, nb)
    splits = _splits("direct", tgt, src, nb, tn, splits)
    if not tgt.is_cuda:
        return _moment_tile_reference(tgt, src, kind, mode, kahan, eps2,
                                      fold, fast, nb, start, tm, tn, splits)
    from . import _build

    nt, ns = tgt.shape[1], src.shape[1]
    out = torch.empty((nt, 3) if mode == "acc" else (nt,),
                      dtype=torch.float32, device=tgt.device)
    part = torch.empty((2, splits, nt * (4 if mode == "acc" else 1)),
                       dtype=torch.float32, device=tgt.device)
    with torch.cuda.device(tgt.device):
        rc = _kernel_lib().nbody_moment(
            _MODES[mode], int(kahan), int(fold), int(fast), int(nb),
            tgt.data_ptr(), nt, src.data_ptr(), ns,
            None if start is None else start.data_ptr(), tm, tn,
            float(eps2), splits, part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "moment_tile_kernel")
    LAUNCHES["fast" if fast else ("moment" if nb else "moment_2set")] += 1
    return out


def _rsqrt_pair(x):
    """IEEE ``rsqrtf`` and the kernels' ``rsqrt_ftz`` of float32 ``x`` on
    the card (``rsqrt_pair_kernel``), for the check that they agree on
    normal arguments; not on the force path and not counted."""
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 CUDA tensor")
    from . import _build

    ieee, ftz = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _kernel_lib().nbody_rsqrt_pair(
            x.data_ptr(), x.numel(), ieee.data_ptr(), ftz.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "rsqrt_pair_kernel")
    return ieee, ftz


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

def _direct(pos_t, soft_t, pos_s, gmass_s, soft_s, kind, kahan, mode, eps2,
            tm=TM, tn=TN, mask_self=False, skip_band=0, band_start=None):
    """Targets against sources (the TPU's ``_pallas_direct``)."""
    tgt = _targets(pos_t, _soft_pre(kind, soft_t))
    src = _sources(pos_s, gmass_s, _soft_pre(kind, soft_s), tn)
    if band_start is not None:
        band_start = band_start.to(torch.int32).contiguous()
    return _direct_tile(tgt, src, kind, mode, kahan, eps2, mask_self,
                        skip_band, band_start, tm, tn)


def _pad_edge(x, n):
    """Pad a 1-D tensor to length n by repeating its last value."""
    return torch.cat([x, x[-1:].expand(n - x.shape[0])])


def band_window(x, h_max, tm=TM, tn=TN):
    """The band windows of x-sorted particles.

    Returns ``(first, max_width, rows)``: per target tile of ``tm`` the
    first source row (of ``tn``) that is not provably far (a row is far
    when its whole x-span lies more than ``h_max`` outside the tile's),
    the widest [first, last] window over all tiles (a 0-dim tensor), and
    the number of source rows.  The window covers every near row for any
    order, so a stale order only widens it."""
    nt = x.shape[0]
    nt_pad = -(-nt // tm) * tm
    ns_pad = -(-nt // tn) * tn
    rows = ns_pad // tn
    # window stats pad with the edge value (sources pad with zeros)
    x_t = _pad_edge(x, nt_pad).reshape(nt_pad // tm, tm)
    x_s = _pad_edge(x, ns_pad).reshape(rows, tn)
    t_lo, t_hi = x_t.amin(1), x_t.amax(1)
    s_lo, s_hi = x_s.amin(1), x_s.amax(1)
    far = ((s_hi[None, :] < (t_lo - h_max)[:, None])
           | (s_lo[None, :] > (t_hi + h_max)[:, None]))
    ridx = torch.arange(rows, dtype=torch.int32, device=x.device)[None, :]
    first = torch.where(far, rows, ridx).amin(1)
    last = torch.where(far, -1, ridx).amax(1)
    return first, (last - first + 1).amax(), rows


def band_rows(rows):
    """The static band width in source rows (~6% of rows, floor 12)."""
    return min(max(12, rows // 16), rows)


def _self_sorted(pos, gmass, soft, kind, kahan, mode, eps2, tm=None,
                 tn=None, order=None, mxu=None, fast=False, fold_mass=True):
    """Self-gravity via slab sort + the compact-support two-pass split
    (the TPU's ``_pallas_self_sorted``).

    ``order`` may be any permutation (a stale slab order included): the
    band windows are recomputed from the actual positions on every call,
    so a bad order only widens them until the single-pass fallback takes
    over.  With ``order=None`` (every solver call) the order is taken
    here from ``pos``, in a ``dispatch.sort`` span: a stale one would
    cost more than the argsort, since at the N = 65,536 bench case an
    order ~10 steps old already forces the fallback, and at the MW + LMC
    satellite's 1M an order one drift old does (PERF.md).

    The base pass: with ``mxu`` (acc) kernel M, folded or not
    (``fold_mass``); with ``fast`` kernel F (acc and pot), which needs the
    moment form (``mxu=False`` raises).  ``mxu=None`` is the VPU form
    unless ``fast`` (the TPU's default is its matrix unit: ROADMAP Queue
    3).  The potential's ``mxu`` row sum without ``fast`` runs on the VPU
    form: each thread of ``direct_tile_kernel``'s potential form sums its
    own targets' rows, so the tensor cores have no reduction to take over
    (the TPU measured its row sum bitwise equal to the VPU sum).  The
    single-pass fallback is the VPU spline in every case, as on the TPU."""
    if mode == "pot":
        # the potential is folded in both forms (pallas_direct.py:663-668)
        fold_mass = True
    if mxu is None:
        mxu = fast
    if fast and not mxu:
        raise ValueError(
            "float32_fast builds r^2 on the moment path; tile mxu=False "
            "conflicts with fast=True")
    moment = fast or (mxu and mode == "acc")
    tm = TM if tm is None else tm
    tn = TN if tn is None else tn
    _check_geometry(tm, tn)
    if order is None:
        with span("dispatch.sort"):
            order = slab_sort_key(pos)
    ps, gs, hs = pos[order], gmass[order], soft[order]
    if moment:
        # centre the coordinates (pallas_direct.py:685-695): the moment
        # finalisation subtracts x_t * sum(s) from sum(s * x_s), with an
        # error ~ eps * |x| * sum(s), and F's expanded r^2 cancels as
        # |x|^2 in both modes; the forces and potentials are translation
        # invariant, so the centroid bounds |x| by the system's extent
        ps = ps - ps.mean(0, keepdim=True)
    hinv = _soft_pre("spline", hs)
    mask_self = mode == "pot"
    first, max_width, rows = band_window(ps[:, 0], hs.max(), tm, tn)
    nb = band_rows(rows)
    tgt = _targets(ps, hinv)
    src = _sources(ps, gs, hinv, tn)
    # The TPU path picks the branch on the device (lax.cond); here the
    # comparison is read on the host: one device sync per call.
    with span("dispatch.sync"):
        width = int(max_width)
    BRANCHES["window_rows"] += width
    BRANCHES["band_rows"] += nb
    if width <= nb:
        BRANCHES["two_pass"] += 1
        start = first.clamp(0, rows - nb).to(torch.int32).contiguous()
        if moment:
            # no self mask: the band holds every target's own row
            base = _moment_tile(tgt, src, "newtonian", mode, kahan, eps2,
                                fold_mass, fast, nb=nb, start=start, tm=tm,
                                tn=tn)
        else:
            base = _direct_tile(tgt, src, "newtonian", mode, kahan, eps2,
                                mask_self, nb, start, tm, tn)
        out_s = base + _band(tgt, src, start, mode, kahan, eps2, mask_self,
                             tm, tn, nb)
    else:
        BRANCHES["single_pass"] += 1
        out_s = _direct_tile(tgt, src, "spline", mode, kahan, eps2,
                             mask_self, tm=tm, tn=tn)
    out = torch.empty_like(out_s)
    out[order] = out_s
    return out


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def cuda_accel_2set(pos_t, soft_t, pos_s, gmass_s, soft_s, kind, kahan,
                    eps2=PAIRWISE_EPS2, mxu=False):
    """Accelerations of targets due to sources (G folded into gmass_s).

    ``mxu=True`` takes kernel M's two-set form (the ring's far tiles): the
    Newtonian law on disjoint sets, the caller centring the frame (both
    sets shifted by the same offset) to bound the finalisation's
    cancellation.  Another law raises there: the JAX package's moment form
    takes any law and a self mask, but no path of the port asks for
    either, and a self block's unsoftened close pairs would cancel as
    |x| / |dx| in the finalisation."""
    f32 = torch.float32
    pos_t, soft_t, pos_s = pos_t.to(f32), soft_t.to(f32), pos_s.to(f32)
    gmass_s, soft_s = gmass_s.to(f32), soft_s.to(f32)
    if not mxu:
        return _direct(pos_t, soft_t, pos_s, gmass_s, soft_s, kind, kahan,
                       "acc", float(eps2))
    tgt = _targets(pos_t, _soft_pre(kind, soft_t))
    src = _sources(pos_s, gmass_s, _soft_pre(kind, soft_s), BLOCK)
    return _moment_tile(tgt, src, kind, "acc", kahan, float(eps2))


def cuda_potential_2set(pos_t, soft_t, pos_s, gmass_s, soft_s, kind, kahan,
                        eps2=PAIRWISE_EPS2, mask_self=False, mxu=False):
    """Potential of targets due to sources.  ``mask_self=True`` excludes
    pairs at identical index: use it when targets and sources are the same
    array (an outside subtraction of the self term would cancel
    catastrophically for h = 0 particles).

    ``mxu`` is accepted as the TPU's ``pallas_potential_2set`` accepts it
    and runs the same row sum: phi = S @ G m has no cross-lane reduction
    here, where each thread sums its own targets' rows (``_self_sorted``)."""
    del mxu
    f32 = torch.float32
    return _direct(pos_t.to(f32), soft_t.to(f32), pos_s.to(f32),
                   gmass_s.to(f32), soft_s.to(f32), kind, kahan, "pot",
                   float(eps2), mask_self=mask_self)


def uses_spatial_sort(kind: str, n: int, spatial_sort=None) -> bool:
    """Whether cuda_accel/cuda_potential take the slab-sorted path."""
    if spatial_sort is None:
        return kind == "spline" and n >= SORT_MIN_N
    return bool(spatial_sort) and kind == "spline"


def slab_sort_key(pos):
    """The sort order of the slab-sorted path (stable argsort along x)."""
    return torch.argsort(pos[:, 0], stable=True)


def _warn_tile_ignored(tile, kind, n):
    """The tile overrides only shape the slab-sorted two-pass path; warn
    rather than let a bencher believe they measured a geometry or a
    moment form the single-pass kernel never ran (the TPU's
    ``_warn_tile_ignored``)."""
    given = sorted(k for k, v in tile.items() if v is not None)
    if given:
        from ..species import PerformanceWarning

        warnings.warn(
            f"tile overrides {given} apply only to the slab-sorted spline "
            f"path (kernel='spline', N >= {SORT_MIN_N}); ignored for "
            f"kernel={kind!r}, N={n:,}", PerformanceWarning, stacklevel=4)


_TILE_KEYS = ("tm", "tn", "max_sub", "mxu", "fold_mass")


def _self_gravity(mode, pos, mass, soft, G, kind, kahan, eps2, spatial_sort,
                  order, tm, tn, fast, tile):
    validate_kernel(kind)
    tile = dict(tile or {})
    bad = set(tile) - set(_TILE_KEYS)
    if bad:
        raise ValueError(f"unknown tile keys: {sorted(bad)}")
    for key, val in (("tm", tm), ("tn", tn)):
        if val is not None:
            tile[key] = val
    f32 = torch.float32
    gmass = (mass * G).to(f32)
    soft = soft.to(f32)
    pos = pos.to(f32)
    if uses_spatial_sort(kind, pos.shape[0], spatial_sort):
        # max_sub (the TPU's VMEM superblock) shapes nothing here
        tile.pop("max_sub", None)
        return _self_sorted(pos, gmass, soft, kind, kahan, mode, float(eps2),
                            order=order, fast=fast, **tile)
    _warn_tile_ignored(tile, kind, pos.shape[0])
    if mode == "acc":
        return cuda_accel_2set(pos, soft, pos, gmass, soft, kind, kahan,
                               eps2)
    return cuda_potential_2set(pos, soft, pos, gmass, soft, kind, kahan,
                               eps2, mask_self=True)


def cuda_accel(pos, mass, soft, G, kind, kahan, eps2=PAIRWISE_EPS2,
               spatial_sort=None, order=None, tm=None, tn=None, fast=False,
               tile=None):
    """(N, 3) float32 self-gravity accelerations.

    ``spatial_sort`` (default: on for the spline at N >= 16384) selects
    the slab-sorted two-pass path; ``order`` optionally supplies a
    precomputed (possibly stale) slab order; ``tm``/``tn`` override its
    band geometry.  ``fast`` (the ``float32_fast`` tier) takes kernel F
    as the base pass, only meaningful on the sorted path.  ``tile``: a
    dict of ``tm``, ``tn``, ``max_sub`` (no meaning here), ``mxu``
    (kernel M as the base pass) and ``fold_mass`` (False keeps G m in the
    pair factor, the ``target_drift`` tier), as the TPU's
    ``pallas_accel``; off the sorted path a given key warns."""
    return _self_gravity("acc", pos, mass, soft, G, kind, kahan, eps2,
                         spatial_sort, order, tm, tn, fast, tile)


def cuda_potential(pos, mass, soft, G, kind, kahan, eps2=PAIRWISE_EPS2,
                   spatial_sort=None, order=None, tm=None, tn=None,
                   fast=False, tile=None):
    """(N,) float32 self-gravity potential (self pair masked in-kernel).
    ``fast`` and ``tile``: see :func:`cuda_accel`."""
    return _self_gravity("pot", pos, mass, soft, G, kind, kahan, eps2,
                         spatial_sort, order, tm, tn, fast, tile)
