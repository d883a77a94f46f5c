"""The potential forms of the direct kernels, on the CPU: their plain
versions against the JAX package's Pallas path (interpret mode), the
invariant the kernels' self mask relies on, init_state's default device,
and the SASS reader's list of kernels.

On the CPU the wrappers run the plain versions; tests/test_torch_cuda.py
holds the kernels against them on a card.  Inputs are made with numpy from
a seed.  Tolerance: 1e-6 * max between the port and the JAX package (fp32
sums in another order), as in tests/test_torch_direct.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_streams_tpu.ops import pallas_direct as jpd
from nbody_streams_tpu_torch import integrate as ti
from nbody_streams_tpu_torch.benchmarks import sass
from nbody_streams_tpu_torch.ops import cuda_direct as cd
from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

torch.set_num_threads(2)

KINDS = ["newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline"]
TOL = 1e-6
G = 4.3e-6


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _sources(n, seed, zero_h=0):
    """n sources in a unit Gaussian; the first ``zero_h`` have h = 0."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 1, (n, 3)).astype(np.float32)
    gm = (rng.uniform(0.5, 2.0, n) * 1e5 * G).astype(np.float32)
    soft = rng.uniform(0.05, 0.3, n).astype(np.float32)
    soft[:zero_h] = 0.0
    return pos, gm, soft


# ---------------------------------------------------------------------------
# the self mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", [1, 3, 7])
def test_self_mask_lies_only_on_the_diagonal_tile(monkeypatch, splits):
    """The kernels test j == i only on a block's diagonal tile, i // BLOCK.
    The plain versions test every pair.  Masking only that tile gives the
    same bits at N = 1,000 (ragged) for any S, and finds every target's
    self pair there; h = 0 particles make a missed pair -G m / sqrt(eps2),
    so a miss would show."""
    n = 1000
    pos, gm, soft = _sources(n, 3, zero_h=100)
    pair_sum = cd._pair_sum
    rows = torch.arange(n)[:, None]
    lane = torch.arange(cd.BLOCK)[None, :]

    def masked_on(tile_of_call):
        """_pair_sum with the mask of the call's tile kept only on rows
        whose diagonal tile it is; counts the pairs masked."""
        found = []

        def diagonal_only(*args, self_pair=None):
            if self_pair is not None:
                j0 = tile_of_call(len(found))
                self_pair = (rows // cd.BLOCK == j0 // cd.BLOCK) & (
                    lane == rows - j0)
                found.append(int(self_pair.sum()))
            return pair_sum(*args, self_pair=self_pair)
        return diagonal_only, found

    for kind in ("plummer", "spline"):
        pre = cd._soft_pre(kind, torch.tensor(soft))
        tgt = cd._targets(torch.tensor(pos), pre)
        src = cd._sources(torch.tensor(pos), torch.tensor(gm), pre, cd.TN)
        every = cd._direct_tile_reference(tgt, src, kind, "pot", True, 1e-15,
                                          True, splits=splits)
        # the single pass walks the tiles in order: call c is tile c
        fn, found = masked_on(lambda c: c * cd.BLOCK)
        monkeypatch.setattr(cd, "_pair_sum", fn)
        diag = cd._direct_tile_reference(tgt, src, kind, "pot", True, 1e-15,
                                         True, splits=splits)
        monkeypatch.undo()
        assert torch.isfinite(diag).all()
        assert torch.equal(diag, every), kind
        assert sum(found) == n and len(found) == src.shape[1] // cd.BLOCK

    # the band pass: band row b of each target tile, BLOCK sources a call
    tm = tn = 128
    nb = 3
    start = torch.tensor(np.random.default_rng(8).integers(
        0, src.shape[1] // tn - nb + 1, -(-n // tm)), dtype=torch.int32)
    every = cd._band_reference(tgt, src, start, "pot", True, 1e-15, True, tm,
                               tn, nb, splits=min(splits, nb))
    # _band_reference gathers a whole band row of tn a call: the mask of
    # row b is kept where the target's own index lies in that row
    found = []

    def band_diagonal(*args, self_pair=None):
        b = len(found)
        j = (start.long()[rows[:, 0] // tm] + b)[:, None] * tn + torch.arange(
            tn)[None, :]
        diag_tile = (j // cd.BLOCK == rows // cd.BLOCK)
        self_pair = diag_tile & (j == rows)
        found.append(int(self_pair.sum()))
        return pair_sum(*args, self_pair=self_pair)

    monkeypatch.setattr(cd, "_pair_sum", band_diagonal)
    diag = cd._band_reference(tgt, src, start, "pot", True, 1e-15, True, tm,
                              tn, nb, splits=min(splits, nb))
    monkeypatch.undo()
    assert torch.equal(diag, every)
    # every target whose own row is in its tile's band finds its pair
    own = ((torch.arange(n) // tn >= start.long()[torch.arange(n) // tm])
           & (torch.arange(n) // tn < start.long()[torch.arange(n) // tm]
              + nb))
    assert sum(found) == int(own.sum()) > 0


# ---------------------------------------------------------------------------
# the two-set potential against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("nt,ns", [(700, 900), (900, 520)])
def test_potential_2set_matches_pallas(kind, mask, nt, ns):
    """cuda_potential_2set (its plain version here) against
    pallas_potential_2set in interpret mode, targets and sources sharing
    their first min(nt, ns) particles (so the mask has pairs to drop),
    nt != ns and nt not a multiple of 64."""
    pos, gm, soft = _sources(max(nt, ns), 4)
    pt, ht = pos[:nt], soft[:nt]
    ps, gs, hs = pos[:ns], gm[:ns], soft[:ns]
    want = jpd.pallas_potential_2set(
        *(jnp.asarray(a) for a in (pt, ht, ps, gs, hs)), kind, True,
        eps2=1e-15, interpret=True, mask_self=mask)
    got = cd.cuda_potential_2set(
        *(torch.tensor(a) for a in (pt, ht, ps, gs, hs)), kind, True,
        eps2=1e-15, mask_self=mask)
    assert got.shape == (nt,) and got.dtype == torch.float32
    assert _rel(got, want) < TOL


# ---------------------------------------------------------------------------
# init_state's default device
# ---------------------------------------------------------------------------

def _accel(n):
    solver = DirectGravity(np.full(n, 1.0), 0.05, impl="torch", device="cpu")
    return ti.make_accel_fn(solver, solver.mass), solver.mass


def test_init_state_default_is_the_card():
    """With no device= a state of numpy input is built on the card: without
    one it raises, naming the CPU option."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    accel_fn, mass = _accel(32)
    pos = np.random.default_rng(1).normal(size=(32, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ti.init_state(pos, pos, accel_fn, mass, 0.0)
    state = ti.init_state(pos, pos, accel_fn, mass, 0.0, device="cpu")
    assert state.pos.device.type == "cpu"


def test_init_state_keeps_a_tensor_device():
    accel_fn, mass = _accel(32)
    pos = torch.randn(32, 3, dtype=torch.float64)
    state = ti.init_state(pos, pos.numpy(), accel_fn, mass, 0.0)
    assert state.pos.device.type == "cpu" and state.acc.device.type == "cpu"
    assert state.pos.dtype == torch.float32


# ---------------------------------------------------------------------------
# the SASS reader's kernels
# ---------------------------------------------------------------------------

# template arguments as the compiler mangles them (direct_math.cuh's Kind
# and Mode, the Kahan and skip flags)
_MANGLED = {"NEWTONIAN": "Li0E", "PLUMMER": "Li1E", "DEHNEN_K1": "Li2E",
            "DEHNEN_K2": "Li3E", "SPLINE": "Li4E", "ACC": "Li0E",
            "POT": "Li1E", "Kahan": "Lb1E", "skip": "Lb1E"}


def _fragment(label):
    """The mangled-name fragment of a KERNELS label."""
    name, _, rest = label.partition("<")
    args = rest.split(">")[0].split(",")
    frag = "".join(_MANGLED[a] for a in args)
    if name == "direct_tile_kernel" and "skip" not in args:
        frag += "Lb0E"
    return f"{name}I{frag}"


def _function(fragment, loops):
    """A function of a cuobjdump -sass listing with one backward-branch
    loop per entry of ``loops`` (opcode lists), each at its own label."""
    lines = [f"\t\tFunction : _ZN12_GLOBAL__N_1{len(fragment)}{fragment}"
             "EEvPKf"]
    addr = 0
    for n, body in enumerate(loops):
        lines.append(f".L_x_{n}:")
        for op in body + [f"@P0 BRA `(.L_x_{n})"]:
            lines.append(f"        /*{addr:04x}*/                   {op} ;")
            addr += 16
    return "\n".join(lines)


def test_sass_reader_reads_every_kernel_and_the_unmasked_loop():
    """Every KERNELS label names the template arguments its fragment
    mangles, the potential forms are read, and in a kernel with a masked
    and an unmasked loop the reader takes the unmasked one (the shorter:
    the diagonal tile's loop adds the compare and the select)."""
    for label, fragment in sass.KERNELS.items():
        assert _fragment(label) == fragment, label
    assert {"direct_tile_kernel<PLUMMER,POT,Kahan> (two-set, fit)",
            "direct_tile_kernel<SPLINE,POT,Kahan> (single pass)",
            "direct_tile_kernel<NEWTONIAN,POT,Kahan,skip> (base pass)",
            "band_kernel<POT,Kahan> (band pass)"} <= set(sass.KERNELS)
    pair = ["FADD R1, R2, -R3", "FFMA R4, R1, R1, R5", "FMNMX R6, R7, R8",
            "FADD R9, R4, R6", "MUFU.RSQ R10, R9", "FFMA R11, -R12, R10, R11"]
    masked = pair[:-1] + ["ISETP.NE.AND P1, PT, R13, R14, PT",
                          "FSEL R10, R10, RZ, P1", pair[-1]]
    text = "\n".join(
        _function(f, [masked * 2, pair * 2] if "Li1E" in f else [pair])
        for f in sass.KERNELS.values())
    prof = sass.profile(text, "")
    assert set(prof) == set(sass.KERNELS)
    fit = prof["direct_tile_kernel<PLUMMER,POT,Kahan> (two-set, fit)"]
    assert fit["pairs_per_trip"] == 2 and fit["slots_per_pair"] == 6.5
    assert "FSEL" not in fit["per_pair"] and "ISETP" not in fit["per_pair"]
