"""Ring-sharded direct summation over a list of devices.

Counterpart of ``nbody_streams_tpu/parallel/sharded.py``: *exact*
O(N^2/D) direct summation, the particles split into D equal blocks (one a
shard), the source blocks passed round a ring.

Algorithm (the systolic ring of the JAX package, driven from one process):

1. The particle axis, padded to whole shards, is cut into D blocks of
   ``n_local`` rows; shard k owns block k's targets (positions,
   G-premultiplied masses, softenings), each on its own device.  A device
   may appear more than once in the list: such *virtual shards* run every
   part of the ring on one device (the counterpart of
   ``--xla_force_host_platform_device_count``).
2. At ring step r shard k holds source block (k - r) mod D.  The copy of
   that block to shard k + 1 is issued before shard k's tile, so on the
   card it overlaps the tile; D - 1 steps copy, the last does not.
3. Partial sums are added with two-sum (Kahan) compensation across steps
   (``ops.pairwise.kahan_add``), as the one-device Kahan path adds tiles.

Tiles: in float32 with ``use_kernels`` the hand-written two-set kernel
(``ops.cuda_direct._direct_tile``, the operands of ``cuda_accel_2set`` /
``cuda_potential_2set`` packed once a shard and evaluation); for the
spline, a block whose x-interval lies farther than max(h) from the local
targets' takes the Newtonian law (every pair there has r > h), and the
potential masks the self pair in-kernel on step r = 0, where the local row
indices align.  With ``mxu=True`` the far blocks of a spline ring take
kernel M's two-set moment form (``ops.cuda_direct._moment_tile``) on a
frame centred on the real particles' centroid; the near blocks keep the
s*dx form, whose close pairs are exact, and the potential's tiles the row
sum they have (the JAX package's ``mxu`` there is the same sum).
Otherwise (float64, or ``use_kernels=False``) the blocked plain tile with
global indices (``_tile_blocked``).

On the card every shard has a compute stream, a receive stream and, for a
copy between two distinct cards, a send stream; events order them and
every tensor read on a stream other than its own is recorded there
(``record_stream``).  The copy is made even between two shards on one
device.  The state lives on the first device: each evaluation scatters the
positions to the shards and gathers the result back.
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..constants import KERNEL_IDS
from ..ops import cuda_direct, pairwise

__all__ = ["ShardedDirect", "make_particle_mesh", "slab_sort_for_sharding",
           "AXIS", "TILES"]

AXIS = "shards"

#: Ring tiles run, by the softening law each ran (plain ints): for the
#: spline on the kernel route, ``newtonian`` counts the far blocks.
TILES = {kind: 0 for kind in KERNEL_IDS}


def make_particle_mesh(devices=None) -> tuple:
    """The ring's shards as a tuple of ``torch.device``: ``devices`` (a
    device may repeat: virtual shards) or, by default, every visible card.
    Without a card the default raises: the CPU ring is asked for with
    ``devices=['cpu'] * k``."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_particle_mesh() spans every visible card and torch "
                "sees no CUDA device; pass devices=['cpu'] * k for k "
                "virtual shards on the CPU")
        return tuple(torch.device("cuda", i) for i in range(count))
    mesh = tuple(resolve_device(d, indexed=True) for d in devices)
    if not mesh:
        raise ValueError("devices must name at least one device")
    if len({d.type for d in mesh}) != 1:
        raise ValueError(f"devices mixes device types: {mesh}")
    return mesh


def _tile_blocked(mode, kind, kahan, block, eps2,
                  pos_t, h_t, idx_t, pos_s, m_s, h_s, idx_s):
    """Blocked plain tile: targets (Nt) x sources (Ns), ``mode`` 'acc'
    ((Nt, 3)) or 'pot' ((Nt,)); sources padded to whole blocks with zero
    mass and index -1, Kahan (optional) across blocks."""
    ns = pos_s.shape[0]
    pad = -(-ns // block) * block - ns
    pos_s, m_s, h_s = (F.pad(pos_s, (0, 0, 0, pad)), F.pad(m_s, (0, pad)),
                       F.pad(h_s, (0, pad)))
    idx_s = F.pad(idx_s, (0, pad), value=-1)
    tile_fn = (pairwise.accel_tile if mode == "acc"
               else pairwise.potential_tile)
    total = torch.zeros_like(pos_t if mode == "acc" else pos_t[:, 0])
    comp = torch.zeros_like(total)
    for s0 in range(0, ns + pad, block):
        sl = slice(s0, s0 + block)
        part = tile_fn(kind, pos_t, h_t, idx_t, pos_s[sl], m_s[sl], h_s[sl],
                       idx_s[sl], eps2=eps2)
        if kahan:
            total, comp = pairwise.kahan_add(total, comp, part)
        else:
            total = total + part
    return total


class _Streams:
    """One shard's streams on the card: ``compute`` runs its tiles,
    ``recv`` takes the incoming block, ``send`` carries a copy to a shard
    on another card (a cross-device copy runs on the sender's stream)."""

    def __init__(self, device):
        self.compute = torch.cuda.Stream(device=device)
        self.recv = torch.cuda.Stream(device=device)
        self.send = torch.cuda.Stream(device=device)


class ShardedDirect:
    """Ring-sharded direct summation bound to a ``DirectGravity`` solver.

    ``use_kernels`` (the JAX package's ``use_pallas``): None takes the CUDA
    kernels when the shards are on the card and the solver is float32,
    the plain tile otherwise; float64 always takes the plain tile.  On CPU
    shards ``use_kernels=True`` runs the kernels' plain versions (the
    wrappers do so for CPU tensors): the kernel route's ring on the CPU.
    ``mxu=True`` (the TPU's matrix-unit moment form) takes kernel M for the
    far blocks of a spline ring on the kernel route; None (the default
    here, where the TPU defaults to True) and False keep the VPU form.  The
    shards are the solver's ``devices``."""

    def __init__(self, solver, use_kernels: bool | None = None,
                 mxu: bool | None = None):
        self.solver = solver
        self.mesh = make_particle_mesh(solver.devices)
        self.n_dev = d = len(self.mesh)
        if self._card and len(set(self.mesh)) > 1:
            cards = sorted({str(dev) for dev in self.mesh})
            warnings.warn(
                f"the ring spans distinct cards {cards}: a copy between two "
                "cards has not yet been checked against the one-card path "
                "(virtual shards of one card have)", stacklevel=3)
        n = solver.n
        self.npad = -(-n // d) * d
        self.n_local = nl = self.npad // d

        pad = self.npad - n
        gm = F.pad(solver.mass * solver.G, (0, pad)).to(solver.dtype)
        h = F.pad(solver.softening, (0, pad)).to(solver.dtype)
        self.gmass = [gm[k * nl:(k + 1) * nl].to(dev).contiguous()
                      for k, dev in enumerate(self.mesh)]
        self.soft = [h[k * nl:(k + 1) * nl].to(dev).contiguous()
                     for k, dev in enumerate(self.mesh)]
        # each shard's widest softening, float32 as the far test compares
        self.h_max = h.reshape(d, nl).amax(1).to(torch.float32).cpu().numpy()
        if use_kernels is None:
            use_kernels = self._card
        self.use_kernels = bool(use_kernels) \
            and solver.dtype == torch.float32
        self.mxu = bool(mxu) and self.use_kernels
        if self.use_kernels:
            # per-shard softening operand of the kernels (static)
            self._pre = [cuda_direct._soft_pre(solver.kernel, s)
                         for s in self.soft]
        self._streams = ([_Streams(dev) for dev in self.mesh] if self._card
                         else None)

    # -- placement ------------------------------------------------------------
    @property
    def _card(self) -> bool:
        return self.mesh[0].type == "cuda"

    def _on(self, k):
        """Shard k's device and compute stream (nothing on the CPU)."""
        if not self._card:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.mesh[k]))
        stack.enter_context(torch.cuda.stream(self._streams[k].compute))
        return stack

    def _copy_block(self, block, k, j, ready):
        """A copy of shard k's ``block`` on shard j's device, made after
        ``ready`` (the event of the block's last write; None on the CPU).
        Returns the copy and the event of its arrival."""
        if not self._card:
            return block.to(self.mesh[j], copy=True), None
        st_j = self._streams[j]
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.cuda.device(self.mesh[j]))
            stack.enter_context(torch.cuda.stream(st_j.recv))
            st_j.recv.wait_event(ready)
            out = torch.empty_like(block, device=self.mesh[j])
            reader = st_j.recv
            if self.mesh[k] != self.mesh[j]:
                # a cross-device copy runs on the sender's current stream,
                # fenced both ways against the receiver's
                reader = self._streams[k].send
                stack.enter_context(torch.cuda.stream(reader))
            out.copy_(block)
        block.record_stream(reader)
        out.record_stream(st_j.compute)
        arrived = torch.cuda.Event()
        arrived.record(st_j.recv)
        return out, arrived

    # -- ring -----------------------------------------------------------------
    def _far(self, posp):
        """(D, D) bool, target shard x source shard: the blocks' x-intervals
        lie farther apart than the larger of their max(h).  One reduction
        over the state and one host read an evaluation; compared in float32
        as the JAX package's device test.  Decides speed only: a far pair
        is exactly Newtonian under the spline."""
        x = posp[:, 0].reshape(self.n_dev, self.n_local)
        lo, hi = torch.stack([x.amin(1), x.amax(1)]).to(
            torch.float32).cpu().numpy()
        gap = np.maximum(lo[:, None] - hi[None, :], lo[None, :] - hi[:, None])
        return gap > np.maximum(self.h_max[:, None], self.h_max[None, :])

    def _pack(self, k, pos_k):
        """Shard k's targets and its source block for the tiles."""
        if self.use_kernels:
            pre = self._pre[k]
            return (cuda_direct._targets(pos_k, pre),
                    cuda_direct._sources(pos_k, self.gmass[k], pre,
                                         cuda_direct.BLOCK))
        nl = self.n_local
        idx = torch.arange(k * nl, (k + 1) * nl, dtype=torch.int64,
                           device=pos_k.device)
        block = torch.cat([pos_k, self.gmass[k][:, None],
                           self.soft[k][:, None]], 1)
        return (pos_k, self.soft[k], idx), block

    def _tile(self, mode, k, r, tgt, block, far):
        solver = self.solver
        kind, kahan, eps2 = solver.kernel, solver.kahan, solver.eps2
        if self.use_kernels:
            law = kind
            if mode == "acc" and far is not None and far[k, (k - r)
                                                         % self.n_dev]:
                law = "newtonian"
            TILES[law] += 1
            if law != kind and self.mxu:
                # a far block: the moment form, on the centred frame
                return cuda_direct._moment_tile(tgt, block, law, mode,
                                                kahan, eps2)
            return cuda_direct._direct_tile(
                tgt, block, law, mode, kahan, eps2,
                mask_self=(mode == "pot" and r == 0))
        nl = self.n_local
        s = (k - r) % self.n_dev
        idx_s = torch.arange(s * nl, (s + 1) * nl, dtype=torch.int64,
                             device=block.device)
        TILES[kind] += 1
        pos_t, h_t, idx_t = tgt
        return _tile_blocked(mode, kind, kahan, min(1024, nl), eps2,
                             pos_t, h_t, idx_t, block[:, :3], block[:, 3],
                             block[:, 4], idx_s)

    def _ring(self, mode, posp):
        d, nl, card = self.n_dev, self.n_local, self._card
        far = None
        if (self.use_kernels and mode == "acc"
                and self.solver.kernel == "spline"):
            far = self._far(posp)
        main = torch.cuda.current_stream(posp.device) if card else None
        streams = self._streams
        tgts, blocks, ready, totals, comps = [], [], [], [], []
        for k, dev in enumerate(self.mesh):
            with self._on(k):
                if card:
                    streams[k].compute.wait_stream(main)
                pos_k = posp[k * nl:(k + 1) * nl].to(dev)
                if card and pos_k.device == posp.device:
                    posp.record_stream(streams[k].compute)
                tgt, block = self._pack(k, pos_k)
                zero = torch.zeros(
                    (nl, 3) if mode == "acc" else (nl,), dtype=posp.dtype,
                    device=dev)
                tgts.append(tgt)
                blocks.append(block)
                totals.append(zero)
                comps.append(torch.zeros_like(zero))
                if card:
                    ev = torch.cuda.Event()
                    ev.record(streams[k].compute)
                    ready.append(ev)
                else:
                    ready.append(None)
        for r in range(d):
            if r < d - 1:
                # issue the next step's copies before this step's tiles
                nxt = [None] * d
                nxt_ready = [None] * d
                for k in range(d):
                    j = (k + 1) % d
                    nxt[j], nxt_ready[j] = self._copy_block(
                        blocks[k], k, j, ready[k])
            for k in range(d):
                with self._on(k):
                    if card:
                        streams[k].compute.wait_event(ready[k])
                    part = self._tile(mode, k, r, tgts[k], blocks[k], far)
                    totals[k], comps[k] = pairwise.kahan_add(
                        totals[k], comps[k], part)
            if r < d - 1:
                blocks, ready = nxt, nxt_ready
        outs = []
        for k in range(d):
            if card:
                main.wait_stream(streams[k].compute)
                totals[k].record_stream(main)
            outs.append(totals[k].to(posp.device))
        return torch.cat(outs)

    # -- public ---------------------------------------------------------------
    def _sharded_eval(self, mode, pos):
        n = self.solver.n
        pos = pos.to(device=self.mesh[0], dtype=self.solver.dtype)
        if mode == "acc" and self.mxu and self.solver.kernel == "spline":
            # the moment form's frame (the JAX package's sharded.py:250-256):
            # the forces are translation invariant, and the shift bounds
            # the finalisation's cancellation by the system's extent
            pos = pos - pos.mean(0, keepdim=True)
        # ghost rows up to whole shards: the last row repeated, at the zero
        # mass __init__ padded, so that the last shard's x-interval (and
        # the far test) is that of its real rows
        posp = torch.cat([pos, pos[-1:].expand(self.npad - n, 3)])
        return self._ring(mode, posp)[:n]

    def accel(self, pos):
        return self._sharded_eval("acc", pos)

    def potential(self, pos):
        return self._sharded_eval("pot", pos)


def slab_sort_for_sharding(phase_space, *arrays):
    """Order particles by x so block-sharding hands each device a thin
    slab.  With slab shards, all non-adjacent ring blocks are farther
    than max(h) from the local targets and take the compact-support
    Newtonian fast path (see ShardedDirect._tile) — on a D-device mesh
    that is ~(D-2)/D of the ring steps at ~16 ops/pair instead of ~29.

    Returns (phase_space[order], *arrays[order]).  Purely a performance
    transform: results are exact in any order.
    """
    phase_space = np.asarray(phase_space)
    order = np.argsort(phase_space[:, 0], kind="stable")
    return (phase_space[order],
            *(np.asarray(a)[order] for a in arrays))
