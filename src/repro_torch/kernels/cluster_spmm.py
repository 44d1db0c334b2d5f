"""Cluster-wise SpMM on the card: C = A_bcc @ B with B dense (tall-skinny).

Two forms of A, two kernels in ``csrc/cluster_spmm.cu``, each giving a
(row block, column strip) to one CTA that writes its strip once:

* :func:`cluster_spmm_compact` (the counterpart of the JAX package's
  ``cluster_spmm_compact``) takes BCC's compact (block, tile) stream —
  ``block_ids`` non-decreasing, ``tile_ids`` the k-tile each slab
  multiplies, empty blocks carrying one zero slab and the tail padded with
  zero slabs — and walks each slab's live columns
  (:class:`~repro_torch.kernels.columns.SlabColumns`): one read of B's row
  per live column, applied to the 8 rows of the block. The JAX kernel
  multiplies whole slabs, so a non-finite B value in a slab's dead column
  (all 8 values zero) makes the block's output NaN there (0 * inf); the
  walk finds those by counting the non-finite values of each k-tile of B
  and those its live columns meet, and gives the same NaN;
* :func:`cluster_spmm` (the counterpart of ``cluster_spmm``) takes BCC's
  padded lattice as it is: ``tiles_per_block`` slabs per block, the pad
  slabs zero and pointing at tile 0, all of them summed as dense slabs.
  Its kernel runs panels of blocks that name the same B tiles slot by
  slot (:func:`spmm_panels`, built once per weight), staging each B tile
  once for the whole panel.

A's values are fp32; B is fp32, bf16 or fp16, and C comes back in B's
dtype. With a 16-bit B each stream or lattice step's product is formed in
fp32, rounded to B's dtype and added to the running C in B's dtype, in step
order, as the JAX kernels' ``o += dot(...).astype(o.dtype)`` does.

Each wrapper, on a CUDA tensor, launches the kernel (counting the launch in
its ``launches`` attribute) or raises; on a CPU tensor it runs its plain
version (:func:`cluster_spmm_compact_plain`, over the same live columns;
:func:`cluster_spmm_plain`, the padded sums with ``torch.bmm``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.columns import SlabColumns, columns_for

__all__ = ["cluster_spmm", "cluster_spmm_plain", "cluster_spmm_compact",
           "cluster_spmm_compact_plain", "SpmmPanels", "spmm_panels"]

KERNEL_BLOCK_R = 8
KERNEL_MAX_BN = 128
# row blocks of a panel: the panel kernel's warps, one block each
KERNEL_PANEL_BLOCKS = 8
# B's dtypes and their codes at the kernels' C interface
B_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_dtypes(a_values, b):
    if a_values.dtype != torch.float32 or b.dtype not in B_DTYPES:
        raise ValueError(f"a_values must be float32 and b float32, bfloat16 "
                         f"or float16, got {a_values.dtype} and {b.dtype}")


def _operands(block_ids, tile_ids, a_values, b, *, block_r, block_k):
    dev = a_values.device
    block_ids = torch.as_tensor(block_ids, device=dev).int().contiguous()
    tile_ids = torch.as_tensor(tile_ids, device=dev).int().contiguous()
    if a_values.shape[1:] != (block_r, block_k):
        raise ValueError(f"a_values {tuple(a_values.shape)} is not "
                         f"(S, {block_r}, {block_k})")
    if block_ids.shape[0] != a_values.shape[0] \
            or tile_ids.shape[0] != a_values.shape[0]:
        raise ValueError("block_ids/tile_ids/a_values disagree on S")
    if b.dim() != 2 or b.device != dev:
        raise ValueError(f"b must be a 2-D tensor on {dev}")
    _check_dtypes(a_values, b)
    return block_ids, tile_ids


def cluster_spmm_compact(block_ids, tile_ids, a_values: torch.Tensor,
                         b: torch.Tensor, *, block_r: int, block_k: int,
                         nblocks: int, bn: int = 128,
                         cols: SlabColumns | None = None) -> torch.Tensor:
    """C = A_bcc @ B over the compact stream. ``b`` is ``(K, N)`` fp32,
    bf16 or fp16 (rows past K and the ragged last column strip are
    masked, no padding needed); ``bn`` is the kernel's column-strip width
    (≤ 128); ``cols`` is the slabs' live-column form
    (:func:`slab_columns`, built here when absent — callers that launch
    again keep it). Returns ``(nblocks * block_r, N)`` in B's dtype,
    16-bit sums rounded after every step; blocks with no step in the
    stream are zero.

    CUDA tensors launch the hand-written kernel (and add one to
    ``cluster_spmm_compact.launches``); CPU tensors run the plain version;
    any other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spmm_compact_plain(block_ids, tile_ids, a_values, b,
                                          block_r=block_r, block_k=block_k,
                                          nblocks=nblocks, cols=cols)
    block_ids, tile_ids = _operands(block_ids, tile_ids, a_values, b,
                                    block_r=block_r, block_k=block_k)
    return _launch(block_ids, tile_ids, a_values, b, block_r=block_r,
                   block_k=block_k, nblocks=nblocks, bn=bn, cols=cols)


cluster_spmm_compact.launches = 0


def cluster_spmm_compact_plain(block_ids, tile_ids, a_values: torch.Tensor,
                               b: torch.Tensor, *, block_r: int,
                               block_k: int, nblocks: int,
                               cols: SlabColumns | None = None
                               ) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spmm_compact`, on any
    device, over the same live columns: each live column's ``block_r``
    values times the B row it selects (rows past K read as zero), in
    chunks, ``index_add_``ed in fp32 into the owning block (fp32 B) or
    into the step's own part, whose parts are then rounded to B's dtype
    and added to the block's running output in step order (16-bit B).
    Where B is not finite, a slab whose dead columns meet a non-finite
    value (its tile holds more of them than its live columns meet) makes
    its block's output NaN in that column, as the whole-slab product
    does."""
    block_ids, tile_ids = _operands(block_ids, tile_ids, a_values, b,
                                    block_r=block_r, block_k=block_k)
    cols = columns_for(a_values, cols)
    k, n = b.shape
    dev = b.device
    rounded = b.dtype != torch.float32
    step = torch.repeat_interleave(
        torch.arange(cols.nslabs, device=dev),
        (cols.col_ptr[1:] - cols.col_ptr[:-1]).long())
    rows = tile_ids[step].long() * block_k + cols.col_k.long()
    blocks = block_ids[step].long()
    # a zero row stands in for B's rows past K
    bz = torch.cat([b, b.new_zeros((1, n))]).float()
    rows = torch.where(rows < k, rows, k)
    bad = ~torch.isfinite(bz)
    check = bool(bad.any())
    met = torch.zeros((cols.nslabs, n), dtype=torch.int32, device=dev)
    dead_hit = None
    if check:
        for lo, hi in _column_chunks(cols, block_r, n):
            met.index_add_(0, step[lo:hi], bad[rows[lo:hi]].int())
        ntiles = -(-k // block_k)
        per_tile = F.pad(bad[:k], (0, 0, 0, ntiles * block_k - k)).view(
            ntiles, block_k, n).sum(1, dtype=torch.int32)
        per_tile = torch.cat([per_tile, per_tile.new_zeros((1, n))])
        # tiles past K hold no row of B: none of their values is counted
        tiles = torch.clamp(tile_ids.long(), max=ntiles)
        dead_hit = per_tile[tiles] > met                    # (S, n)
    if rounded:
        c = _rounded_steps(block_ids, cols, step, rows, bz, dead_hit,
                           nblocks=nblocks, block_r=block_r, dtype=b.dtype)
        return c.view(nblocks * block_r, n)
    c = torch.zeros((nblocks, block_r, n), dtype=torch.float32, device=dev)
    for lo, hi in _column_chunks(cols, block_r, n):
        prod = cols.col_vals[lo:hi, :, None] * bz[rows[lo:hi]][:, None, :]
        c.index_add_(0, blocks[lo:hi], prod)
    if dead_hit is not None:
        hit = torch.zeros((nblocks, n), dtype=torch.int32, device=dev)
        hit.index_add_(0, block_ids.long(), dead_hit.int())
        c = torch.where(hit[:, None, :] > 0,
                        torch.full_like(c, float("nan")), c)
    return c.view(nblocks * block_r, n)


def _column_chunks(cols, block_r, n):
    """Ranges of live columns whose products fit 2**26 floats."""
    chunk = max(1, (1 << 26) // (block_r * max(n, 1)))
    return [(lo, min(lo + chunk, cols.ncols))
            for lo in range(0, cols.ncols, chunk)]


def _rounded_steps(block_ids, cols, step, rows, bz, dead_hit, *, nblocks,
                   block_r, dtype):
    """The 16-bit compact product: steps in chunks, each step's fp32
    part over its live columns (NaN where its dead columns meet a
    non-finite value), rounded to ``dtype`` and added to its block's
    running output in ``dtype``, in step order."""
    n = bz.shape[1]
    dev = bz.device
    c = torch.zeros((nblocks, block_r, n), dtype=dtype, device=dev)
    bids = block_ids.long()
    # a step's rank among its block's steps (the stream is block-sorted)
    rank = (torch.arange(bids.numel(), device=dev)
            - torch.searchsorted(bids, bids))
    nsteps = cols.nslabs
    per = max(1, (1 << 26) // (block_r * max(n, 1)))
    ptr = cols.col_ptr.long()
    for s0 in range(0, nsteps, per):
        s1 = min(s0 + per, nsteps)
        c0, c1 = int(ptr[s0]), int(ptr[s1])
        part = torch.zeros((s1 - s0, block_r, n), dtype=torch.float32,
                           device=dev)
        for lo in range(c0, c1, per):
            hi = min(lo + per, c1)
            prod = cols.col_vals[lo:hi, :, None] * bz[rows[lo:hi]][:, None, :]
            part.index_add_(0, step[lo:hi] - s0, prod)
        if dead_hit is not None:
            part = torch.where(dead_hit[s0:s1, None, :],
                               torch.full_like(part, float("nan")), part)
        part = part.to(dtype)
        r = rank[s0:s1]
        for k in torch.unique(r).tolist():
            sel = (r == k).nonzero().flatten()
            blk = bids[s0:s1][sel]
            c[blk] = c[blk] + part[sel]
    return c


def _launch(block_ids, tile_ids, a_values, b, *, block_r, block_k, nblocks,
            bn, cols):
    dev = a_values.device
    if dev.type != "cuda":
        raise ValueError(f"cluster_spmm_compact: tensors on {dev}; the "
                         "kernel runs on CUDA, the plain version on the CPU")
    if block_r != KERNEL_BLOCK_R or not 0 < bn <= KERNEL_MAX_BN:
        raise ValueError(f"kernel takes block_r={KERNEL_BLOCK_R} and "
                         f"0 < bn <= {KERNEL_MAX_BN}, got block_r={block_r}, "
                         f"bn={bn}")
    cols = columns_for(a_values, cols)
    k, n = b.shape
    # zero-filled: a block the stream does not visit reads back zero
    out = torch.zeros((nblocks * block_r, n), dtype=b.dtype, device=dev)
    if nblocks == 0 or n == 0:
        return out
    # each block's segment of the (block-sorted) stream
    blk_ptr = torch.searchsorted(
        block_ids, torch.arange(nblocks + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    b = b.contiguous()
    # the non-finite counts of B's k-tiles, and a flag and a mark per tile
    # (the kernel's library sets them: see csrc/cluster_spmm.cu)
    ntiles = -(-k // block_k)
    scratch = torch.empty(1 + ntiles + ntiles * n, dtype=torch.int32,
                          device=dev)
    counts = scratch[1 + ntiles:]
    lib = _build.load("cluster_spmm")
    fn = lib.cluster_spmm_columns
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(blk_ptr.data_ptr(), tile_ids.data_ptr(), cols.col_ptr.data_ptr(),
            cols.col_k.data_ptr(), cols.col_vals.data_ptr(), b.data_ptr(),
            out.data_ptr(), counts.data_ptr(), scratch.data_ptr(), nblocks,
            a_values.shape[0], block_k, k, n, bn, B_DTYPES[b.dtype], stream)
    if rc != 0:
        lib.cluster_spmm_error_string.restype = ctypes.c_char_p
        lib.cluster_spmm_error_string.argtypes = [ctypes.c_int]
        msg = lib.cluster_spmm_error_string(rc).decode()
        raise RuntimeError(f"cluster_spmm_compact launch failed: {msg}")
    cluster_spmm_compact.launches += 1
    return out


def _padded_operands(tile_ids, a_values, b, *, block_r, block_k,
                     tiles_per_block):
    dev = a_values.device
    tile_ids = torch.as_tensor(tile_ids, device=dev).int().contiguous()
    if a_values.shape[1:] != (block_r, block_k):
        raise ValueError(f"a_values {tuple(a_values.shape)} is not "
                         f"(S, {block_r}, {block_k})")
    if tiles_per_block <= 0 or a_values.shape[0] % tiles_per_block \
            or tile_ids.shape[0] != a_values.shape[0]:
        raise ValueError(f"{a_values.shape[0]} slabs and "
                         f"{tile_ids.shape[0]} tile ids are not nblocks x "
                         f"tiles_per_block={tiles_per_block}")
    if b.dim() != 2 or b.device != dev:
        raise ValueError(f"b must be a 2-D tensor on {dev}")
    _check_dtypes(a_values, b)
    return tile_ids


@dataclasses.dataclass(frozen=True)
class SpmmPanels:
    """The padded lattice's blocks in panels, for the panel kernel.

    Panel ``p`` is blocks ``blocks[panel_ptr[p] .. panel_ptr[p+1]]`` (at
    most :data:`KERNEL_PANEL_BLOCKS`; ``blocks`` is a permutation of the
    lattice's blocks). Its entries at slot ``t`` are
    ``entry_ptr[p * tiles_per_block + t] .. [+1]`` of ``entries``, one per
    distinct tile the panel's blocks name at that slot, ascending: ``(tile,
    slot, mask)``, bit ``w`` of ``mask`` set when the panel's block ``w``
    names the tile there. Entries are ordered by (panel, slot, tile)."""

    blocks: torch.Tensor       # (nblocks,) int32 block of each panel place
    panel_ptr: torch.Tensor    # (npanels+1,) int32
    entry_ptr: torch.Tensor    # (npanels * tiles_per_block + 1,) int32
    entries: torch.Tensor      # (E, 3) int32 tile, slot, block mask
    tiles_per_block: int

    @property
    def nblocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def npanels(self) -> int:
        return int(self.panel_ptr.shape[0]) - 1

    @property
    def nentries(self) -> int:
        return int(self.entries.shape[0])

    @property
    def tiles_per_slot(self) -> float:
        """Mean distinct tiles per (panel, slot): the B sub-tiles a panel
        stages per slot (1 where its blocks agree)."""
        return self.nentries / max(self.npanels * self.tiles_per_block, 1)


def spmm_panels(tile_ids, *, tiles_per_block: int) -> SpmmPanels:
    """Group the padded lattice's ``(nblocks * tiles_per_block,)``
    ``tile_ids`` into panels, with torch ops on their device (one host
    sync: build it once per weight, not per launch).

    The blocks are ordered by their tile lists (lexicographically, slot 0
    first; a stable sort), so blocks that name the same tiles slot by slot
    come together wherever they sit in the lattice. In that order a block
    joins its predecessor's run when at least 3/4 of its slots name the
    same tile as the predecessor's; a run longer than
    :data:`KERNEL_PANEL_BLOCKS` is cut into panels of that many and one
    of the rest (a panel's blocks are the kernel's warps, two to an SM
    sub-partition at 8: full panels keep the sub-partitions evenly
    loaded). A block that shares with no other is a panel of one."""
    tile_ids = torch.as_tensor(tile_ids)
    dev = tile_ids.device
    tpb = tiles_per_block
    if tpb <= 0 or tile_ids.numel() % tpb or not tile_ids.numel():
        raise ValueError(f"{tile_ids.numel()} tile ids are not nblocks >= 1 "
                         f"x tiles_per_block={tpb}")
    ids = tile_ids.long().view(-1, tpb)
    nblocks = ids.shape[0]
    order = torch.arange(nblocks, device=dev)
    for t in range(tpb - 1, -1, -1):
        order = order[torch.argsort(ids[order, t], stable=True)]
    ids = ids[order]
    ar = torch.arange(nblocks, device=dev)
    start = torch.ones(nblocks, dtype=torch.bool, device=dev)
    start[1:] = 4 * (ids[1:] == ids[:-1]).sum(1) < 3 * tpb
    first = ar[start]
    run = torch.cumsum(start, 0) - 1
    pstart = (ar - first[run]) % KERNEL_PANEL_BLOCKS == 0
    pfirst = ar[pstart]
    panel = torch.cumsum(pstart, 0) - 1
    npanels = int(pfirst.numel())
    place = ar - pfirst[panel]
    # the distinct (panel, slot, tile) keys, each with its blocks' bits
    ntile = int(ids.max()) + 1
    slot = torch.arange(tpb, device=dev)
    key = ((panel[:, None] * tpb + slot[None, :]) * ntile + ids).view(-1)
    ukey, inv = torch.unique(key, sorted=True, return_inverse=True)
    bits = (1 << place)[:, None].expand(nblocks, tpb).reshape(-1)
    mask = torch.zeros(ukey.shape[0], dtype=torch.long, device=dev)
    mask.index_add_(0, inv, bits)
    ps = ukey // ntile
    entry_ptr = torch.zeros(npanels * tpb + 1, dtype=torch.int32, device=dev)
    entry_ptr[1:] = torch.cumsum(
        torch.bincount(ps, minlength=npanels * tpb), 0)
    return SpmmPanels(
        blocks=order.int(),
        panel_ptr=torch.cat([pfirst, pfirst.new_tensor([nblocks])]).int(),
        entry_ptr=entry_ptr,
        entries=torch.stack([ukey % ntile, ps % tpb, mask], 1).int()
        .contiguous(),
        tiles_per_block=tpb)


def cluster_spmm(tile_ids, a_values: torch.Tensor, b: torch.Tensor, *,
                 block_r: int, block_k: int, tiles_per_block: int,
                 bn: int = 128, panels: SpmmPanels | None = None
                 ) -> torch.Tensor:
    """C = A_bcc @ B over BCC's padded lattice: ``tile_ids``
    ``(nblocks * tiles_per_block,)`` and the matching value slabs, pad
    slabs zero. ``b`` is ``(K, N)`` (rows past K and the ragged last
    column strip are masked, no padding needed); ``bn`` is the kernel's
    column-strip width (≤ 128); ``panels`` is the lattice's panel
    schedule (:func:`spmm_panels`, built here when absent — callers that
    launch again keep it). Returns ``(nblocks * block_r, N)`` in B's
    dtype (fp32, bf16 or fp16; 16-bit sums rounded after every slot).

    CUDA tensors launch the hand-written kernel (and add one to
    ``cluster_spmm.launches``); CPU tensors run the plain version; any
    other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spmm_plain(tile_ids, a_values, b, block_r=block_r,
                                  block_k=block_k,
                                  tiles_per_block=tiles_per_block)
    tile_ids = _padded_operands(tile_ids, a_values, b, block_r=block_r,
                                block_k=block_k,
                                tiles_per_block=tiles_per_block)
    dev = a_values.device
    if dev.type != "cuda":
        raise ValueError(f"cluster_spmm: tensors on {dev}; the kernel runs "
                         "on CUDA, the plain version on the CPU")
    if block_r != KERNEL_BLOCK_R or not 0 < bn <= KERNEL_MAX_BN:
        raise ValueError(f"kernel takes block_r={KERNEL_BLOCK_R} and "
                         f"0 < bn <= {KERNEL_MAX_BN}, got block_r={block_r}, "
                         f"bn={bn}")
    k, n = b.shape
    nblocks = a_values.shape[0] // tiles_per_block
    # every (panel, strip) CTA writes its blocks' whole strip: no zero-fill
    out = torch.empty((nblocks * block_r, n), dtype=b.dtype, device=dev)
    if nblocks == 0 or n == 0:
        return out
    if panels is None:
        panels = spmm_panels(tile_ids, tiles_per_block=tiles_per_block)
    if (panels.nblocks, panels.tiles_per_block) != (nblocks,
                                                     tiles_per_block) \
            or panels.entries.device != dev:
        raise ValueError(f"panels of {panels.nblocks} x "
                         f"{panels.tiles_per_block} slots on "
                         f"{panels.entries.device} do not describe this "
                         f"lattice ({nblocks} x {tiles_per_block} on {dev})")
    a_values = a_values.contiguous()
    b = b.contiguous()
    lib = _build.load("cluster_spmm")
    fn = lib.cluster_spmm_padded
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(panels.blocks.data_ptr(), panels.panel_ptr.data_ptr(),
            panels.entry_ptr.data_ptr(),
            panels.entries.data_ptr(), a_values.data_ptr(), b.data_ptr(),
            out.data_ptr(), panels.npanels, tiles_per_block, block_k, k, n,
            bn, B_DTYPES[b.dtype], stream)
    if rc != 0:
        lib.cluster_spmm_error_string.restype = ctypes.c_char_p
        lib.cluster_spmm_error_string.argtypes = [ctypes.c_int]
        msg = lib.cluster_spmm_error_string(rc).decode()
        raise RuntimeError(f"cluster_spmm launch failed: {msg}")
    cluster_spmm.launches += 1
    return out


cluster_spmm.launches = 0


def cluster_spmm_plain(tile_ids, a_values: torch.Tensor, b: torch.Tensor, *,
                       block_r: int, block_k: int,
                       tiles_per_block: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spmm`, on any device:
    slot by slot over the padded lattice, every block's slab at that slot
    against the B row band it names (``torch.bmm`` in fp32), summed in
    slot order — pad slots included; with a 16-bit B each slot's product
    is rounded to B's dtype and added in it."""
    tile_ids = _padded_operands(tile_ids, a_values, b, block_r=block_r,
                                block_k=block_k,
                                tiles_per_block=tiles_per_block)
    k, n = b.shape
    bands = F.pad(b.float(), (0, 0, 0, (-k) % block_k)).view(-1, block_k, n)
    nblocks = a_values.shape[0] // tiles_per_block
    slabs = a_values.view(nblocks, tiles_per_block, block_r, block_k)
    ids = tile_ids.long().view(nblocks, tiles_per_block)
    c = torch.zeros((nblocks, block_r, n), dtype=b.dtype, device=b.device)
    for t in range(tiles_per_block):
        prod = torch.bmm(slabs[:, t], bands[ids[:, t]])
        c = c + (prod if b.dtype == torch.float32 else prod.to(b.dtype))
    return c.view(nblocks * block_r, n)
