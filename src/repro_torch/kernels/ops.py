"""Public wrappers around the CUDA kernels.

These adapt the device formats (``core/formats.py``'s ``BCC``,
``TiledCSR``, ``CompactedC``) to the kernels' calling conventions and
keep the JAX package's selection *rules*:

* the live-pair compacted grid runs only while a C row strip fits the
  strip budget (``compact_grid_ok``); past it — B wider than 65,536
  columns at the serving packing — the product runs on the padded
  per-tile grid (:func:`cluster_spgemm_padded`), whose output has B's
  dtype. That is the TPU's rule, kept on every route but one: on the
  card a product asked for sparse C takes the live-pair grid at any
  width;
* the sparse-C output tier runs when the predicted C window density is at
  most 0.5 (:func:`predict_c_window_density`) and the product is not
  sharded;
* ``shards > 1`` splits the live-pair stream into contiguous block ranges
  balanced by live pairs (:func:`build_shard_pack`), run in one launch of
  one CTA per window of every range, shard-major
  (:func:`cluster_spgemm_sharded`); ``revisit=True`` orders each range's
  pairs so a B tile's uses across a window of blocks are adjacent
  (:func:`cluster_spgemm_revisit`). :func:`pallas_shard_count` is 1, so
  the serving path does not shard by default;
* each launch is labelled with the variant the JAX package would have
  picked (``resident`` / ``streamed_db`` / ``streamed`` / ``sparse_c`` /
  ``padded`` / ``sharded`` / ``sharded_revisit``) in the
  ``kernel_launches`` counter. The resident / streamed split was a TPU
  memory placement: on the card both labels run the same kernel.

Host packing stays numpy; the packed streams are moved to the operands'
device once, in :func:`pack_spgemm`, so a caller that keeps the pack
(the planner's serving path) launches with no host work at all. The pack
also holds the live-column form of A's slabs (:func:`slab_columns`),
which every Sp×Sp kernel and the compact SpMM kernel walk instead of the
padded slabs; it is built on the device once per packed operand.

The dense-B SpMM wrappers (:func:`bcc_spmm` on BCC's padded lattice,
:func:`bcc_spmm_compact` on its compact stream) back ``SparseLinear``;
:func:`fused_ssd` and :func:`flash_mha` adapt the LM zoo's layouts to the
SSD chunk-scan and flash-attention kernels. Every wrapper follows the
port's rule: a CUDA tensor launches the kernel or raises, a CPU tensor
runs the kernel's plain version.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import (BCC, CompactedC, TiledCSR,
                                      compacted_c_counters,
                                      compacted_c_keys,
                                      compacted_c_table, live_pair_counters,
                                      live_pair_stream,
                                      partition_pair_stream,
                                      revisit_pair_stream,
                                      revisit_window_blocks)
from repro_torch.core.segment import rank_in_segment
from repro_torch.kernels.cluster_spgemm import (PaddedGrid, Segments,
                                                Windows, census_tiles,
                                                cluster_spgemm_padded,
                                                cluster_spgemm_revisit,
                                                cluster_spgemm_sharded,
                                                cluster_spgemm_windows,
                                                padded_grid,
                                                segments_from_shards,
                                                windows_from_pairs,
                                                windows_from_shards)
from repro_torch.kernels.cluster_spmm import (KERNEL_MAX_BN, SpmmPanels,
                                              cluster_spmm,
                                              cluster_spmm_compact,
                                              spmm_panels)
from repro_torch.kernels.columns import SlabColumns, slab_columns
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.resilience import faults as _faults

__all__ = ["pallas_shard_count", "bcc_spmm", "SpmmPanels", "spmm_panels",
           "bcc_compact_stream",
           "SlabColumns", "slab_columns", "bcc_spmm_compact",
           "spmm_compact_stream", "build_live_pairs", "build_shard_pack",
           "build_sparse_c_pairs", "predict_c_window_density",
           "compact_grid_ok", "compact_grid_ok_ncols", "SpGEMMPack",
           "pack_spgemm", "bcc_spgemm_tiled", "bcc_spgemm_sparse_c",
           "fused_ssd", "flash_mha"]

# the JAX package's VMEM budget for pinning B's tile store on-chip; here it
# only decides the ``resident`` label of a dense-strip launch
_RESIDENT_B_BUDGET = 8 * 2**20

# ceiling on the compacted grid's C row-strip window (block_r × nnb·bn
# fp32) in the JAX package's VMEM: B matrices wide enough to blow it need
# the padded per-tile grid there (compact_grid_ok_ncols)
_COMPACT_C_STRIP_BUDGET = 2 * 2**20

# predicted C window density (live (blk, j) windows / all windows) at or
# below which the product routes through the sparse-C output tier
_SPARSE_C_DENSITY = 0.5


def _note_kernel_launch(variant: str, *, pairs=None, block_r=None,
                        block_k=None, bn=None, cc=None) -> None:
    """Account one Sp×Sp dispatch: the ``kernel_launches`` counter
    (labelled by variant) plus — only when the registry's opt-in
    ``device_emission`` flag is on, the counters are O(pairs) host work —
    the traffic counters of the launch."""
    reg = obs_metrics.get_registry()
    reg.counter("kernel_launches", variant=variant).inc()
    if not reg.device_emission:
        return
    if pairs is not None:
        reg.emit_device_counters(
            live_pair_counters(pairs, block_r=block_r, block_k=block_k,
                               bn=bn), variant=variant)
    if cc is not None:
        reg.emit_device_counters(compacted_c_counters(cc), variant=variant)


def pallas_shard_count() -> int:
    """Shards the serving path splits a pair stream into by default: 1,
    so the planner's default route is the window kernel. (The JAX
    package fans out over its TPU cores; on one card the shards would be
    CTAs, and a default count for them is left to measurement.)"""
    return 1


def bcc_spmm(a: BCC, b: torch.Tensor, *, bn: int = 128,
             panels: SpmmPanels | None = None) -> torch.Tensor:
    """C = A_bcc @ B (B dense ``(a.ncols, N)``) via the padded-lattice
    kernel: every block visits all of its ``tiles_per_block`` slabs, pads
    included, in panels of blocks that share B tiles (``panels``:
    :func:`spmm_panels` of ``a.tile_ids``, built here when absent; a
    caller that launches again keeps it). Column strips are ``min(bn,
    max(8, N))`` wide, as in the JAX package; B's ragged rows and columns
    are masked in the kernel rather than padded. B is fp32, bf16 or fp16;
    returns ``(a.nrows, N)`` in B's dtype (16-bit sums rounded after every
    slot, as the JAX kernel's)."""
    n0 = b.shape[1]
    bn_eff = min(bn, max(8, n0), KERNEL_MAX_BN)
    out = cluster_spmm(a.tile_ids, a.values, b, block_r=a.block_r,
                       block_k=a.block_k, tiles_per_block=a.tiles_per_block,
                       bn=bn_eff, panels=panels)
    return out[: a.nrows]


def bcc_compact_stream(a: BCC, *, cover_all_blocks: bool = False
                       ) -> tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """Squeeze the padded (block, tile) lattice to live tiles.

    Returns ``(block_ids, tile_ids, values)`` sorted by block — host int32
    arrays and the ``(S, block_r, block_k)`` slabs on ``a``'s device.
    Tail-padded (repeating the last block with zero slabs) to a multiple
    of 8 steps. ``cover_all_blocks=True`` additionally emits one zero-slab
    step for every block with *no* live tiles, so a kernel that owns
    output blocks through the stream visits every one of them.
    """
    ntiles = a.ntiles.cpu().numpy()
    tpb = a.tiles_per_block
    eff = np.maximum(ntiles, 1) if cover_all_blocks else ntiles
    live_mask = np.arange(tpb, dtype=np.int64)[None, :] < eff[:, None]
    keep = np.flatnonzero(live_mask.ravel())
    if keep.size == 0:   # fully empty matrix: single zero step
        keep = np.zeros(1, dtype=np.int64)
    blocks = keep // tpb
    live = keep.shape[0]
    pad = (-live) % 8
    keep = np.concatenate([keep, np.full(pad, keep[-1], dtype=np.int64)])
    block_ids = np.concatenate(
        [blocks, np.full(pad, blocks[-1], dtype=np.int64)]).astype(np.int32)
    tile_ids = a.tile_ids.cpu().numpy()[keep].astype(np.int32)
    vals = a.values[torch.from_numpy(keep).to(a.values.device)]
    if pad:
        vals[live:] = 0.0
    # slabs of empty blocks (cover_all_blocks) are all-zero by construction
    # in the padded lattice, so their steps contribute nothing
    return block_ids, tile_ids, vals


def bcc_spmm_compact(a: BCC, b: torch.Tensor, *,
                     stream: tuple | None = None,
                     cols: SlabColumns | None = None) -> torch.Tensor:
    """C = A_bcc @ B (B dense ``(a.ncols, N)``) via the compact-stream
    kernel, in column strips of up to 128. ``stream`` and ``cols`` (its
    slabs' live columns) are built here when absent; a caller that
    launches again keeps them. B is fp32, bf16 or fp16; returns
    ``(a.nrows, N)`` in B's dtype (16-bit sums rounded after every
    step, as the JAX kernel's)."""
    if stream is None:
        # cover_all_blocks: a block with no live tiles must still appear
        # once so its C strip is written
        stream = bcc_compact_stream(a, cover_all_blocks=True)
    return spmm_compact_stream(stream, b, nrows=a.nrows, cols=cols)


def spmm_compact_stream(stream: tuple, b: torch.Tensor, *, nrows: int,
                        cols: SlabColumns | None = None) -> torch.Tensor:
    """:func:`bcc_spmm_compact` from A's compact stream alone (built with
    ``cover_all_blocks=True``) and its slabs' live columns: all the launch
    reads of A, so a caller that keeps them need not keep A's padded slab
    array."""
    block_ids, tile_ids, values = stream
    _, block_r, block_k = values.shape
    nblocks = (nrows + block_r - 1) // block_r
    bn_eff = max(1, min(KERNEL_MAX_BN, b.shape[1]))
    out = cluster_spmm_compact(block_ids, tile_ids, values, b,
                               block_r=block_r, block_k=block_k,
                               nblocks=nblocks, bn=bn_eff, cols=cols)
    return out[:nrows]


def compact_grid_ok_ncols(ncols: int, *, block_r: int = 8, bn: int = 128,
                          sparse_c: bool = False, device=None) -> bool:
    """Whether the live-pair grid applies to a product whose B (and C) is
    ``ncols`` wide, at the serving path's default packing (one source of
    truth for the rule).

    Two rules. The TPU's, the JAX package's: its pair kernels hold a
    whole C row strip ``(block_r, nnb·bn)`` fp32 in VMEM, so the grid
    applies while the strip fits ``_COMPACT_C_STRIP_BUDGET`` (B up to
    65,536 columns here); a wider product takes the padded per-tile grid.
    The card's: its window kernel gives each live ``(block, j)`` window
    one CTA and holds no strip (``csrc/cluster_spgemm.cu``), so a product
    asked for sparse C (``sparse_c``) on a CUDA ``device`` takes the grid
    at any width. Every other product — the dense-C routes, and every
    route on the CPU, whose plans match the JAX package's — keeps the
    TPU's rule."""
    if sparse_c and device is not None \
            and torch.device(device).type == "cuda":
        return True
    nnb = (max(ncols, 1) + bn - 1) // bn
    return block_r * nnb * bn * 4 <= _COMPACT_C_STRIP_BUDGET


def compact_grid_ok(a: BCC, b: TiledCSR, *, sparse_c: bool = False) -> bool:
    """Whether the live-pair compacted grid applies to this operand pair
    (:func:`compact_grid_ok_ncols` on A's device)."""
    return compact_grid_ok_ncols(b.nnb * b.bn, block_r=a.block_r, bn=b.bn,
                                 sparse_c=sparse_c,
                                 device=a.values.device)


def build_live_pairs(a: BCC, b: TiledCSR, stream: tuple | None = None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """Intersect A's compact stream with B's tile table into the live-pair
    stream (host numpy, ordered (block, s, j)). Synthetic stream steps —
    ``cover_all_blocks`` zero slabs of empty blocks and the tail padding
    — are masked out of the pair expansion."""
    if stream is None:
        stream = bcc_compact_stream(a, cover_all_blocks=True)
    block_ids, tile_ids = np.asarray(stream[0]), np.asarray(stream[1])
    ntiles = a.ntiles.cpu().numpy()
    step_live = rank_in_segment(block_ids.astype(np.int64)) \
        < ntiles[block_ids]
    return live_pair_stream(
        block_ids, tile_ids, b.table.cpu().numpy(), nnb=b.nnb,
        nblocks=(a.nrows + a.block_r - 1) // a.block_r,
        step_live=step_live)


def build_shard_pack(a: BCC, b: TiledCSR, pairs: tuple, *,
                     shards: int | None = None,
                     revisit: bool = False) -> tuple | None:
    """Partition the live-pair stream into contiguous block ranges
    balanced by live-pair count and optionally revisit-order each range's
    sub-stream (host numpy, the JAX package's partition, field for
    field).

    Returns ``(ranges, shard_pairs, window_blocks)`` — ``window_blocks``
    ``None`` unless ``revisit`` — or ``None`` when there is nothing to do
    (one shard, no revisit).
    """
    if shards is None:
        shards = pallas_shard_count()
    if shards <= 1 and not revisit:
        return None
    nblocks = (a.nrows + a.block_r - 1) // a.block_r
    ranges, shard_pairs = partition_pair_stream(
        pairs, nblocks=nblocks, num_shards=shards)
    wb = None
    if revisit:
        wb = revisit_window_blocks(b.nnb, block_r=a.block_r, bn=b.bn)
        shard_pairs = [
            revisit_pair_stream(p, window_blocks=wb, block_base=int(s))
            for p, (s, _) in zip(shard_pairs, ranges)]
    return ranges, shard_pairs, wb


def predict_c_window_density(pairs, *, nblocks: int, nnb: int) -> float:
    """Predicted density of C's ``(block_r, bn)`` window lattice: distinct
    live ``(blk, j)`` windows over all ``nblocks × nnb`` windows, known
    before the numeric phase from the live-pair stream alone."""
    blocks, js, slots, _ = (np.asarray(p) for p in pairs)
    live = slots > 0
    key = blocks[live].astype(np.int64) * nnb + js[live].astype(np.int64)
    return np.unique(key).size / max(nblocks * nnb, 1)


def build_sparse_c_pairs(a: BCC, b: TiledCSR, pairs: tuple | None = None,
                         stream: tuple | None = None, *, pad_to: int = 8
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray, int]:
    """Re-sort the live-pair stream window-major (blk, j, s) and tag each
    pair with its destination ``CompactedC`` slab.

    Zero-slot sentinels and tail pads are dropped; one leading sentinel
    pair (slab 0, B slot 0) is prepended and the tail re-padded to
    ``pad_to`` with slot-0 repeats of the last window — the JAX package's
    stream, field for field.

    Returns ``(c_slots, slots, a_idx, table, nslabs)`` — the stream, the
    CompactedC lookup table and slab count (live windows + the zero slab).
    The window kernel does not read this stream: :func:`pack_spgemm`
    groups the same live pairs in the same order with
    ``windows_from_pairs``.
    """
    if stream is None:
        stream = bcc_compact_stream(a, cover_all_blocks=True)
    if pairs is None:
        pairs = build_live_pairs(a, b, stream)
    nblocks = (a.nrows + a.block_r - 1) // a.block_r
    table, nlive = compacted_c_table(pairs, nblocks=nblocks, nnb=b.nnb)
    blocks, js, slots, a_idx = (np.asarray(p) for p in pairs)
    live = slots > 0
    bl = blocks[live].astype(np.int64)
    jl = js[live].astype(np.int64)
    sl = slots[live]
    al = a_idx[live]
    order = np.lexsort((al, jl, bl))
    bl, jl, sl, al = bl[order], jl[order], sl[order], al[order]
    c_slots = table[bl * b.nnb + jl].astype(np.int64)
    anchor = int(al[0]) if al.size else 0
    c_slots = np.concatenate([[0], c_slots])
    sl = np.concatenate([[0], sl.astype(np.int64)])
    al = np.concatenate([[anchor], al.astype(np.int64)])
    pad = (-c_slots.size) % pad_to
    if pad:
        c_slots = np.concatenate([c_slots, np.repeat(c_slots[-1], pad)])
        sl = np.concatenate([sl, np.zeros(pad, np.int64)])
        al = np.concatenate([al, np.repeat(al[-1], pad)])
    return (c_slots.astype(np.int32), sl.astype(np.int32),
            al.astype(np.int32), table, nlive + 1)


@dataclasses.dataclass(frozen=True)
class SpGEMMPack:
    """Everything one Sp×Sp launch reads of A, packed once: the compact A
    stream, the route, and the route's launch on the device — the
    window-major stream (``dense`` / ``sparse_c``), the shards' windows or
    revisit segments (``sharded`` / ``sharded_revisit``, with the host
    partition in ``shard_pack``) or the padded grid (``padded``, which
    builds no live pairs). On the sparse-C route ``keys`` are C's live
    window keys on the device (:func:`compacted_c_keys`). A caller that
    keeps the pack (the planner's exec cache) launches from it and B
    alone, without A's padded slab array. ``cols`` is the live-column form of the stream's
    slabs, which every route's kernel walks; ``census`` lists the B tile
    slots the launch meets through a slab with a dead column, whose
    non-finite values every launch counts (:func:`census_tiles`)."""

    stream: tuple              # (block_ids, tile_ids, values)
    pairs: tuple | None        # (blocks, js, slots, a_idx) host int32
    route: str                 # dense | sparse_c | sharded |
    #                            sharded_revisit | padded
    launch: Windows | Segments | PaddedGrid
    keys: torch.Tensor | None  # C's live window keys (sparse_c only)
    nrows: int                 # A's rows
    block_r: int
    block_k: int
    shard_pack: tuple | None = None   # (ranges, shard_pairs, window_blocks)
    cols: SlabColumns | None = None
    census: torch.Tensor | None = None

    @property
    def sparse_c(self) -> bool:
        return self.route == "sparse_c"


def pack_spgemm(a: BCC, b: TiledCSR, *, sparse_c: bool | None = None,
                compact: bool | None = None, shards: int | None = None,
                revisit: bool = False,
                shard_pack: tuple | None = None) -> SpGEMMPack:
    """Pack ``a @ b`` for its kernel, choosing the route as the JAX
    package's ``bcc_spgemm_tiled`` does:

    * ``compact`` — the live-pair grid (default while the C row strip
      fits the strip budget, or whenever ``shard_pack`` is given) or the
      padded per-tile grid;
    * ``shards`` / ``revisit`` / ``shard_pack`` — the partition of the
      live-pair stream (:func:`build_shard_pack`; default
      :func:`pallas_shard_count`, i.e. unsharded);
    * ``sparse_c`` — CompactedC slabs; default when the product is not
      sharded and the predicted C window density is at most 0.5. Asked
      for (``True``) on the card, the product takes the live-pair grid
      at any width (:func:`compact_grid_ok_ncols`).
    """
    if a.block_k != b.block_k:
        raise ValueError(f"A block_k {a.block_k} != B block_k {b.block_k}")
    nkb_needed = (a.ncols + a.block_k - 1) // a.block_k
    if b.nkb < nkb_needed:
        raise ValueError(f"B covers {b.nkb} k-blocks, A addresses "
                         f"{nkb_needed}")
    stream = bcc_compact_stream(a, cover_all_blocks=True)
    nblocks = (a.nrows + a.block_r - 1) // a.block_r
    dev = a.values.device
    common = dict(stream=stream, nrows=a.nrows, block_r=a.block_r,
                  block_k=a.block_k)
    if compact is None:
        compact = shard_pack is not None or compact_grid_ok(
            a, b, sparse_c=bool(sparse_c))
    if not compact:
        grid = padded_grid(stream[0], stream[1], b.table, nblocks=nblocks,
                           nnb=b.nnb, block_r=a.block_r, bn=b.bn, device=dev)
        return _with_census(SpGEMMPack(pairs=None, route="padded",
                                       launch=grid, keys=None, **common))
    pairs = build_live_pairs(a, b, stream)
    if shard_pack is None:
        shard_pack = build_shard_pack(a, b, pairs, shards=shards,
                                      revisit=revisit)
    geometry = dict(nblocks=nblocks, nnb=b.nnb, block_r=a.block_r, bn=b.bn,
                    device=dev)
    if shard_pack is not None:
        ranges, shard_pairs, wb = shard_pack
        if wb is None:
            launch = windows_from_shards(ranges, shard_pairs, **geometry)
        else:
            launch = segments_from_shards(ranges, shard_pairs,
                                          window_blocks=wb, **geometry)
        return _with_census(SpGEMMPack(
            pairs=pairs, route="sharded" if wb is None else "sharded_revisit",
            launch=launch, keys=None, shard_pack=shard_pack, **common))
    if sparse_c is None:
        sparse_c = predict_c_window_density(
            pairs, nblocks=nblocks, nnb=b.nnb) <= _SPARSE_C_DENSITY
    keys = None
    if sparse_c:
        keys = torch.from_numpy(compacted_c_keys(pairs, nnb=b.nnb)).to(dev)
    windows = windows_from_pairs(*pairs, keys=keys, **geometry)
    return _with_census(SpGEMMPack(
        pairs=pairs, route="sparse_c" if sparse_c else "dense",
        launch=windows, keys=keys, **common))


def _with_census(pack: SpGEMMPack) -> SpGEMMPack:
    """The pack with its slabs' live columns and its launch's census
    tiles, both built on the device once."""
    cols = slab_columns(pack.stream[2])
    return dataclasses.replace(pack, cols=cols,
                               census=census_tiles(pack.launch, cols))


def bcc_spgemm_sparse_c(a: BCC | None, b: TiledCSR, *,
                        pack: SpGEMMPack | None = None) -> CompactedC:
    """C = A_bcc @ B_tiled into the sparse-C output tier: each live C
    window accumulated once and written as a ``CompactedC`` slab — C bytes
    scale with the live-window count, not ``rows × nnb·bn``. ``a`` may be
    ``None`` when ``pack`` is given."""
    _faults.maybe_fault("kernel_launch")
    if pack is None:
        pack = pack_spgemm(a, b, sparse_c=True)
    if not pack.sparse_c:
        raise ValueError(f"pack was built for the {pack.route} route")
    with get_tracer().span("kernel_variant", variant="sparse_c",
                           epilogue="kernel"):
        slabs = cluster_spgemm_windows(pack.launch, pack.stream[2],
                                       b.tiles, pack.cols, pack.census)
    out = CompactedC(slabs=slabs, keys=pack.keys, nrows=pack.nrows,
                     ncols=b.ncols, block_r=pack.block_r, bn=b.bn)
    _note_kernel_launch("sparse_c", cc=out)
    return out


def bcc_spgemm_tiled(a: BCC | None, b: TiledCSR, *,
                     pack: SpGEMMPack | None = None,
                     compact: bool | None = None,
                     shards: int | None = None, revisit: bool = False,
                     shard_pack: tuple | None = None,
                     sparse_c: bool | None = None) -> torch.Tensor:
    """C = A_bcc @ B_tiled. Returns the dense ``(a.nrows, b.ncols)``
    product: fp32 on the live-pair routes (bf16 B tiles are upcast,
    accumulation stays fp32), B's dtype on the padded grid (as in the JAX
    package).

    ``pack`` is the packed launch (:func:`pack_spgemm`, kept by callers
    that reuse it); without one the operands are packed here with
    ``compact``, ``shards``, ``revisit``, ``shard_pack`` and ``sparse_c``
    (see :func:`pack_spgemm`). With a pack, ``a`` may be ``None``: the
    pack holds all the launch reads of A. The sparse-C route densifies
    its ``CompactedC`` on the way out.
    """
    _faults.maybe_fault("kernel_launch")
    if pack is None:
        pack = pack_spgemm(a, b, sparse_c=sparse_c, compact=compact,
                           shards=shards, revisit=revisit,
                           shard_pack=shard_pack)
    if pack.sparse_c:
        return bcc_spgemm_sparse_c(None, b, pack=pack).to_dense()
    resident = b.nbytes_tiles() <= _RESIDENT_B_BUDGET
    values = pack.stream[2]
    tracer = get_tracer()
    if pack.route == "padded":
        with tracer.span("kernel_variant", variant="padded",
                         resident=resident):
            out = cluster_spgemm_padded(pack.launch, values, b.tiles,
                                        pack.cols, pack.census)
        _note_kernel_launch("padded")
        return out[: pack.nrows, : b.ncols]
    if pack.route in ("sharded", "sharded_revisit"):
        nshards = len(pack.shard_pack[1])
        with tracer.span("kernel_variant", variant=pack.route,
                         shards=nshards):
            if pack.route == "sharded_revisit" and nshards == 1:
                out = cluster_spgemm_revisit(pack.launch, values, b.tiles,
                                             pack.cols, pack.census)
            else:
                out = cluster_spgemm_sharded(pack.launch, values, b.tiles,
                                             pack.cols, pack.census)
        variant = pack.route
    else:
        if resident:
            variant = "resident"
        elif values.device.type == "cuda":
            variant = "streamed_db"
        else:
            variant = "streamed"
        with tracer.span("kernel_variant", variant=variant):
            out = cluster_spgemm_windows(pack.launch, values, b.tiles,
                                         pack.cols, pack.census)
    _note_kernel_launch(variant, pairs=pack.pairs, block_r=pack.block_r,
                        block_k=pack.block_k, bn=b.bn)
    return out[: pack.nrows, : b.ncols]


def fused_ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, chunk: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``models.mamba2.ssd_chunked`` backed by the SSD
    chunk-scan kernel. x (B,S,H,P); dt (B,S,H); a_log (H,); b/c
    (B,S,G,N) with G groups broadcast over heads. dt is folded into x and
    into the log-decay ``-exp(a_log)·dt`` here; x and the decays are laid
    out as (B·H, nc, Q, …), B and C as (B·G, nc, Q, N) — read by each of
    a group's heads, not copied per head. Returns (y (B,S,H,P) in x's
    dtype, state (B,H,P,N) fp32)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    dt32 = dt.float()
    a_step = (-torch.exp(a_log.float()))[None, None, :] * dt32   # (B,S,H)
    xd = x.float() * dt32[..., None]

    def to_bh(t):   # (B,S,K,...) -> (B*K, nc, Q, ...)
        t = t.movedim(2, 1)                                       # (B,K,S,...)
        return t.reshape(bsz * t.shape[1], nc, chunk, *t.shape[3:])

    y, hfin = ssd_chunk_scan(to_bh(xd), to_bh(a_step), to_bh(b.float()),
                             to_bh(c.float()), heads_per_group=h // g)
    y = y.reshape(bsz, h, s, p).movedim(1, 2).to(x.dtype)
    state = hfin.reshape(bsz, h, n, p).movedim(2, 3)              # (B,H,P,N)
    return y, state


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """GQA flash attention: q (B,Hq,S,D), k/v (B,Hkv,S,D), Hq % Hkv == 0;
    each KV head is repeated over its Hq / Hkv query heads."""
    bsz, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not share {hkv} KV heads")
    rep = hq // hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    out = flash_attention(q.reshape(bsz * hq, sq, d),
                          k.reshape(bsz * hq, sk, d),
                          v.reshape(bsz * hq, sk, d), causal=causal)
    return out.reshape(bsz, hq, sq, d)
