"""Cluster-wise sparse × sparse SpGEMM on the card: the window kernel.

C = A_bcc · B_tiled, with A packed in BCC (``block_r``-row blocks of
dense ``(block_r, block_k)`` slabs, streamed compactly) and B in
``TiledCSR`` (dense ``(block_k, bn)`` live tiles). The host intersects
the two into a live-pair stream (``core/formats.py::live_pair_stream``);
this module regroups it *window-major* — one entry per live ``(blk, j)``
window of C, its pairs s-ascending — and hands it to one kernel
(``csrc/cluster_spgemm.cu``) that gives each window to one CTA and writes
the window once: into a strip of a dense C, or into one slab of the
``CompactedC`` store. The kernel walks A's slabs over their live columns
(:class:`~repro_torch.kernels.columns.SlabColumns`): per pair, one read
of the B tile's row for each column of the slab that holds a nonzero. That single kernel is the counterpart of the JAX
package's five pair kernels (``cluster_spgemm_pairs{,_resident,_db}``,
dense strips; ``cluster_spgemm_pairs_sparse{,_db}``, slabs), which differ
only in VMEM placement and output addressing.

:func:`windows_from_pairs` packs the launch once, from the (block, s, j)
stream of ``live_pair_stream``, for either output: dense strips, or
CompactedC slabs placed by C's sorted live window keys
(``compacted_c_keys``).
:func:`cluster_spgemm_windows` is the wrapper: on a CUDA tensor it
launches the kernel (counting the launch in its ``launches`` attribute)
or raises; on a CPU tensor it runs :func:`cluster_spgemm_windows_plain`,
the same sum over the same live columns written with ``index_add_``.

The JAX package multiplies whole slabs, so a non-finite B value that a
slab's dead column (all its values zero) meets makes the slab's rows NaN
there. The live-column kernels (window, revisit, padded grid) and the
live-column plain version find those by counting B's non-finite values
per tile slot against those the live columns meet
(``csrc/nonfinite.cuh``, :func:`_dead_column_hits`), so every route gives
the JAX package's NaN positions and inf signs; on finite B no bit moves.

Three more launches serve the JAX package's other pair-grid kernels, each
with the same wrapper contract and a plain version beside it:

* :func:`cluster_spgemm_padded` (``csrc/cluster_spgemm_padded.cu``) — the
  padded per-tile grid (``cluster_spgemm_tiled`` / ``_resident``) for B
  too wide for the live-pair grid: a zero-fill of C at the memory's rate,
  then one CTA per live C tile (listed once per packed operand) over A's
  live slab columns, the B table lookup in the kernel, output in B's
  dtype, rounded after every step as the JAX package's kernel rounds it;
* :func:`cluster_spgemm_revisit` (``csrc/cluster_spgemm_revisit.cu``) —
  ``cluster_spgemm_pairs_window`` over a revisit-ordered stream: one CTA
  per (window, j) segment (split by block sub-range where the window is
  wider than its shared-memory accumulator), walking A's live slab
  columns as the window kernel does, consecutive pairs of one B tile
  together;
* :func:`cluster_spgemm_sharded` — ``cluster_spgemm_pairs_sharded``: one
  launch of one CTA per window (window kernel) or segment (revisit
  kernel) of every shard of ``partition_pair_stream``, shard-major.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.columns import SlabColumns, columns_for

__all__ = ["census_tiles", "Windows", "windows_from_pairs",
           "windows_from_shards",
           "cluster_spgemm_windows", "cluster_spgemm_windows_plain",
           "PaddedGrid", "padded_grid", "cluster_spgemm_padded",
           "cluster_spgemm_padded_plain", "Segments", "segment_blocks",
           "segments_from_shards",
           "cluster_spgemm_revisit", "cluster_spgemm_revisit_plain",
           "cluster_spgemm_sharded", "cluster_spgemm_sharded_plain"]

# the kernel's fixed block height and widest window (csrc/cluster_spgemm.cu)
KERNEL_BLOCK_R = 8
KERNEL_MAX_BN = 128


@dataclasses.dataclass(frozen=True)
class Windows:
    """A window-major live-pair stream, ready to launch.

    ``win_ptr[w] .. win_ptr[w+1]`` are window ``w``'s pairs in
    ``slots``/``a_idx`` (s ascending); ``win_out[w]`` is the flat element
    offset of the window's ``(0, 0)`` in an output of ``out_shape`` whose
    rows are ``ldc`` elements apart. Only live pairs (slot > 0) are kept.
    ``order`` is the kernel's launch order of the windows — column strip
    major, so that CTAs running together read the same strip of B's tiles
    — and does not change any sum. ``shard_ptr`` (sharded streams only)
    records where each shard's contiguous range of windows starts;
    ``order`` is then shard-major, column strip major within a shard.
    """

    win_ptr: torch.Tensor      # (W+1,) int32
    win_out: torch.Tensor      # (W,) int64
    slots: torch.Tensor        # (P,) int32 B tile slot per pair
    a_idx: torch.Tensor        # (P,) int32 A stream index per pair
    out_shape: tuple
    ldc: int
    block_r: int
    bn: int
    shard_ptr: torch.Tensor | None = None   # (nshards+1,) int32
    order: torch.Tensor | None = None       # (W,) int32 launch order

    @property
    def nwin(self) -> int:
        return int(self.win_out.shape[0])

    @property
    def npairs(self) -> int:
        return int(self.slots.shape[0])


def _group(keys, slots, a_idx, device):
    """Live pairs grouped by window key (stable: s order kept within a
    window) → (unique keys, win_ptr, slots, a_idx) on ``device``."""
    keys = torch.as_tensor(keys, device=device).long()
    slots = torch.as_tensor(slots, device=device)
    a_idx = torch.as_tensor(a_idx, device=device)
    live = slots > 0
    keys, order = torch.sort(keys[live], stable=True)
    ukey, counts = torch.unique_consecutive(keys, return_counts=True)
    win_ptr = torch.zeros(ukey.shape[0] + 1, dtype=torch.int32,
                          device=device)
    win_ptr[1:] = torch.cumsum(counts, 0)
    return (ukey, win_ptr, slots[live][order].int().contiguous(),
            a_idx[live][order].int().contiguous())


def windows_from_pairs(blocks, js, slots, a_idx, *, nblocks: int, nnb: int,
                       block_r: int, bn: int, device,
                       keys=None) -> Windows:
    """Regroup a (block, s, j)-ordered live-pair stream
    (``live_pair_stream``) by ``(blk, j)`` window, s ascending within each.

    Without ``keys`` the output is the dense ``(nblocks * block_r,
    nnb * bn)`` C, window ``(blk, j)`` at its strip tile. With ``keys``
    (``compacted_c_keys``: the sorted live window keys ``blk * nnb + j``)
    the output is the ``(len(keys) + 1, block_r, bn)`` CompactedC slab
    store, window ``keys[i]`` in slab ``i + 1``; slab 0 stays zero."""
    pair_key = (torch.as_tensor(blocks, device=device).long() * nnb
                + torch.as_tensor(js, device=device).long())
    ukey, win_ptr, sl, ai = _group(pair_key, slots, a_idx, device)
    # launch strip by strip: (j, blk) order
    order = torch.argsort((ukey % nnb) * nblocks + ukey // nnb,
                          stable=True).int().contiguous()
    if keys is None:
        ldc = nnb * bn
        win_out = (ukey // nnb) * (block_r * ldc) + (ukey % nnb) * bn
        out_shape = (nblocks * block_r, ldc)
    else:
        keys = torch.as_tensor(keys, device=device).long()
        ldc = bn
        win_out = (torch.searchsorted(keys, ukey) + 1) * (block_r * bn)
        out_shape = (keys.shape[0] + 1, block_r, bn)
    return Windows(win_ptr=win_ptr, win_out=win_out, slots=sl, a_idx=ai,
                   out_shape=out_shape, ldc=ldc, block_r=block_r, bn=bn,
                   order=order)


def windows_from_shards(ranges, shard_pairs, *, nblocks: int, nnb: int,
                        block_r: int, bn: int, device) -> Windows:
    """Dense-strip windows of a partitioned pair stream
    (``partition_pair_stream``: contiguous block ranges, each sub-stream
    in (block, s, j) order), with ``shard_ptr`` marking where each shard's
    windows start and ``order`` launching them shard by shard, column
    strip by column strip within each — the launch of
    :func:`cluster_spgemm_sharded`."""
    cat = [np.concatenate([np.asarray(p[i]) for p in shard_pairs])
           for i in range(4)]
    w = windows_from_pairs(*cat, nblocks=nblocks, nnb=nnb, block_r=block_r,
                           bn=bn, device=device)
    win_out = w.win_out.cpu().numpy()
    win_blk = win_out // (block_r * w.ldc)
    starts = np.asarray(ranges, dtype=np.int64)[:, 0]
    shard_ptr = np.append(np.searchsorted(win_blk, starts, side="left"),
                          win_blk.size)
    order = _shard_strip_order(shard_ptr, win_out % (block_r * w.ldc) // bn,
                               win_blk)
    return dataclasses.replace(
        w, order=torch.from_numpy(order).to(device),
        shard_ptr=torch.from_numpy(shard_ptr.astype(np.int32)).to(device))


def _check_operands(block_r: int, bn: int, a_values: torch.Tensor,
                    b_tiles: torch.Tensor, *index_tensors) -> None:
    if a_values.dim() != 3 or a_values.shape[1] != block_r:
        raise ValueError(f"a_values {tuple(a_values.shape)} is not "
                         f"(S, {block_r}, block_k)")
    if b_tiles.dim() != 3 or b_tiles.shape[1:] != (a_values.shape[2], bn):
        raise ValueError(f"b_tiles {tuple(b_tiles.shape)} is not "
                         f"(cap, {a_values.shape[2]}, {bn})")
    if a_values.dtype != torch.float32:
        raise ValueError(f"a_values must be float32, got {a_values.dtype}")
    if b_tiles.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"b_tiles must be float32 or bfloat16, got "
                         f"{b_tiles.dtype}")
    devs = {t.device for t in (a_values, b_tiles, *index_tensors)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands span devices {sorted(map(str, devs))}")


def _check(w: Windows, a_values: torch.Tensor, b_tiles: torch.Tensor):
    _check_operands(w.block_r, w.bn, a_values, b_tiles, w.win_ptr,
                    w.win_out, w.slots, w.a_idx, w.shard_ptr)


def _place_plain(acc: torch.Tensor, tile_out: torch.Tensor,
                 out: torch.Tensor, *, block_r: int, bn: int,
                 ldc: int) -> torch.Tensor:
    """Write each ``(block_r, bn)`` tile of ``acc`` (cast to ``out``'s
    dtype) at flat offset ``tile_out[t]`` of ``out``, rows ``ldc``
    apart."""
    dev = out.device
    within = (torch.arange(block_r, device=dev)[:, None] * ldc
              + torch.arange(bn, device=dev)[None, :])
    flat = out.view(-1)
    ntiles = int(tile_out.shape[0])
    tchunk = max(1, (1 << 24) // (block_r * bn))
    for lo in range(0, ntiles, tchunk):
        hi = min(lo + tchunk, ntiles)
        idx = tile_out[lo:hi, None, None] + within
        flat[idx.reshape(-1)] = acc[lo:hi].reshape(-1).to(out.dtype)
    return out


def _tile_sum_plain(pair_tile: torch.Tensor, tile_out: torch.Tensor,
                    slots: torch.Tensor, a_idx: torch.Tensor,
                    a_values: torch.Tensor, b_tiles: torch.Tensor,
                    out: torch.Tensor, *, block_r: int, bn: int,
                    ldc: int) -> torch.Tensor:
    """The padded plain versions' common sum: for every pair ``p`` (in the
    given order), ``a_values[a_idx[p]] @ b_tiles[slots[p]]`` in fp32 is
    ``index_add_``ed into output tile ``pair_tile[p]``, and each tile is
    then written (cast to ``out``'s dtype) at flat offset ``tile_out[t]``
    of ``out``, rows ``ldc`` apart. Chunked so that the gathered B tiles
    stay near 512 MiB. (On a card ``index_add_`` adds with atomics, so
    float sums may differ in the last bits run to run.)"""
    dev = out.device
    ntiles = int(tile_out.shape[0])
    if ntiles == 0:
        return out
    block_k = a_values.shape[2]
    npairs = int(slots.shape[0])
    acc = torch.zeros((ntiles, block_r, bn), dtype=torch.float32,
                      device=dev)
    chunk = max(1, (1 << 27) // (block_k * bn))
    for lo in range(0, npairs, chunk):
        hi = min(lo + chunk, npairs)
        prod = torch.bmm(a_values[a_idx[lo:hi].long()],
                         b_tiles[slots[lo:hi].long()].float())
        acc.index_add_(0, pair_tile[lo:hi], prod)
    return _place_plain(acc, tile_out, out, block_r=block_r, bn=bn, ldc=ldc)


def _column_sum_plain(pair_tile: torch.Tensor, tile_out: torch.Tensor,
                      slots: torch.Tensor, a_idx: torch.Tensor,
                      cols: SlabColumns, b_tiles: torch.Tensor,
                      out: torch.Tensor, *, block_r: int, bn: int,
                      ldc: int) -> torch.Tensor:
    """:func:`_tile_sum_plain` over A's live columns: every pair ``p``
    visits the live columns ``k`` of slab ``a_idx[p]``, and each visit's
    ``block_r`` values times row ``k`` of B tile ``slots[p]`` (fp32) is
    ``index_add_``ed into tile ``pair_tile[p]`` — the window kernel's
    visits, in chunks of about 512 MiB of products — then NaN where a
    dead column met a non-finite B value (:func:`_dead_column_hits`)."""
    dev = out.device
    ntiles = int(tile_out.shape[0])
    if ntiles == 0:
        return out
    acc = torch.zeros((ntiles, block_r, bn), dtype=torch.float32,
                      device=dev)
    a = a_idx.long()
    c0 = cols.col_ptr[:-1].long()[a]
    ncol = cols.col_ptr[1:].long()[a] - c0
    first = torch.cumsum(ncol, 0) - ncol
    visits = int(ncol.sum())
    vis_pair = torch.repeat_interleave(
        torch.arange(a.shape[0], device=dev), ncol)
    chunk = max(1, (1 << 27) // (block_r * bn))
    for lo in range(0, visits, chunk):
        hi = min(lo + chunk, visits)
        p = vis_pair[lo:hi]
        col = c0[p] + torch.arange(lo, hi, device=dev) - first[p]
        rows = b_tiles[slots[p].long(), cols.col_k[col].long()].float()
        acc.index_add_(0, pair_tile[p],
                       cols.col_vals[col][:, :, None] * rows[:, None, :])
    hit = _dead_column_hits(pair_tile, ntiles, slots, a_idx, cols, b_tiles)
    if hit is not None:
        acc = torch.where(hit[:, None, :], torch.full_like(acc, float("nan")),
                          acc)
    return _place_plain(acc, tile_out, out, block_r=block_r, bn=bn, ldc=ldc)


def _dead_column_hits(pair_tile: torch.Tensor, ntiles: int,
                      slots: torch.Tensor, a_idx: torch.Tensor,
                      cols: SlabColumns, b_tiles: torch.Tensor
                      ) -> torch.Tensor | None:
    """Where a dead column (all ``block_r`` values zero) of a pair's slab
    meets a non-finite value of its B tile — the tile's column holds more
    of them than the slab's live columns meet — the whole-slab product is
    NaN in that column of the pair's output tile: ``(ntiles, bn)`` True
    there, or None when B is finite. The census of
    ``csrc/nonfinite.cuh``, in torch ops."""
    bad = ~torch.isfinite(b_tiles)                          # (cap, bk, bn)
    if not bool(bad.any()):
        return None
    dev = b_tiles.device
    per_slot = bad.sum(1, dtype=torch.int32)                # (cap, bn)
    a = a_idx.long()
    c0 = cols.col_ptr[:-1].long()[a]
    ncol = cols.col_ptr[1:].long()[a] - c0
    sl = slots.long()
    # the pairs with a dead column whose tile holds a non-finite value
    check = torch.nonzero((ncol < cols.block_k)
                          & per_slot[sl].any(1)).view(-1)
    nc = ncol[check]
    first = torch.cumsum(nc, 0) - nc
    vis = torch.repeat_interleave(torch.arange(check.numel(), device=dev),
                                  nc)
    col = c0[check][vis] + torch.arange(vis.numel(), device=dev) - first[vis]
    met = torch.zeros((check.numel(), b_tiles.shape[2]), dtype=torch.int32,
                      device=dev)
    met.index_add_(0, vis, bad[sl[check][vis], cols.col_k[col].long()].int())
    dead = (per_slot[sl[check]] > met).int()
    hit = torch.zeros((ntiles, b_tiles.shape[2]), dtype=torch.int32,
                      device=dev)
    hit.index_add_(0, pair_tile[check], dead)
    return hit > 0


def _ranked_sum_plain(pair_tile: torch.Tensor, tile_out: torch.Tensor,
                      slots: torch.Tensor, a_idx: torch.Tensor,
                      a_values: torch.Tensor, b_tiles: torch.Tensor,
                      out: torch.Tensor, *, block_r: int, bn: int,
                      ldc: int) -> torch.Tensor:
    """:func:`_tile_sum_plain` with the running tile kept in B's dtype and
    rounded after every pair, ``o = round(o + round(a @ b))`` in pair order
    — the JAX package's padded kernels with bf16 B tiles. The pairs of a
    tile are grouped by their rank within it, and the ranks are added in
    ascending order, one vectorised step per rank."""
    dev = out.device
    ntiles = int(tile_out.shape[0])
    if ntiles == 0:
        return out
    npairs = int(pair_tile.shape[0])
    order = torch.argsort(pair_tile, stable=True)
    counts = torch.bincount(pair_tile, minlength=ntiles)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(pair_tile)
    rank[order] = (torch.arange(npairs, device=dev)
                   - start[pair_tile[order]])
    by_rank = torch.argsort(rank, stable=True)
    per_rank = torch.bincount(rank).tolist() if npairs else []
    acc = torch.zeros((ntiles, block_r, bn), dtype=b_tiles.dtype,
                      device=dev)
    block_k = a_values.shape[2]
    chunk = max(1, (1 << 27) // (block_k * bn))
    lo = 0
    for n in per_rank:
        for c in range(lo, lo + n, chunk):
            sel = by_rank[c: min(c + chunk, lo + n)]
            prod = torch.bmm(a_values[a_idx[sel].long()],
                             b_tiles[slots[sel].long()].float())
            t = pair_tile[sel]
            acc[t] = (acc[t].float() + prod.to(acc.dtype).float()).to(
                acc.dtype)
        lo += n
    return _place_plain(acc, tile_out, out, block_r=block_r, bn=bn, ldc=ldc)


def cluster_spgemm_windows(w: Windows, a_values: torch.Tensor,
                           b_tiles: torch.Tensor,
                           cols: SlabColumns | None = None,
                           census: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Σ over each live window's pairs of ``a_values[a_idx] @
    b_tiles[slot]`` (fp32 accumulate; bf16 tiles upcast), written once per
    window into a zero-filled float32 output of ``w.out_shape``. ``cols``
    is the slabs' live-column form (:func:`slab_columns`) and ``census``
    the launch's :func:`census_tiles`, both built here when absent —
    callers that launch again keep them.

    CUDA tensors launch the hand-written kernel (and add one to
    ``cluster_spgemm_windows.launches``); CPU tensors run the plain
    version; any other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spgemm_windows_plain(w, a_values, b_tiles, cols)
    _check(w, a_values, b_tiles)
    out = torch.zeros(w.out_shape, dtype=torch.float32,
                      device=a_values.device)
    if _launch(w, a_values, b_tiles, out, cols, census,
               what="cluster_spgemm_windows"):
        cluster_spgemm_windows.launches += 1
    return out


cluster_spgemm_windows.launches = 0


def cluster_spgemm_windows_plain(w: Windows, a_values: torch.Tensor,
                                 b_tiles: torch.Tensor,
                                 cols: SlabColumns | None = None
                                 ) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spgemm_windows`, on any
    device: each pair's visits to its slab's live columns (B tile rows
    gathered in chunks, fp32) ``index_add_``ed into their windows, NaN
    where a slab's dead column meets a non-finite value of its tile (as
    the whole-slab product gives)."""
    _check(w, a_values, b_tiles)
    cols = columns_for(a_values, cols)
    dev = a_values.device
    out = torch.zeros(w.out_shape, dtype=torch.float32, device=dev)
    counts = (w.win_ptr[1:] - w.win_ptr[:-1]).long()
    pair_win = torch.repeat_interleave(
        torch.arange(w.nwin, device=dev), counts)
    return _column_sum_plain(pair_win, w.win_out, w.slots, w.a_idx, cols,
                             b_tiles, out, block_r=w.block_r, bn=w.bn,
                             ldc=w.ldc)


def _kernel_fn(lib_name: str, fn_base: str, b_tiles: torch.Tensor,
               argtypes: list):
    """The library entry point for B's dtype, with its ctypes signature."""
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_base + ("_bf16" if b_tiles.dtype == torch.bfloat16
                                 else "_f32"))
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _raise_on(rc: int, lib, lib_name: str, what: str) -> None:
    """Turn a launch's CUDA error code into a :class:`RuntimeError`."""
    if rc != 0:
        err = getattr(lib, lib_name + "_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} launch failed: {err(rc).decode()}")


def census_tiles(work, cols: SlabColumns) -> torch.Tensor:
    """The B tile slots that a launch (:class:`Windows`,
    :class:`Segments` or :class:`PaddedGrid`) meets through a slab with a
    dead column — the only tiles whose non-finite values the live-column
    walk could miss — sorted, int32, on the launch's device. They depend
    on A's pattern and B's tile table, not on B's values: build them once
    per pack (one host sync), as the live columns are; every launch then
    counts the non-finite values of these tiles
    (``csrc/nonfinite.cuh``)."""
    ncol = cols.col_ptr[1:] - cols.col_ptr[:-1]
    dead = ncol < cols.block_k
    if isinstance(work, PaddedGrid):
        steps = torch.nonzero(dead).view(-1)
        rows = work.table.view(-1, work.nnb)
        found = [work.table.new_zeros(0)]
        chunk = max(1, (1 << 24) // max(work.nnb, 1))
        for lo in range(0, int(steps.shape[0]), chunk):
            sl = rows[work.tile_ids[steps[lo:lo + chunk]].long()]
            found.append(torch.unique(sl[sl > 0]))
        slots = torch.unique(torch.cat(found))
    else:
        slots = torch.unique(work.slots[dead[work.a_idx.long()]])
    return slots.int().contiguous()


def _census(work, cols, census, b_tiles):
    """``census`` (the launch's :func:`census_tiles`) checked, or built
    here, and the census's scratch for a launch over ``b_tiles``: a flag,
    then the slots' per-column counts (the kernel's library fills it)."""
    if census is None:
        census = census_tiles(work, cols)
    elif census.device != b_tiles.device or census.dtype != torch.int32:
        raise ValueError(f"census tiles ({census.dtype} on {census.device})"
                         f" must be int32 on {b_tiles.device}")
    cap, _, bn = b_tiles.shape
    scratch = torch.empty(1 + cap * bn, dtype=torch.int32,
                          device=b_tiles.device)
    return census, scratch


def _on_card(what: str, out: torch.Tensor, block_r: int, bn: int) -> None:
    if out.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {out.device}; the kernel runs "
                         "on CUDA, the plain version on the CPU")
    if block_r != KERNEL_BLOCK_R or bn > KERNEL_MAX_BN:
        raise ValueError(f"kernel takes block_r={KERNEL_BLOCK_R} and "
                         f"bn <= {KERNEL_MAX_BN}, got block_r={block_r}, "
                         f"bn={bn}")


def _launch(w: Windows, a_values, b_tiles, out, cols, census, *,
            what: str) -> bool:
    """Launch the window kernel over the slabs' live columns: one CTA per
    window, in ``w.order``, after the non-finite census of B's tiles.
    False when nothing is live (C stays zero and no kernel runs)."""
    _on_card(what, out, w.block_r, w.bn)
    cols = columns_for(a_values, cols)
    b_tiles = b_tiles.contiguous()
    if w.nwin == 0:
        return False
    census, scratch = _census(w, cols, census, b_tiles)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    args = [w.win_ptr.data_ptr(), w.win_out.data_ptr(), w.slots.data_ptr(),
            w.a_idx.data_ptr(), cols.col_ptr.data_ptr(),
            cols.col_k.data_ptr(), cols.col_vals.data_ptr(),
            b_tiles.data_ptr(), out.data_ptr(), census.data_ptr(),
            int(census.shape[0]), scratch.data_ptr(), b_tiles.shape[0],
            w.nwin, w.npairs, a_values.shape[2], w.bn, w.ldc, stream]
    types = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_void_p])
    if w.order is not None and w.order.device != out.device:
        raise ValueError(f"window order on {w.order.device}, operands "
                         f"on {out.device}")
    order = None if w.order is None else w.order.data_ptr()
    lib, fn = _kernel_fn("cluster_spgemm", "cluster_spgemm_windows",
                         b_tiles, [ctypes.c_void_p] + types)
    _raise_on(fn(order, *args), lib, "cluster_spgemm", what)
    return True


# ---------------------------------------------------------------------------
# the padded per-tile grid (K6): cluster_spgemm_tiled / _resident
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PaddedGrid:
    """The padded per-tile grid's launch: A's compact stream split by
    block (``block_ptr[b] .. block_ptr[b+1]`` are block ``b``'s steps, the
    stream covering every block), each step's k-tile, B's tile table and
    the live output tiles — ``blk * nnb + j`` ascending for every
    ``(blk, j)`` with a step of block ``blk`` whose slot
    ``table[tile_ids[s] * nnb + j]`` is live; every other tile of C is
    zero. Output tile ``(blk, j)`` sits at rows ``blk * block_r``, columns
    ``j * bn`` of the ``(nblocks * block_r, nnb * bn)`` C."""

    block_ptr: torch.Tensor    # (nblocks+1,) int32
    tile_ids: torch.Tensor     # (S,) int32 A k-tile per stream step
    table: torch.Tensor        # (nkb * nnb,) int32 B tile slots, 0 = dead
    live_tiles: torch.Tensor   # (T,) int32 blk * nnb + j, ascending
    nnb: int
    block_r: int
    bn: int

    @property
    def nblocks(self) -> int:
        return int(self.block_ptr.shape[0]) - 1

    @property
    def out_shape(self) -> tuple:
        return (self.nblocks * self.block_r, self.nnb * self.bn)


def padded_grid(block_ids, tile_ids, table, *, nblocks: int, nnb: int,
                block_r: int, bn: int, device) -> PaddedGrid:
    """Pack the padded grid from A's compact stream (``block_ids``
    non-decreasing and covering every block, as
    ``bcc_compact_stream(cover_all_blocks=True)`` emits it) and B's tile
    table, with the live output tiles found by torch ops on ``device``
    (one host sync: call it at pack time, not per launch)."""
    block_ids = np.asarray(block_ids, dtype=np.int64)
    block_ptr = np.searchsorted(block_ids, np.arange(nblocks + 1),
                                side="left").astype(np.int32)
    if nblocks * nnb > 0x7FFFFFFF:
        raise ValueError(f"{nblocks} x {nnb} output tiles overflow int32")
    if not isinstance(table, torch.Tensor):
        table = torch.from_numpy(np.array(table, dtype=np.int32))
    table = table.to(device).int().contiguous()
    tile_ids = torch.from_numpy(np.array(tile_ids, dtype=np.int32)).to(
        device)
    blocks = torch.from_numpy(block_ids).to(device)
    # live[blk, j]: the block has a step whose B tile (its k-tile, j) is live
    live = torch.zeros((nblocks, nnb), dtype=torch.int32, device=device)
    rows = table.view(-1, nnb)
    chunk = max(1, (1 << 24) // max(nnb, 1))
    for lo in range(0, int(tile_ids.shape[0]), chunk):
        hi = lo + chunk
        live.index_add_(0, blocks[lo:hi],
                        (rows[tile_ids[lo:hi].long()] > 0).int())
    return PaddedGrid(
        block_ptr=torch.from_numpy(block_ptr).to(device), tile_ids=tile_ids,
        table=table,
        live_tiles=torch.nonzero(live.view(-1) > 0).view(-1).int(),
        nnb=nnb, block_r=block_r, bn=bn)


def _check_grid(g: PaddedGrid, a_values, b_tiles) -> None:
    _check_operands(g.block_r, g.bn, a_values, b_tiles, g.block_ptr,
                    g.tile_ids, g.table, g.live_tiles)
    if g.tile_ids.shape[0] != a_values.shape[0]:
        raise ValueError(f"tile_ids has {g.tile_ids.shape[0]} steps, "
                         f"a_values {a_values.shape[0]}")


def cluster_spgemm_padded(g: PaddedGrid, a_values: torch.Tensor,
                          b_tiles: torch.Tensor,
                          cols: SlabColumns | None = None,
                          census: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """C = A_bcc @ B_tiled on the padded per-tile grid: every tile
    ``(blk, j)`` is the s-ascending sum over block ``blk``'s steps ``s``
    with a live ``slot = table[tile_ids[s] * nnb + j]`` of
    ``a_values[s] @ b_tiles[slot]``, returned in B's dtype and rounded as
    the JAX package's padded kernels round it: each step's fp32 product is
    rounded to B's dtype and added to the running tile, which is rounded
    again (with fp32 tiles, the plain fp32 sum). ``cols`` is the slabs'
    live-column form (:func:`slab_columns`) and ``census`` the grid's
    :func:`census_tiles`, both built here when absent — callers that
    launch again keep them; the kernel multiplies only the live columns
    (and gives the whole slabs' NaN where a dead one meets inf or NaN).

    CUDA tensors launch the hand-written kernel (and add one to
    ``cluster_spgemm_padded.launches``); CPU tensors run the plain
    version; any other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spgemm_padded_plain(g, a_values, b_tiles)
    _check_grid(g, a_values, b_tiles)
    cols = columns_for(a_values, cols)
    out = torch.empty(g.out_shape, dtype=b_tiles.dtype,
                      device=a_values.device)
    _on_card("cluster_spgemm_padded", out, g.block_r, g.bn)
    b_tiles = b_tiles.contiguous()
    census, scratch = _census(g, cols, census, b_tiles)
    lib, fn = _kernel_fn(
        "cluster_spgemm_padded", "cluster_spgemm_padded", b_tiles,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_longlong, ctypes.c_void_p])
    stream = torch.cuda.current_stream(out.device).cuda_stream
    # the zero-fill of C, the non-finite census, then one CTA per live tile
    rc = fn(g.block_ptr.data_ptr(), g.tile_ids.data_ptr(),
            g.table.data_ptr(), g.live_tiles.data_ptr(),
            int(g.live_tiles.shape[0]), cols.col_ptr.data_ptr(),
            cols.col_k.data_ptr(), cols.col_vals.data_ptr(),
            b_tiles.data_ptr(), out.data_ptr(), census.data_ptr(),
            int(census.shape[0]), scratch.data_ptr(), b_tiles.shape[0],
            g.nblocks, g.nnb, a_values.shape[2], g.bn, g.nnb * g.bn, stream)
    _raise_on(rc, lib, "cluster_spgemm_padded", "cluster_spgemm_padded")
    cluster_spgemm_padded.launches += 1
    return out


cluster_spgemm_padded.launches = 0


def cluster_spgemm_padded_plain(g: PaddedGrid, a_values: torch.Tensor,
                                b_tiles: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spgemm_padded`, on any
    device: looks every step up in B's table for every ``j`` (in chunks
    of steps), keeps the live ``(s, j)`` pairs s-major, and sums them per
    tile with ``torch.bmm`` — with ``index_add_`` in fp32 for fp32 tiles,
    rank by rank with the per-step rounding for bf16 tiles."""
    _check_grid(g, a_values, b_tiles)
    dev = a_values.device
    out = torch.zeros(g.out_shape, dtype=b_tiles.dtype, device=dev)
    nsteps = int(g.tile_ids.shape[0])
    blk_of_step = torch.repeat_interleave(
        torch.arange(g.nblocks, device=dev),
        (g.block_ptr[1:] - g.block_ptr[:-1]).long())
    js = torch.arange(g.nnb, device=dev)
    steps, slots, keys = [], [], []
    chunk = max(1, (1 << 24) // g.nnb)
    for lo in range(0, nsteps, chunk):
        hi = min(lo + chunk, nsteps)
        sl = g.table[g.tile_ids[lo:hi].long()[:, None] * g.nnb + js]
        s_i, j_i = torch.nonzero(sl > 0, as_tuple=True)   # s-major
        steps.append(s_i + lo)
        slots.append(sl[s_i, j_i])
        keys.append(blk_of_step[s_i + lo] * g.nnb + j_i)
    step = torch.cat(steps)
    key = torch.cat(keys)
    ukey, pair_tile = torch.unique(key, return_inverse=True)
    ldc = g.nnb * g.bn
    tile_out = (ukey // g.nnb) * (g.block_r * ldc) + (ukey % g.nnb) * g.bn
    tile_sum = (_tile_sum_plain if b_tiles.dtype == torch.float32
                else _ranked_sum_plain)
    return tile_sum(pair_tile, tile_out, torch.cat(slots), step, a_values,
                    b_tiles, out, block_r=g.block_r, bn=g.bn, ldc=ldc)


# ---------------------------------------------------------------------------
# the revisit order (K7) and the sharded stream (K8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segments:
    """A revisit-ordered live-pair stream, ready to launch.

    ``seg_ptr[g] .. seg_ptr[g+1]`` are segment ``g``'s pairs: the live
    pairs of one window of ``window_blocks`` row blocks and one column
    strip ``j`` — or of one sub-range of the window's blocks
    (:func:`segment_blocks`), where the window is wider than the kernel's
    accumulator — in the stream's (slot, block) order. The segment's C
    strip starts at flat offset ``seg_out[g]`` (rows ``ldc`` apart) and
    spans ``seg_nblk[g]`` blocks; pair ``p`` adds to block ``rows[p]`` of
    it. ``shard_ptr`` records where each shard's range of segments
    starts, and CTA ``x`` runs segment ``order[x]``: shard by shard,
    column strip by column strip within each."""

    seg_ptr: torch.Tensor      # (G+1,) int32
    seg_out: torch.Tensor      # (G,) int64
    seg_nblk: torch.Tensor     # (G,) int32
    rows: torch.Tensor         # (P,) int32 block within the segment
    slots: torch.Tensor        # (P,) int32
    a_idx: torch.Tensor        # (P,) int32
    shard_ptr: torch.Tensor    # (nshards+1,) int32
    order: torch.Tensor        # (G,) int32 launch order
    window_blocks: int
    max_nblk: int              # widest segment, in blocks
    ntiles: int                # live (block, j) tiles of C
    out_shape: tuple
    ldc: int
    block_r: int
    bn: int

    @property
    def nseg(self) -> int:
        return int(self.seg_out.shape[0])

    @property
    def npairs(self) -> int:
        return int(self.slots.shape[0])


# bytes of a segment's accumulator in the revisit kernel's shared memory
# (csrc/cluster_spgemm_revisit.cu sizes it from the segments): 4 blocks at
# bn = 128, so that a narrow B's wide windows still give the card many CTAs
KERNEL_SEG_ACC_BYTES = 16 * 1024


def segment_blocks(block_r: int, bn: int) -> int:
    """Row blocks of one segment: as many ``(block_r, bn)`` fp32 strips
    as the revisit kernel's accumulator holds."""
    return max(1, KERNEL_SEG_ACC_BYTES // (block_r * bn * 4))


def _shard_strip_order(shard_ptr: np.ndarray, js: np.ndarray,
                       blks: np.ndarray) -> np.ndarray:
    """The launch order of items listed shard by shard (``shard_ptr``
    ranges): shard-major, then by column strip ``js``, then first block
    ``blks``."""
    shard = np.repeat(np.arange(shard_ptr.size - 1), np.diff(shard_ptr))
    return np.lexsort((blks, js, shard)).astype(np.int32)


def segments_from_shards(ranges, shard_pairs, *, window_blocks: int,
                         nblocks: int, nnb: int, block_r: int, bn: int,
                         device) -> Segments:
    """Segment a partition of revisit-ordered sub-streams (each shard's
    ``revisit_pair_stream`` with ``block_base`` = its first block) by
    (window, j) and, where a window has more than
    :func:`segment_blocks` blocks, by sub-range of them: a stable
    regrouping, so each segment keeps the stream's order and every
    ``(block, j)`` its slot order. Zero-slot sentinels and tail pads are
    dropped."""
    ldc = nnb * bn
    sub = min(segment_blocks(block_r, bn), window_blocks)
    nparts = -(-window_blocks // sub)
    seg_ptr, seg_out, seg_nblk, seg_j, seg_blk0 = [0], [], [], [], []
    rows, slots, a_idx, shard_ptr = [], [], [], [0]
    npairs = 0
    tile_live = np.zeros(nblocks * nnb, bool)
    for (start, end), pairs in zip(np.asarray(ranges, dtype=np.int64),
                                   shard_pairs):
        blocks, js, sl, ai = (np.asarray(p).astype(np.int64) for p in pairs)
        live = sl > 0
        blocks, js, sl, ai = blocks[live], js[live], sl[live], ai[live]
        tile_live[blocks * nnb + js] = True
        local = blocks - start
        win = local // window_blocks
        key = ((win * nnb + js) * nparts
               + (local - win * window_blocks) // sub)
        o = np.argsort(key, kind="stable")
        blocks, sl, ai, key = blocks[o], sl[o], ai[o], key[o]
        first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) \
            if key.size else np.zeros(0, np.int64)
        fkey = key[first]
        fwin = fkey // (nnb * nparts)
        fj = fkey // nparts % nnb
        blk0 = start + fwin * window_blocks + fkey % nparts * sub
        wend = np.minimum(start + (fwin + 1) * window_blocks, end)
        counts = np.diff(np.r_[first, key.size])
        seg_ptr.extend((npairs + np.cumsum(counts)).tolist())
        seg_out.append(blk0 * block_r * ldc + fj * bn)
        seg_nblk.append(np.minimum(blk0 + sub, wend) - blk0)
        seg_j.append(fj)
        seg_blk0.append(blk0)
        rows.append(blocks - np.repeat(blk0, counts))
        slots.append(sl)
        a_idx.append(ai)
        shard_ptr.append(shard_ptr[-1] + first.size)
        npairs += key.size

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def dev(arr, dtype):
        return torch.from_numpy(np.asarray(arr).astype(dtype)).to(device)

    shard_ptr = np.asarray(shard_ptr, np.int64)
    nblk = cat(seg_nblk)
    return Segments(
        seg_ptr=dev(seg_ptr, np.int32), seg_out=dev(cat(seg_out), np.int64),
        seg_nblk=dev(nblk, np.int32), rows=dev(cat(rows), np.int32),
        slots=dev(cat(slots), np.int32), a_idx=dev(cat(a_idx), np.int32),
        shard_ptr=dev(shard_ptr, np.int32),
        order=dev(_shard_strip_order(shard_ptr, cat(seg_j), cat(seg_blk0)),
                  np.int32),
        window_blocks=int(window_blocks),
        max_nblk=int(nblk.max()) if nblk.size else 0,
        ntiles=int(tile_live.sum()), out_shape=(nblocks * block_r, ldc),
        ldc=ldc, block_r=block_r, bn=bn)


def _check_segments(g: Segments, a_values, b_tiles) -> None:
    _check_operands(g.block_r, g.bn, a_values, b_tiles, g.seg_ptr,
                    g.seg_out, g.seg_nblk, g.rows, g.slots, g.a_idx,
                    g.shard_ptr, g.order)


def _launch_segments(g: Segments, a_values, b_tiles, out, cols, census, *,
                     what: str) -> bool:
    """Launch the revisit kernel over the slabs' live columns, one CTA per
    segment of every shard, in ``g.order``, after the non-finite census of
    B's tiles. False when nothing is live."""
    _on_card(what, out, g.block_r, g.bn)
    cols = columns_for(a_values, cols)
    b_tiles = b_tiles.contiguous()
    if g.nseg == 0:
        return False
    census, scratch = _census(g, cols, census, b_tiles)
    lib, fn = _kernel_fn(
        "cluster_spgemm_revisit", "cluster_spgemm_revisit", b_tiles,
        [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 7 + [ctypes.c_longlong, ctypes.c_void_p])
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = fn(g.order.data_ptr(), g.seg_ptr.data_ptr(), g.seg_out.data_ptr(),
            g.seg_nblk.data_ptr(), g.rows.data_ptr(), g.slots.data_ptr(),
            g.a_idx.data_ptr(), cols.col_ptr.data_ptr(),
            cols.col_k.data_ptr(), cols.col_vals.data_ptr(),
            b_tiles.data_ptr(), out.data_ptr(), census.data_ptr(),
            int(census.shape[0]), scratch.data_ptr(), b_tiles.shape[0],
            g.nseg, g.npairs, g.ntiles, g.max_nblk, a_values.shape[2], g.bn,
            g.ldc, stream)
    _raise_on(rc, lib, "cluster_spgemm_revisit", what)
    return True


def cluster_spgemm_revisit(g: Segments, a_values: torch.Tensor,
                           b_tiles: torch.Tensor,
                           cols: SlabColumns | None = None,
                           census: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """C = A_bcc @ B_tiled over a revisit-ordered stream: every segment's
    pairs added to their blocks of its strip, per element in slot
    (= A-stream) order — the window kernel's sums, bit for bit. Returns
    the zero-filled fp32 ``g.out_shape`` C. ``cols`` is the slabs'
    live-column form (:func:`slab_columns`) and ``census`` the segments'
    :func:`census_tiles`, both built here when absent — callers that
    launch again keep them.

    CUDA tensors launch the hand-written kernel (one CTA per segment; add
    one to ``cluster_spgemm_revisit.launches``); CPU tensors run the plain
    version; any other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spgemm_revisit_plain(g, a_values, b_tiles)
    _check_segments(g, a_values, b_tiles)
    out = torch.zeros(g.out_shape, dtype=torch.float32,
                      device=a_values.device)
    if _launch_segments(g, a_values, b_tiles, out, cols, census,
                        what="cluster_spgemm_revisit"):
        cluster_spgemm_revisit.launches += 1
    return out


cluster_spgemm_revisit.launches = 0


def cluster_spgemm_revisit_plain(g: Segments, a_values: torch.Tensor,
                                 b_tiles: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spgemm_revisit` (and of
    its sharded launch), on any device: each pair's padded product, in
    stream order, ``index_add_``ed into its (block, j) tile. It reads the
    whole slabs, not their live columns, so it holds the kernel's
    live-column walk to the padded sum (equal on finite data)."""
    _check_segments(g, a_values, b_tiles)
    dev = a_values.device
    out = torch.zeros(g.out_shape, dtype=torch.float32, device=dev)
    counts = (g.seg_ptr[1:] - g.seg_ptr[:-1]).long()
    pair_seg = torch.repeat_interleave(torch.arange(g.nseg, device=dev),
                                       counts)
    span = max(g.max_nblk, 1)
    key = pair_seg * span + g.rows.long()
    ukey, pair_tile = torch.unique(key, return_inverse=True)
    tile_out = (g.seg_out[ukey // span]
                + (ukey % span) * (g.block_r * g.ldc))
    return _tile_sum_plain(pair_tile, tile_out, g.slots, g.a_idx, a_values,
                           b_tiles, out, block_r=g.block_r, bn=g.bn,
                           ldc=g.ldc)


def cluster_spgemm_sharded(work: Windows | Segments, a_values: torch.Tensor,
                           b_tiles: torch.Tensor,
                           cols: SlabColumns | None = None,
                           census: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """C = A_bcc @ B_tiled over a partitioned pair stream, in one launch of
    one CTA per window (``work``: :func:`windows_from_shards`' dense-strip
    windows) or per segment (:func:`segments_from_shards`' revisit
    segments) of every shard, shard-major, each shard column strip by
    column strip. Shards own disjoint block ranges, so the result is the
    unsharded kernel's, bit for bit. Returns the zero-filled fp32 C.
    ``cols`` is the slabs' live-column form and ``census`` the launch's
    :func:`census_tiles`, both built here when absent.

    CUDA tensors launch the hand-written kernel (and add one to
    ``cluster_spgemm_sharded.launches``); CPU tensors run the plain
    version; any other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spgemm_sharded_plain(work, a_values, b_tiles, cols)
    if work.shard_ptr is None:
        raise ValueError("cluster_spgemm_sharded needs a shard_ptr")
    out = torch.zeros(work.out_shape, dtype=torch.float32,
                      device=a_values.device)
    if isinstance(work, Segments):
        _check_segments(work, a_values, b_tiles)
        launched = _launch_segments(work, a_values, b_tiles, out, cols,
                                    census, what="cluster_spgemm_sharded")
    else:
        _check(work, a_values, b_tiles)
        launched = _launch(work, a_values, b_tiles, out, cols, census,
                           what="cluster_spgemm_sharded")
    if launched:
        cluster_spgemm_sharded.launches += 1
    return out


cluster_spgemm_sharded.launches = 0


def cluster_spgemm_sharded_plain(work: Windows | Segments,
                                 a_values: torch.Tensor,
                                 b_tiles: torch.Tensor,
                                 cols: SlabColumns | None = None
                                 ) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spgemm_sharded`: the
    shards split the work, not the sum, so it is the windows' or the
    segments' plain version."""
    if isinstance(work, Segments):
        return cluster_spgemm_revisit_plain(work, a_values, b_tiles)
    return cluster_spgemm_windows_plain(work, a_values, b_tiles, cols)
