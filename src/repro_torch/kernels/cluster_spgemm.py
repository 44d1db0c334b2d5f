"""Cluster-wise sparse × sparse SpGEMM on the card: the window kernel.

C = A_bcc · B_tiled, with A packed in BCC (``block_r``-row blocks of
dense ``(block_r, block_k)`` slabs, streamed compactly) and B in
``TiledCSR`` (dense ``(block_k, bn)`` live tiles). The host intersects
the two into a live-pair stream (``core/formats.py::live_pair_stream``);
this module regroups it *window-major* — one entry per live ``(blk, j)``
window of C, its pairs s-ascending — and hands it to one kernel
(``csrc/cluster_spgemm.cu``) that gives each window to one CTA and writes
the window once: into a strip of a dense C, or into one slab of the
``CompactedC`` store. That single kernel is the counterpart of the JAX
package's five pair kernels (``cluster_spgemm_pairs{,_resident,_db}``,
dense strips; ``cluster_spgemm_pairs_sparse{,_db}``, slabs), which differ
only in VMEM placement and output addressing.

:func:`windows_from_pairs` packs the launch once, from the (block, s, j)
stream of ``live_pair_stream``, for either output: dense strips, or
CompactedC slabs placed through the ``compacted_c_table`` lookup table.
:func:`cluster_spgemm_windows` is the wrapper: on a CUDA tensor it
launches the kernel (counting the launch in its ``launches`` attribute)
or raises; on a CPU tensor it runs :func:`cluster_spgemm_windows_plain`,
the same sum written with ``torch.bmm`` and ``index_add_``.

Three more launches serve the JAX package's other pair-grid kernels, each
with the same wrapper contract and a plain version beside it:

* :func:`cluster_spgemm_padded` (``csrc/cluster_spgemm_padded.cu``) — the
  padded per-tile grid (``cluster_spgemm_tiled`` / ``_resident``) for B
  too wide for the live-pair grid: one CTA per C tile, the B table lookup
  in the kernel, output in B's dtype;
* :func:`cluster_spgemm_revisit` (``csrc/cluster_spgemm_revisit.cu``) —
  ``cluster_spgemm_pairs_window`` over a revisit-ordered stream: one CTA
  per (window, j) segment, each B tile staged once per run of blocks;
* :func:`cluster_spgemm_sharded` — ``cluster_spgemm_pairs_sharded``: one
  persistent CTA per shard of ``partition_pair_stream``, walking the
  shard's windows (window kernel) or segments (revisit kernel).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["Windows", "windows_from_pairs", "windows_from_shards",
           "cluster_spgemm_windows", "cluster_spgemm_windows_plain",
           "PaddedGrid", "padded_grid", "cluster_spgemm_padded",
           "cluster_spgemm_padded_plain", "Segments", "segments_from_shards",
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
    ``shard_ptr`` (sharded launches only) splits the windows into the
    shards' contiguous ranges.
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
                       table=None) -> Windows:
    """Regroup a (block, s, j)-ordered live-pair stream
    (``live_pair_stream``) by ``(blk, j)`` window, s ascending within each.

    Without ``table`` the output is the dense ``(nblocks * block_r,
    nnb * bn)`` C, window ``(blk, j)`` at its strip tile. With ``table``
    (``compacted_c_table``'s ``(nblocks * nnb,)`` window → slab lookup)
    the output is the ``(nslabs, block_r, bn)`` CompactedC slab store,
    window ``(blk, j)`` in slab ``table[blk * nnb + j]``; slab 0 stays
    zero."""
    keys = (torch.as_tensor(blocks, device=device).long() * nnb
            + torch.as_tensor(js, device=device).long())
    ukey, win_ptr, sl, ai = _group(keys, slots, a_idx, device)
    if table is None:
        ldc = nnb * bn
        win_out = (ukey // nnb) * (block_r * ldc) + (ukey % nnb) * bn
        out_shape = (nblocks * block_r, ldc)
    else:
        table = torch.as_tensor(table, device=device).long()
        ldc = bn
        win_out = table[ukey] * (block_r * bn)
        nslabs = int(table.max()) + 1 if table.numel() else 1
        out_shape = (nslabs, block_r, bn)
    return Windows(win_ptr=win_ptr, win_out=win_out, slots=sl, a_idx=ai,
                   out_shape=out_shape, ldc=ldc, block_r=block_r, bn=bn)


def windows_from_shards(ranges, shard_pairs, *, nblocks: int, nnb: int,
                        block_r: int, bn: int, device) -> Windows:
    """Dense-strip windows of a partitioned pair stream
    (``partition_pair_stream``: contiguous block ranges, each sub-stream
    in (block, s, j) order), with ``shard_ptr`` marking where each shard's
    windows start — the launch of :func:`cluster_spgemm_sharded`."""
    cat = [np.concatenate([np.asarray(p[i]) for p in shard_pairs])
           for i in range(4)]
    w = windows_from_pairs(*cat, nblocks=nblocks, nnb=nnb, block_r=block_r,
                           bn=bn, device=device)
    win_blk = (w.win_out // (block_r * w.ldc)).cpu().numpy()
    starts = np.asarray(ranges, dtype=np.int64)[:, 0]
    shard_ptr = np.append(np.searchsorted(win_blk, starts, side="left"),
                          win_blk.size).astype(np.int32)
    return dataclasses.replace(w, shard_ptr=torch.from_numpy(
        shard_ptr).to(device))


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


def _tile_sum_plain(pair_tile: torch.Tensor, tile_out: torch.Tensor,
                    slots: torch.Tensor, a_idx: torch.Tensor,
                    a_values: torch.Tensor, b_tiles: torch.Tensor,
                    out: torch.Tensor, *, block_r: int, bn: int,
                    ldc: int) -> torch.Tensor:
    """The plain versions' common sum: for every pair ``p`` (in the given
    order), ``a_values[a_idx[p]] @ b_tiles[slots[p]]`` in fp32 is
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
    # place each tile at its origin: rows ldc apart, bn contiguous
    within = (torch.arange(block_r, device=dev)[:, None] * ldc
              + torch.arange(bn, device=dev)[None, :])
    flat = out.view(-1)
    tchunk = max(1, (1 << 24) // (block_r * bn))
    for lo in range(0, ntiles, tchunk):
        hi = min(lo + tchunk, ntiles)
        idx = tile_out[lo:hi, None, None] + within
        flat[idx.reshape(-1)] = acc[lo:hi].reshape(-1).to(out.dtype)
    return out


def cluster_spgemm_windows(w: Windows, a_values: torch.Tensor,
                           b_tiles: torch.Tensor) -> torch.Tensor:
    """Σ over each live window's pairs of ``a_values[a_idx] @
    b_tiles[slot]`` (fp32 accumulate; bf16 tiles upcast), written once per
    window into a zero-filled float32 output of ``w.out_shape``.

    CUDA tensors launch the hand-written kernel (and add one to
    ``cluster_spgemm_windows.launches``); CPU tensors run the plain
    version; any other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spgemm_windows_plain(w, a_values, b_tiles)
    _check(w, a_values, b_tiles)
    out = torch.zeros(w.out_shape, dtype=torch.float32,
                      device=a_values.device)
    if _launch(w, a_values, b_tiles, out, sharded=False):
        cluster_spgemm_windows.launches += 1
    return out


cluster_spgemm_windows.launches = 0


def cluster_spgemm_windows_plain(w: Windows, a_values: torch.Tensor,
                                 b_tiles: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spgemm_windows`, on any
    device: gathers ``A[a_idx]`` and ``B[slot]`` in chunks, multiplies
    them with ``torch.bmm`` in fp32 and ``index_add_``s the products into
    their windows, s ascending."""
    _check(w, a_values, b_tiles)
    dev = a_values.device
    out = torch.zeros(w.out_shape, dtype=torch.float32, device=dev)
    counts = (w.win_ptr[1:] - w.win_ptr[:-1]).long()
    pair_win = torch.repeat_interleave(
        torch.arange(w.nwin, device=dev), counts)
    return _tile_sum_plain(pair_win, w.win_out, w.slots, w.a_idx, a_values,
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


def _on_card(what: str, out: torch.Tensor, block_r: int, bn: int) -> None:
    if out.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {out.device}; the kernel runs "
                         "on CUDA, the plain version on the CPU")
    if block_r != KERNEL_BLOCK_R or bn > KERNEL_MAX_BN:
        raise ValueError(f"kernel takes block_r={KERNEL_BLOCK_R} and "
                         f"bn <= {KERNEL_MAX_BN}, got block_r={block_r}, "
                         f"bn={bn}")


def _launch(w: Windows, a_values, b_tiles, out, *, sharded: bool) -> bool:
    """Launch the window kernel: one CTA per window, or (``sharded``)
    one persistent CTA per shard. False when nothing is live (C stays
    zero and no kernel runs)."""
    what = "cluster_spgemm_sharded" if sharded else "cluster_spgemm_windows"
    _on_card(what, out, w.block_r, w.bn)
    a_values = a_values.contiguous()
    b_tiles = b_tiles.contiguous()
    if w.nwin == 0:
        return False
    stream = torch.cuda.current_stream(out.device).cuda_stream
    args = [w.win_ptr.data_ptr(), w.win_out.data_ptr(), w.slots.data_ptr(),
            w.a_idx.data_ptr(), a_values.data_ptr(), b_tiles.data_ptr(),
            out.data_ptr(), w.nwin, a_values.shape[2], w.bn, w.ldc, stream]
    types = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    if not sharded:
        lib, fn = _kernel_fn("cluster_spgemm", "cluster_spgemm_windows",
                             b_tiles, types)
    else:
        lib, fn = _kernel_fn("cluster_spgemm",
                             "cluster_spgemm_windows_sharded", b_tiles,
                             [ctypes.c_void_p, ctypes.c_int] + types)
        args = [w.shard_ptr.data_ptr(), w.shard_ptr.shape[0] - 1] + args
    _raise_on(fn(*args), lib, "cluster_spgemm", what)
    return True


# ---------------------------------------------------------------------------
# the padded per-tile grid (K6): cluster_spgemm_tiled / _resident
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PaddedGrid:
    """The padded per-tile grid's launch: A's compact stream split by
    block (``block_ptr[b] .. block_ptr[b+1]`` are block ``b``'s steps, the
    stream covering every block), each step's k-tile and B's tile table.
    Output tile ``(blk, j)`` sits at rows ``blk * block_r``, columns
    ``j * bn`` of the ``(nblocks * block_r, nnb * bn)`` C."""

    block_ptr: torch.Tensor    # (nblocks+1,) int32
    tile_ids: torch.Tensor     # (S,) int32 A k-tile per stream step
    table: torch.Tensor        # (nkb * nnb,) int32 B tile slots, 0 = dead
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
    table."""
    block_ids = np.asarray(block_ids, dtype=np.int64)
    block_ptr = np.searchsorted(block_ids, np.arange(nblocks + 1),
                                side="left").astype(np.int32)
    if not isinstance(table, torch.Tensor):
        table = torch.from_numpy(np.array(table, dtype=np.int32))
    return PaddedGrid(
        block_ptr=torch.from_numpy(block_ptr).to(device),
        tile_ids=torch.from_numpy(np.array(tile_ids, dtype=np.int32)).to(
            device),
        table=table.to(device).int().contiguous(),
        nnb=nnb, block_r=block_r, bn=bn)


def _check_grid(g: PaddedGrid, a_values, b_tiles) -> None:
    _check_operands(g.block_r, g.bn, a_values, b_tiles, g.block_ptr,
                    g.tile_ids, g.table)
    if g.tile_ids.shape[0] != a_values.shape[0]:
        raise ValueError(f"tile_ids has {g.tile_ids.shape[0]} steps, "
                         f"a_values {a_values.shape[0]}")


def cluster_spgemm_padded(g: PaddedGrid, a_values: torch.Tensor,
                          b_tiles: torch.Tensor) -> torch.Tensor:
    """C = A_bcc @ B_tiled on the padded per-tile grid: every tile
    ``(blk, j)`` is the s-ascending sum over block ``blk``'s steps ``s``
    with a live ``slot = table[tile_ids[s] * nnb + j]`` of
    ``a_values[s] @ b_tiles[slot]``, accumulated in fp32 and returned in
    B's dtype (as the JAX package's padded kernels return it).

    CUDA tensors launch the hand-written kernel (and add one to
    ``cluster_spgemm_padded.launches``); CPU tensors run the plain
    version; any other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spgemm_padded_plain(g, a_values, b_tiles)
    _check_grid(g, a_values, b_tiles)
    out = torch.empty(g.out_shape, dtype=b_tiles.dtype,
                      device=a_values.device)
    _on_card("cluster_spgemm_padded", out, g.block_r, g.bn)
    a_values = a_values.contiguous()
    b_tiles = b_tiles.contiguous()
    lib, fn = _kernel_fn(
        "cluster_spgemm_padded", "cluster_spgemm_padded", b_tiles,
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_void_p])
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = fn(g.block_ptr.data_ptr(), g.tile_ids.data_ptr(),
            g.table.data_ptr(), a_values.data_ptr(), b_tiles.data_ptr(),
            out.data_ptr(), g.nblocks, g.nnb, a_values.shape[2], g.bn,
            g.nnb * g.bn, stream)
    _raise_on(rc, lib, "cluster_spgemm_padded", "cluster_spgemm_padded")
    cluster_spgemm_padded.launches += 1
    return out


cluster_spgemm_padded.launches = 0


def cluster_spgemm_padded_plain(g: PaddedGrid, a_values: torch.Tensor,
                                b_tiles: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spgemm_padded`, on any
    device: looks every step up in B's table for every ``j`` (in chunks
    of steps), keeps the live ``(s, j)`` pairs s-major, and sums them per
    tile with ``torch.bmm`` and ``index_add_`` in fp32."""
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
    return _tile_sum_plain(pair_tile, tile_out, torch.cat(slots), step,
                           a_values, b_tiles, out, block_r=g.block_r,
                           bn=g.bn, ldc=ldc)


# ---------------------------------------------------------------------------
# the revisit order (K7) and the sharded stream (K8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segments:
    """A revisit-ordered live-pair stream, ready to launch.

    ``seg_ptr[g] .. seg_ptr[g+1]`` are segment ``g``'s pairs: the live
    pairs of one window of ``window_blocks`` row blocks and one column
    strip ``j``, in the stream's (slot, block) order. The segment's C strip
    starts at flat offset ``seg_out[g]`` (rows ``ldc`` apart) and spans
    ``seg_nblk[g]`` blocks; pair ``p`` adds to block ``rows[p]`` of it.
    ``shard_ptr`` splits the segments into the shards' ranges."""

    seg_ptr: torch.Tensor      # (G+1,) int32
    seg_out: torch.Tensor      # (G,) int64
    seg_nblk: torch.Tensor     # (G,) int32
    rows: torch.Tensor         # (P,) int32 block within the window
    slots: torch.Tensor        # (P,) int32
    a_idx: torch.Tensor        # (P,) int32
    shard_ptr: torch.Tensor    # (nshards+1,) int32
    window_blocks: int
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


def segments_from_shards(ranges, shard_pairs, *, window_blocks: int,
                         nblocks: int, nnb: int, block_r: int, bn: int,
                         device) -> Segments:
    """Segment a partition of revisit-ordered sub-streams (each shard's
    ``revisit_pair_stream`` with ``block_base`` = its first block) by
    (window, j), keeping the stream order. Zero-slot sentinels and tail
    pads are dropped."""
    ldc = nnb * bn
    seg_ptr, seg_out, seg_nblk = [0], [], []
    rows, slots, a_idx, shard_ptr = [], [], [], [0]
    npairs = 0
    for (start, end), pairs in zip(np.asarray(ranges, dtype=np.int64),
                                   shard_pairs):
        blocks, js, sl, ai = (np.asarray(p).astype(np.int64) for p in pairs)
        live = sl > 0
        blocks, js, sl, ai = blocks[live], js[live], sl[live], ai[live]
        win = (blocks - start) // window_blocks
        key = win * nnb + js
        first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) \
            if key.size else np.zeros(0, np.int64)
        blk0 = start + win[first] * window_blocks
        seg_ptr.extend((npairs + np.r_[first[1:], key.size])[
            : first.size].tolist())
        seg_out.append(blk0 * block_r * ldc + js[first] * bn)
        seg_nblk.append(np.minimum(window_blocks, end - blk0))
        rows.append(blocks - (start + win * window_blocks))
        slots.append(sl)
        a_idx.append(ai)
        shard_ptr.append(shard_ptr[-1] + first.size)
        npairs += key.size

    def dev(parts, dtype):
        arr = np.concatenate(parts) if parts else np.zeros(0)
        return torch.from_numpy(arr.astype(dtype)).to(device)

    return Segments(
        seg_ptr=dev([np.asarray(seg_ptr)], np.int32),
        seg_out=dev(seg_out, np.int64), seg_nblk=dev(seg_nblk, np.int32),
        rows=dev(rows, np.int32), slots=dev(slots, np.int32),
        a_idx=dev(a_idx, np.int32),
        shard_ptr=dev([np.asarray(shard_ptr)], np.int32),
        window_blocks=int(window_blocks),
        out_shape=(nblocks * block_r, ldc), ldc=ldc, block_r=block_r, bn=bn)


def _check_segments(g: Segments, a_values, b_tiles) -> None:
    _check_operands(g.block_r, g.bn, a_values, b_tiles, g.seg_ptr,
                    g.seg_out, g.seg_nblk, g.rows, g.slots, g.a_idx,
                    g.shard_ptr)


def _launch_segments(g: Segments, a_values, b_tiles, out, *,
                     sharded: bool) -> bool:
    """Launch the revisit kernel: one CTA per segment, or (``sharded``)
    one persistent CTA per shard. False when nothing is live."""
    what = "cluster_spgemm_sharded" if sharded else "cluster_spgemm_revisit"
    _on_card(what, out, g.block_r, g.bn)
    a_values = a_values.contiguous()
    b_tiles = b_tiles.contiguous()
    if g.nseg == 0:
        return False
    lib, fn = _kernel_fn(
        "cluster_spgemm_revisit", "cluster_spgemm_revisit", b_tiles,
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_void_p])
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = fn(g.shard_ptr.data_ptr() if sharded else None,
            g.shard_ptr.shape[0] - 1, g.seg_ptr.data_ptr(),
            g.seg_out.data_ptr(), g.seg_nblk.data_ptr(), g.rows.data_ptr(),
            g.slots.data_ptr(), g.a_idx.data_ptr(), a_values.data_ptr(),
            b_tiles.data_ptr(), out.data_ptr(), g.nseg, a_values.shape[2],
            g.bn, g.ldc, g.window_blocks, stream)
    _raise_on(rc, lib, "cluster_spgemm_revisit", what)
    return True


def cluster_spgemm_revisit(g: Segments, a_values: torch.Tensor,
                           b_tiles: torch.Tensor) -> torch.Tensor:
    """C = A_bcc @ B_tiled over a revisit-ordered stream: every segment's
    pairs added to their blocks of its window strip, per element in slot
    (= A-stream) order — the window kernel's sums, bit for bit. Returns
    the zero-filled fp32 ``g.out_shape`` C.

    CUDA tensors launch the hand-written kernel (one CTA per segment; add
    one to ``cluster_spgemm_revisit.launches``); CPU tensors run the plain
    version; any other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spgemm_revisit_plain(g, a_values, b_tiles)
    _check_segments(g, a_values, b_tiles)
    out = torch.zeros(g.out_shape, dtype=torch.float32,
                      device=a_values.device)
    if _launch_segments(g, a_values, b_tiles, out, sharded=False):
        cluster_spgemm_revisit.launches += 1
    return out


cluster_spgemm_revisit.launches = 0


def cluster_spgemm_revisit_plain(g: Segments, a_values: torch.Tensor,
                                 b_tiles: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spgemm_revisit` (and of
    its sharded launch), on any device: each pair's product, in stream
    order, ``index_add_``ed into its (block, j) tile."""
    _check_segments(g, a_values, b_tiles)
    dev = a_values.device
    out = torch.zeros(g.out_shape, dtype=torch.float32, device=dev)
    counts = (g.seg_ptr[1:] - g.seg_ptr[:-1]).long()
    pair_seg = torch.repeat_interleave(torch.arange(g.nseg, device=dev),
                                       counts)
    key = pair_seg * g.window_blocks + g.rows.long()
    ukey, pair_tile = torch.unique(key, return_inverse=True)
    tile_out = (g.seg_out[ukey // g.window_blocks]
                + (ukey % g.window_blocks) * (g.block_r * g.ldc))
    return _tile_sum_plain(pair_tile, tile_out, g.slots, g.a_idx, a_values,
                           b_tiles, out, block_r=g.block_r, bn=g.bn,
                           ldc=g.ldc)


def cluster_spgemm_sharded(work: Windows | Segments, a_values: torch.Tensor,
                           b_tiles: torch.Tensor) -> torch.Tensor:
    """C = A_bcc @ B_tiled over a partitioned pair stream, one persistent
    CTA per shard: ``work`` is :func:`windows_from_shards`' dense-strip
    windows or :func:`segments_from_shards`' revisit segments, each with
    its ``shard_ptr``. Shards own disjoint block ranges, so the result is
    the unsharded kernel's, bit for bit. Returns the zero-filled fp32 C.

    CUDA tensors launch the hand-written kernel (and add one to
    ``cluster_spgemm_sharded.launches``); CPU tensors run the plain
    version; any other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spgemm_sharded_plain(work, a_values, b_tiles)
    if work.shard_ptr is None:
        raise ValueError("cluster_spgemm_sharded needs a shard_ptr")
    out = torch.zeros(work.out_shape, dtype=torch.float32,
                      device=a_values.device)
    if isinstance(work, Segments):
        _check_segments(work, a_values, b_tiles)
        launched = _launch_segments(work, a_values, b_tiles, out,
                                    sharded=True)
    else:
        _check(work, a_values, b_tiles)
        launched = _launch(work, a_values, b_tiles, out, sharded=True)
    if launched:
        cluster_spgemm_sharded.launches += 1
    return out


cluster_spgemm_sharded.launches = 0


def cluster_spgemm_sharded_plain(work: Windows | Segments,
                                 a_values: torch.Tensor,
                                 b_tiles: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spgemm_sharded`: the
    shards split the work, not the sum, so it is the windows' or the
    segments' plain version."""
    if isinstance(work, Segments):
        return cluster_spgemm_revisit_plain(work, a_values, b_tiles)
    return cluster_spgemm_windows_plain(work, a_values, b_tiles)
