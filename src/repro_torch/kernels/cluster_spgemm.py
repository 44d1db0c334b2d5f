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
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build

__all__ = ["Windows", "windows_from_pairs", "cluster_spgemm_windows",
           "cluster_spgemm_windows_plain"]

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
    """

    win_ptr: torch.Tensor      # (W+1,) int32
    win_out: torch.Tensor      # (W,) int64
    slots: torch.Tensor        # (P,) int32 B tile slot per pair
    a_idx: torch.Tensor        # (P,) int32 A stream index per pair
    out_shape: tuple
    ldc: int
    block_r: int
    bn: int

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


def _check(w: Windows, a_values: torch.Tensor, b_tiles: torch.Tensor):
    if a_values.dim() != 3 or a_values.shape[1] != w.block_r:
        raise ValueError(f"a_values {tuple(a_values.shape)} is not "
                         f"(S, {w.block_r}, block_k)")
    if b_tiles.dim() != 3 or b_tiles.shape[1:] != (a_values.shape[2], w.bn):
        raise ValueError(f"b_tiles {tuple(b_tiles.shape)} is not "
                         f"(cap, {a_values.shape[2]}, {w.bn})")
    if a_values.dtype != torch.float32:
        raise ValueError(f"a_values must be float32, got {a_values.dtype}")
    if b_tiles.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"b_tiles must be float32 or bfloat16, got "
                         f"{b_tiles.dtype}")
    devs = {t.device for t in (a_values, b_tiles, w.win_ptr, w.win_out,
                               w.slots, w.a_idx)}
    if len(devs) != 1:
        raise ValueError(f"operands span devices {sorted(map(str, devs))}")


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
    _launch(w, a_values, b_tiles, out)
    return out


cluster_spgemm_windows.launches = 0


def cluster_spgemm_windows_plain(w: Windows, a_values: torch.Tensor,
                                 b_tiles: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spgemm_windows`, on any
    device: gathers ``A[a_idx]`` and ``B[slot]`` in chunks, multiplies
    them with ``torch.bmm`` in fp32 and ``index_add_``s the products into
    their windows. (On a card ``index_add_`` adds with atomics, so float
    sums may differ in the last bits run to run.)"""
    _check(w, a_values, b_tiles)
    dev = a_values.device
    out = torch.zeros(w.out_shape, dtype=torch.float32, device=dev)
    if w.nwin == 0:
        return out
    block_k = a_values.shape[2]
    counts = (w.win_ptr[1:] - w.win_ptr[:-1]).long()
    pair_win = torch.repeat_interleave(
        torch.arange(w.nwin, device=dev), counts)
    acc = torch.zeros((w.nwin, w.block_r, w.bn), dtype=torch.float32,
                      device=dev)
    chunk = max(1, (1 << 27) // (block_k * w.bn))  # ~512 MiB of B tiles
    for lo in range(0, w.npairs, chunk):
        hi = min(lo + chunk, w.npairs)
        prod = torch.bmm(a_values[w.a_idx[lo:hi].long()],
                         b_tiles[w.slots[lo:hi].long()].float())
        acc.index_add_(0, pair_win[lo:hi], prod)
    # place each window at its origin: rows ldc apart, bn contiguous
    within = (torch.arange(w.block_r, device=dev)[:, None] * w.ldc
              + torch.arange(w.bn, device=dev)[None, :])
    flat = out.view(-1)
    wchunk = max(1, (1 << 24) // (w.block_r * w.bn))
    for lo in range(0, w.nwin, wchunk):
        hi = min(lo + wchunk, w.nwin)
        idx = w.win_out[lo:hi, None, None] + within
        flat[idx.reshape(-1)] = acc[lo:hi].reshape(-1)
    return out


def _launch(w: Windows, a_values, b_tiles, out) -> None:
    if out.device.type != "cuda":
        raise ValueError(f"cluster_spgemm_windows: tensors on "
                         f"{out.device}; the kernel runs on CUDA, the "
                         "plain version on the CPU")
    if w.block_r != KERNEL_BLOCK_R or w.bn > KERNEL_MAX_BN:
        raise ValueError(f"kernel takes block_r={KERNEL_BLOCK_R} and "
                         f"bn <= {KERNEL_MAX_BN}, got block_r={w.block_r}, "
                         f"bn={w.bn}")
    a_values = a_values.contiguous()
    b_tiles = b_tiles.contiguous()
    if w.nwin == 0:
        return                               # nothing live: C stays zero
    lib = _build.load("cluster_spgemm")
    fn = (lib.cluster_spgemm_windows_bf16 if b_tiles.dtype == torch.bfloat16
          else lib.cluster_spgemm_windows_f32)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = fn(w.win_ptr.data_ptr(), w.win_out.data_ptr(), w.slots.data_ptr(),
            w.a_idx.data_ptr(), a_values.data_ptr(), b_tiles.data_ptr(),
            out.data_ptr(), w.nwin, a_values.shape[2], w.bn, w.ldc, stream)
    if rc != 0:
        lib.cluster_spgemm_error_string.restype = ctypes.c_char_p
        lib.cluster_spgemm_error_string.argtypes = [ctypes.c_int]
        msg = lib.cluster_spgemm_error_string(rc).decode()
        raise RuntimeError(f"cluster_spgemm_windows launch failed: {msg}")
    cluster_spgemm_windows.launches += 1
