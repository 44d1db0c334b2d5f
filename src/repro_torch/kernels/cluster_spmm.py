"""Cluster-wise SpMM on the card: C = A_bcc @ B with B dense (tall-skinny).

A is BCC's compact (block, tile) stream — ``block_ids`` non-decreasing,
``tile_ids`` the k-tile each slab multiplies, empty blocks carrying one
zero slab and the tail padded with zero slabs. The kernel
(``csrc/cluster_spmm.cu``, the counterpart of the JAX package's
``cluster_spmm_compact``) gives each (row block, column strip) to one CTA,
which walks its block's segment of the stream and writes its strip once.

:func:`cluster_spmm_compact` is the wrapper: on a CUDA tensor it launches
the kernel (counting the launch in its ``launches`` attribute) or raises;
on a CPU tensor it runs :func:`cluster_spmm_compact_plain`, the same sum
written with ``torch.bmm`` and ``index_add_``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["cluster_spmm_compact", "cluster_spmm_compact_plain"]

KERNEL_BLOCK_R = 8
KERNEL_MAX_BN = 128


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
    if a_values.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("a_values and b must be float32")
    return block_ids, tile_ids


def cluster_spmm_compact(block_ids, tile_ids, a_values: torch.Tensor,
                         b: torch.Tensor, *, block_r: int, block_k: int,
                         nblocks: int, bn: int = 128) -> torch.Tensor:
    """C = A_bcc @ B over the compact stream. ``b`` is ``(K, N)`` fp32
    (rows past K and the ragged last column strip are masked, no padding
    needed); ``bn`` is the kernel's column-strip width (≤ 128). Returns
    ``(nblocks * block_r, N)`` fp32; blocks with no step in the stream
    are zero.

    CUDA tensors launch the hand-written kernel (and add one to
    ``cluster_spmm_compact.launches``); CPU tensors run the plain version;
    any other device raises."""
    if a_values.device.type == "cpu":
        return cluster_spmm_compact_plain(block_ids, tile_ids, a_values, b,
                                          block_r=block_r, block_k=block_k,
                                          nblocks=nblocks)
    block_ids, tile_ids = _operands(block_ids, tile_ids, a_values, b,
                                    block_r=block_r, block_k=block_k)
    return _launch(block_ids, tile_ids, a_values, b, block_r=block_r,
                   block_k=block_k, nblocks=nblocks, bn=bn)


cluster_spmm_compact.launches = 0


def cluster_spmm_compact_plain(block_ids, tile_ids, a_values: torch.Tensor,
                               b: torch.Tensor, *, block_r: int,
                               block_k: int, nblocks: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`cluster_spmm_compact`, on any
    device: B's row bands gathered per step in chunks, ``torch.bmm`` in
    fp32 against the slabs, ``index_add_`` into the owning block."""
    block_ids, tile_ids = _operands(block_ids, tile_ids, a_values, b,
                                    block_r=block_r, block_k=block_k)
    k, n = b.shape
    bands = F.pad(b, (0, 0, 0, (-k) % block_k)).view(-1, block_k, n)
    c = torch.zeros((nblocks, block_r, n), dtype=torch.float32,
                    device=b.device)
    chunk = max(1, (1 << 26) // (block_k * max(n, 1)))
    for lo in range(0, a_values.shape[0], chunk):
        hi = min(lo + chunk, a_values.shape[0])
        prod = torch.bmm(a_values[lo:hi], bands[tile_ids[lo:hi].long()])
        c.index_add_(0, block_ids[lo:hi].long(), prod)
    return c.view(nblocks * block_r, n)


def _launch(block_ids, tile_ids, a_values, b, *, block_r, block_k, nblocks,
            bn):
    dev = a_values.device
    if dev.type != "cuda":
        raise ValueError(f"cluster_spmm_compact: tensors on {dev}; the "
                         "kernel runs on CUDA, the plain version on the CPU")
    if block_r != KERNEL_BLOCK_R or not 0 < bn <= KERNEL_MAX_BN:
        raise ValueError(f"kernel takes block_r={KERNEL_BLOCK_R} and "
                         f"0 < bn <= {KERNEL_MAX_BN}, got block_r={block_r}, "
                         f"bn={bn}")
    k, n = b.shape
    # zero-filled: a block the stream does not visit reads back zero
    out = torch.zeros((nblocks * block_r, n), dtype=torch.float32,
                      device=dev)
    if nblocks == 0 or n == 0:
        return out
    # each block's segment of the (block-sorted) stream
    blk_ptr = torch.searchsorted(
        block_ids, torch.arange(nblocks + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    a_values = a_values.contiguous()
    b = b.contiguous()
    lib = _build.load("cluster_spmm")
    fn = lib.cluster_spmm_compact_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(blk_ptr.data_ptr(), tile_ids.data_ptr(), a_values.data_ptr(),
            b.data_ptr(), out.data_ptr(), nblocks, block_k, k, n, bn, stream)
    if rc != 0:
        lib.cluster_spmm_error_string.restype = ctypes.c_char_p
        lib.cluster_spmm_error_string.argtypes = [ctypes.c_int]
        msg = lib.cluster_spmm_error_string(rc).decode()
        raise RuntimeError(f"cluster_spmm_compact launch failed: {msg}")
    cluster_spmm_compact.launches += 1
    return out
