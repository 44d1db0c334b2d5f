"""Sparse-weight linear layer over the BCC format: the paper's technique as
a model feature.

The counterpart of the JAX package's ``models/sparse_linear.py``. A
magnitude-pruned weight matrix is a sparse A operand; the activation
batch is the tall-skinny dense B. ``SparseLinear.from_dense`` prunes,
reorders the weight's output rows (hierarchical clustering on the
row→tile incidence by default; the permutation is undone on the way out,
so the layer is a drop-in replacement), packs BCC tiles on the requested
device and reports the tile statistics; ``apply`` runs the cluster-wise
SpMM kernel — on BCC's compact stream (``compact=True``, the default),
walked over its slabs' live columns, or on its padded lattice, in panels
of blocks that share B tiles — or the exact dense product. The compact
stream, its live columns and the lattice's panels are built once, with
the layer.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.clustering import hierarchical_clusters
from repro_torch.core.formats import BCC, HostCSR, bcc_from_host
from repro_torch.core.reorder import reorder as apply_reorder
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.cluster_spmm import SpmmPanels
from repro_torch.kernels.columns import SlabColumns

__all__ = ["SparseLinear", "magnitude_prune"]


def magnitude_prune(w: np.ndarray, density: float) -> np.ndarray:
    """Keep the largest-|w| ``density`` fraction; exact threshold split."""
    flat = np.abs(w).ravel()
    k = max(1, int(round(density * flat.size)))
    thresh = np.partition(flat, flat.size - k)[flat.size - k]
    return np.where(np.abs(w) >= thresh, w, 0.0).astype(w.dtype)


@dataclasses.dataclass
class SparseLinear:
    """y = x @ Wᵀ with W (out, in) sparse in BCC, rows cluster-reordered.

    ``perm`` maps packed output rows → original output features; apply
    inverse-permutes the result so the layer is a drop-in replacement.
    ``stream`` and ``cols`` are BCC's compact stream and its slabs' live
    columns, which the compact path launches from; ``panels`` is the
    padded lattice's panel schedule, which the padded path launches with.
    """

    bcc: BCC
    perm: np.ndarray             # (out,) packed row -> original feature
    out_features: int
    in_features: int
    stats: dict
    stream: tuple = dataclasses.field(repr=False)
    cols: SlabColumns = dataclasses.field(repr=False)
    panels: SpmmPanels = dataclasses.field(repr=False)

    @classmethod
    def from_dense(cls, w: np.ndarray, *, density: float = 0.1,
                   reorder: str = "hierarchical", block_r: int = 8,
                   block_k: int = 128, device="cuda") -> "SparseLinear":
        """Prune ``w`` (host numpy) to ``density``, reorder, and pack BCC
        tiles on ``device`` (the card unless the caller asks for the
        CPU)."""
        dev = resolve_device(device)
        out_f, in_f = w.shape
        pruned = magnitude_prune(np.asarray(w, np.float32), density)
        host = HostCSR.from_dense(pruned)
        if reorder == "hierarchical":
            # cluster on the row→TILE incidence: on BCC the reuse is per
            # block_k-wide B tile, so tile-support Jaccard is the
            # similarity that predicts the live-tile reduction
            rows = np.repeat(np.arange(host.nrows, dtype=np.int64),
                             host.row_nnz())
            tiles = host.indices.astype(np.int64) // block_k
            tile_host = HostCSR.from_coo(
                rows, tiles, np.ones_like(rows, np.float32),
                (host.nrows, (in_f + block_k - 1) // block_k))
            cl = hierarchical_clusters(tile_host)
            host_r, perm = host.permute_rows(cl.perm), cl.perm
        elif reorder in (None, "original"):
            host_r, perm = host, np.arange(out_f)
        else:
            host_r, perm = apply_reorder(host, reorder, symmetric=False)
        bcc = bcc_from_host(host_r, block_r=block_r, block_k=block_k,
                            device=dev)
        live = int(bcc.ntiles.sum())
        slabs = bcc.values.shape[0]
        # the un-reordered tile count, for the win report
        bcc0 = bcc_from_host(host, block_r=block_r, block_k=block_k,
                             device="cpu")
        live0 = int(bcc0.ntiles.sum())
        stats = {
            "density": float((pruned != 0).mean()),
            "live_tiles": live,
            "live_tiles_unordered": live0,
            "tile_reduction": 1.0 - live / max(live0, 1),
            "pad_fraction": 1.0 - live / max(slabs, 1),
            "dense_bytes": w.size * 2,
            "bcc_bytes": int(bcc.values.numel() * 2
                             + bcc.tile_ids.numel() * 4),
        }
        stream = kernel_ops.bcc_compact_stream(bcc, cover_all_blocks=True)
        return cls(bcc=bcc, perm=np.asarray(perm), out_features=out_f,
                   in_features=in_f, stats=stats, stream=stream,
                   cols=kernel_ops.slab_columns(stream[2]),
                   panels=kernel_ops.spmm_panels(
                       bcc.tile_ids, tiles_per_block=bcc.tiles_per_block))

    def apply(self, x: torch.Tensor, *, use_kernel: bool = True,
              compact: bool = True) -> torch.Tensor:
        """x (..., in) → (..., out), on the device of the packed weight.

        As in the JAX package: the kernel paths give bf16 and fp16
        activations their own dtype back, each step's fp32 product
        rounded to it before it is added; the dense path
        (``use_kernel=False``) returns fp32; fp64 activations are
        computed as fp32 (the JAX package runs without 64-bit types)."""
        lead = x.shape[:-1]
        if x.dtype == torch.float64:
            x = x.float()
        xt = x.reshape(-1, self.in_features).T.contiguous()   # (in, tokens)
        if use_kernel and compact:
            y_packed = kernel_ops.spmm_compact_stream(
                self.stream, xt, nrows=self.bcc.nrows, cols=self.cols)
        elif use_kernel:
            y_packed = kernel_ops.bcc_spmm(self.bcc, xt, panels=self.panels)
        else:
            y_packed = self.bcc.to_dense() @ xt.float()
        # un-permute packed rows back to feature order
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(self.perm.size)
        y = y_packed[torch.from_numpy(inv).to(y_packed.device)]
        return y.T.reshape(*lead, self.out_features)
