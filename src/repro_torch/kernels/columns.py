"""The live-column form of A's BCC slabs.

A compact stream's slabs are dense ``(8, block_k)`` blocks, but on a sparse
operand almost all of their columns are zero (kron-14: about 5 live
columns of 128). The live-column form keeps, for every slab, only the
columns with a nonzero in any of its 8 rows, each with its 8 values —
zeros of the other rows included — so a kernel reads B's row ``k`` once
for a live column ``k`` and applies it to the 8 rows of the cluster, the
reuse that cluster-wise computation exists for. The padded slabs stay the
storage format; this form is derived from them once per packed operand.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SlabColumns", "slab_columns", "columns_for"]


@dataclasses.dataclass(frozen=True)
class SlabColumns:
    """Slab ``s``'s live columns are ``col_ptr[s] .. col_ptr[s+1]``:
    ``col_k`` their slab-local column (ascending within the slab),
    ``col_vals`` their ``block_r`` values. All-zero slabs (tail pads,
    ``cover_all_blocks`` slabs of empty blocks) have none."""

    col_ptr: torch.Tensor      # (S+1,) int32
    col_k: torch.Tensor        # (L,) int32
    col_vals: torch.Tensor     # (L, block_r) fp32
    block_k: int

    @property
    def nslabs(self) -> int:
        return int(self.col_ptr.shape[0]) - 1

    @property
    def ncols(self) -> int:
        return int(self.col_k.shape[0])


def slab_columns(values: torch.Tensor) -> SlabColumns:
    """The live-column form of ``(S, block_r, block_k)`` slabs, built with
    torch ops on the slabs' device (``torch.nonzero`` syncs the host once:
    call it at pack time, not per launch)."""
    if values.dim() != 3:
        raise ValueError(f"slabs {tuple(values.shape)} are not "
                         "(S, block_r, block_k)")
    nslabs, _, block_k = values.shape
    live = (values != 0).any(dim=1)                       # (S, block_k)
    col_ptr = torch.zeros(nslabs + 1, dtype=torch.int32,
                          device=values.device)
    col_ptr[1:] = torch.cumsum(live.sum(dim=1), 0)
    slab, k = torch.nonzero(live, as_tuple=True)          # slab-major
    return SlabColumns(col_ptr=col_ptr, col_k=k.int().contiguous(),
                       col_vals=values[slab, :, k].float().contiguous(),
                       block_k=int(block_k))


def columns_for(values: torch.Tensor,
                cols: SlabColumns | None = None) -> SlabColumns:
    """``cols`` checked against the slabs it must describe, or, when
    absent, the slabs' live columns built here."""
    if cols is None:
        return slab_columns(values)
    if cols.nslabs != values.shape[0] or cols.block_k != values.shape[2] \
            or cols.col_vals.shape[1:] != values.shape[1:2] \
            or cols.col_vals.device != values.device:
        raise ValueError(f"live columns of {cols.nslabs} slabs of width "
                         f"{cols.block_k} on {cols.col_vals.device} do not "
                         f"describe slabs {tuple(values.shape)} on "
                         f"{values.device}")
    return cols
