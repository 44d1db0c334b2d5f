"""Sparse matrix formats: CSR, CSR_Cluster, BCC, TiledCSR and CompactedC.

Two tiers, as in the JAX package:

* **Host tier** (`HostCSR`) — plain numpy, ragged, used by the
  preprocessing pipeline (reordering, clustering, format construction).
* **Device tier** (`CSR`, `CSRCluster`, `BCC`, `TiledCSR`, `CompactedC`)
  — frozen dataclasses of :class:`torch.Tensor` plus static int fields,
  with padded capacities. Padding convention: ``col == ncols`` sentinel /
  zero values contribute nothing.

Every ``*_from_host`` packer works on the host with numpy exactly as the
JAX package's packers do (same layout, field for field) and makes its
tensors once, at the end, on the ``device`` the caller names — there is
no default device. The CSR and CSR_Cluster packers split into a layout
(``csr_layout``, ``csr_cluster_layout``: all but the values) and
``fill_values``, which scatters a values array into it on the device, so
new values on a packed pattern repack without the host's work.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.segment import (boundary_mask, expand_indptr,
                                      key_table, ragged_gather_indices,
                                      segmented_count, segmented_sum)

__all__ = [
    "HostCSR",
    "BlockDiagPack",
    "block_diag_csr",
    "block_diag_csr_reference",
    "split_block_diag",
    "CSR",
    "CSRCluster",
    "BCC",
    "TiledCSR",
    "CompactedC",
    "ValueLayout",
    "fill_values",
    "csr_layout",
    "csr_from_host",
    "csr_cluster_layout",
    "csr_cluster_from_host",
    "bcc_from_host",
    "tiled_csr_from_host",
    "tiled_live_tiles",
    "select_block_k",
    "live_pair_stream",
    "live_pair_counters",
    "partition_pair_stream",
    "partition_pair_stream_reference",
    "partition_balance",
    "revisit_window_blocks",
    "revisit_pair_stream",
    "compacted_c_keys",
    "compacted_c_table",
    "compacted_c_from_dense",
    "compacted_c_csr",
    "compacted_c_to_host",
    "compacted_c_counters",
    "COUNTER_UNITS",
    "tile_col_occupancy",
    "symbolic_strip_nnz",
    "symbolic_strip_nnz_reference",
    "csr_nbytes",
    "csr_cluster_nbytes_exact",
    "csr_cluster_nbytes_exact_reference",
]

# ---------------------------------------------------------------------------
# Host tier
# ---------------------------------------------------------------------------


class HostCSR:
    """Numpy CSR with the preprocessing operations the paper needs.

    Invariants: ``indptr`` is int64 non-decreasing of length ``nrows+1``;
    column indices within a row are sorted ascending; no explicit zeros
    required (but tolerated).
    """

    # __weakref__ so callers can memoize on operands without pinning them
    __slots__ = ("indptr", "indices", "data", "shape", "__weakref__")

    def __init__(self, indptr, indices, data, shape):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.data = np.asarray(data, dtype=np.float32)
        self.shape = (int(shape[0]), int(shape[1]))
        if self.indptr.shape[0] != self.shape[0] + 1:
            raise ValueError("indptr length mismatch")
        if self.indices.shape[0] != self.data.shape[0]:
            raise ValueError("indices/data length mismatch")

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, *, sum_duplicates=True) -> "HostCSR":
        """Build from COO triplets (duplicates summed by default).

        >>> h = HostCSR.from_coo([0, 1], [1, 0], [3.0, 4.0], (2, 2))
        >>> h.to_dense()
        array([[0., 3.],
               [4., 0.]], dtype=float32)
        >>> h.nnz, h.row_nnz().tolist()
        (2, [1, 1])
        """
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float32)
        nrows, ncols = shape
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            key = rows * ncols + cols
            uniq, inv = np.unique(key, return_inverse=True)
            newv = np.zeros(uniq.shape[0], dtype=np.float64)
            np.add.at(newv, inv, vals)
            rows = (uniq // ncols).astype(np.int64)
            cols = (uniq % ncols).astype(np.int64)
            vals = newv.astype(np.float32)
        indptr = np.zeros(nrows + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr, cols.astype(np.int32), vals, shape)

    @classmethod
    def from_dense(cls, dense) -> "HostCSR":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return cls.from_coo(rows, cols, dense[rows, cols], dense.shape,
                            sum_duplicates=False)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float32)
        out[expand_indptr(self.indptr), self.indices] = self.data
        return out

    # -- basic properties ----------------------------------------------------

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.data[s:e]

    def validate(self, name: str = "operand") -> "HostCSR":
        """Check every structural invariant (monotone ``indptr``, in-range
        sorted ``indices``, finite ``data``, consistent lengths); raises
        :class:`repro_torch.resilience.errors.InvalidOperandError` naming
        the violated invariant. Returns ``self`` for chaining."""
        # lazy import: resilience sits above core in the layer order
        from repro_torch.resilience.validation import validate_host_csr
        validate_host_csr(self, name=name)
        return self

    # -- transforms ----------------------------------------------------------

    def binarize(self) -> "HostCSR":
        return HostCSR(self.indptr, self.indices,
                       np.ones_like(self.data), self.shape)

    def transpose(self) -> "HostCSR":
        """O(nnz) counting transpose (Gustavson's permuted transposition)."""
        nrows, ncols = self.shape
        cnt = np.zeros(ncols + 1, dtype=np.int64)
        np.add.at(cnt, self.indices.astype(np.int64) + 1, 1)
        indptr_t = np.cumsum(cnt)
        indices_t = np.empty(self.nnz, dtype=np.int32)
        data_t = np.empty(self.nnz, dtype=np.float32)
        # expand row ids then stable-sort by column
        row_ids = np.repeat(np.arange(nrows, dtype=np.int32), self.row_nnz())
        order = np.argsort(self.indices, kind="stable")
        indices_t[:] = row_ids[order]
        data_t[:] = self.data[order]
        return HostCSR(indptr_t, indices_t, data_t, (ncols, nrows))

    def row_gather(self, perm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(indptr, gather)`` of A[perm, :]: its row pointer, and for
        each of its entries the index of that entry in A."""
        perm = np.asarray(perm, dtype=np.int64)
        counts = self.row_nnz()[perm]
        indptr = np.zeros(self.nrows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, ragged_gather_indices(self.indptr[perm], counts)

    def permute_rows(self, perm: np.ndarray) -> "HostCSR":
        """Return A[perm, :] — ``perm[new_row] = old_row``."""
        indptr, gather = self.row_gather(perm)
        return HostCSR(indptr, self.indices[gather], self.data[gather],
                       self.shape)

    def permute_symmetric(self, perm: np.ndarray) -> "HostCSR":
        """Return PAPᵀ — rows and columns permuted together (square only)."""
        if self.nrows != self.ncols:
            raise ValueError("symmetric permutation needs a square matrix")
        perm = np.asarray(perm, dtype=np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        rowperm = self.permute_rows(perm)
        # remap then segmented-sort column ids within each row: one lexsort
        # keyed (row, newcol) re-sorts every row at once
        newcols = inv[rowperm.indices.astype(np.int64)].astype(np.int32)
        rows = expand_indptr(rowperm.indptr)
        order = np.lexsort((newcols, rows))
        return HostCSR(rowperm.indptr, newcols[order], rowperm.data[order],
                       self.shape)

    def jaccard(self, i: int, j: int) -> float:
        """Jaccard similarity of the column-id sets of rows i and j."""
        a, _ = self.row(i)
        b, _ = self.row(j)
        if a.size == 0 and b.size == 0:
            return 1.0
        inter = np.intersect1d(a, b, assume_unique=True).size
        union = a.size + b.size - inter
        return inter / union if union else 0.0

    def nbytes(self, index_bytes: int = 4, value_bytes: int = 4,
               ptr_bytes: int = 8) -> int:
        return (self.indptr.size * ptr_bytes
                + self.indices.size * index_bytes
                + self.data.size * value_bytes)


# ---------------------------------------------------------------------------
# Block-diagonal batching (cross-request packing)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockDiagPack:
    """One block-diagonal packing of N member matrices.

    ``host`` is the packed :class:`HostCSR` of shape
    ``(Σ nrows_i, Σ ncols_i)`` whose i-th diagonal block is member i;
    ``row_offsets`` / ``col_offsets`` are the ``(N+1,)`` prefix sums that
    locate each member's row strip and column band. Because the members
    share no rows *and* no columns, any product of two conforming packs
    is itself block-diagonal: member i's product is exactly the
    ``[row_offsets[i]:row_offsets[i+1], col_offsets[i]:col_offsets[i+1]]``
    block of the packed product (cross blocks are structurally zero), so
    the per-request split is a pure slice.
    """

    host: HostCSR
    row_offsets: np.ndarray            # (N+1,) int64
    col_offsets: np.ndarray            # (N+1,) int64

    @property
    def members(self) -> int:
        return int(self.row_offsets.shape[0] - 1)


def block_diag_csr(mats: Sequence[HostCSR]) -> BlockDiagPack:
    """Pack ``mats`` into one block-diagonal :class:`HostCSR`.

    Vectorized: one concatenation per CSR array — the member indptr
    diffs concatenate directly (prefix-summed once), member column
    indices shift by the column offset of their band, values concatenate
    untouched (so the packed operand is bit-for-bit the members' data).

    >>> a = HostCSR.from_dense([[1.0, 2.0], [0.0, 3.0]])
    >>> b = HostCSR.from_dense([[4.0]])
    >>> block_diag_csr([a, b]).host.to_dense()
    array([[1., 2., 0.],
           [0., 3., 0.],
           [0., 0., 4.]], dtype=float32)
    """
    if not mats:
        raise ValueError("block_diag_csr needs at least one member")
    row_off = np.zeros(len(mats) + 1, dtype=np.int64)
    col_off = np.zeros(len(mats) + 1, dtype=np.int64)
    row_off[1:] = np.cumsum([m.nrows for m in mats])
    col_off[1:] = np.cumsum([m.ncols for m in mats])
    indptr = np.zeros(row_off[-1] + 1, dtype=np.int64)
    np.concatenate([np.diff(m.indptr) for m in mats], out=indptr[1:])
    np.cumsum(indptr, out=indptr)
    indices = np.concatenate([m.indices.astype(np.int64) + col_off[i]
                              for i, m in enumerate(mats)])
    data = np.concatenate([m.data for m in mats])
    host = HostCSR(indptr, indices.astype(np.int32), data,
                   (int(row_off[-1]), int(col_off[-1])))
    return BlockDiagPack(host=host, row_offsets=row_off,
                         col_offsets=col_off)


def block_diag_csr_reference(mats: Sequence[HostCSR]) -> BlockDiagPack:
    """Loop oracle for :func:`block_diag_csr`: row-by-row COO append."""
    if not mats:
        raise ValueError("block_diag_csr_reference needs >= 1 member")
    rows, cols, vals = [], [], []
    r0 = c0 = 0
    offsets_r, offsets_c = [0], [0]
    for m in mats:
        for i in range(m.nrows):
            idx, dat = m.row(i)
            for j, v in zip(idx, dat):
                rows.append(r0 + i)
                cols.append(c0 + int(j))
                vals.append(float(v))
        r0 += m.nrows
        c0 += m.ncols
        offsets_r.append(r0)
        offsets_c.append(c0)
    host = HostCSR.from_coo(rows, cols, vals, (r0, c0),
                            sum_duplicates=False)
    return BlockDiagPack(host=host,
                         row_offsets=np.asarray(offsets_r, np.int64),
                         col_offsets=np.asarray(offsets_c, np.int64))


def split_block_diag(dense_c, row_pack: BlockDiagPack,
                     col_pack: BlockDiagPack | None = None
                     ) -> list[np.ndarray]:
    """Slice a packed product back into per-member dense blocks.

    ``row_pack`` locates the row strips (the packed A); ``col_pack``
    locates the column bands — the packed B for an A·B batch, defaulting
    to ``row_pack`` for the A² batch where C's columns are A's. Each
    returned block is a contiguous copy, so member results stay alive
    independently of the batched buffer.
    """
    col_pack = col_pack if col_pack is not None else row_pack
    if row_pack.members != col_pack.members:
        raise ValueError("row/col packs disagree on member count")
    dense_c = np.asarray(dense_c)
    ro, co = row_pack.row_offsets, col_pack.col_offsets
    return [np.ascontiguousarray(dense_c[ro[i]:ro[i + 1],
                                         co[i]:co[i + 1]])
            for i in range(row_pack.members)]


# ---------------------------------------------------------------------------
# Device tier
# ---------------------------------------------------------------------------


def _tensor(x: np.ndarray, device, dtype: torch.dtype | None = None
            ) -> torch.Tensor:
    """One host array → one tensor on ``device`` (the packers' last step)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Static-shape CSR: padded to ``nnz_cap``; pad cols == ncols, vals 0."""

    _static = ("nrows", "ncols")

    indptr: torch.Tensor       # (nrows+1,) int32
    indices: torch.Tensor      # (nnz_cap,) int32, padded with ncols
    data: torch.Tensor         # (nnz_cap,) float
    nrows: int
    ncols: int

    @property
    def nnz_cap(self) -> int:
        return self.indices.shape[0]

    def to_dense(self) -> torch.Tensor:
        row_ids = torch.searchsorted(
            self.indptr, _arange(self.nnz_cap, self.indptr).to(
                self.indptr.dtype), right=True) - 1
        valid = self.indices < self.ncols
        rows = torch.where(valid, row_ids, 0).long()
        cols = torch.where(valid, self.indices, 0).long()
        vals = torch.where(valid, self.data, 0)
        out = torch.zeros((self.nrows, self.ncols), dtype=self.data.dtype,
                          device=self.data.device)
        return out.index_put_((rows, cols), vals, accumulate=True)


@dataclasses.dataclass(frozen=True)
class CSRCluster:
    """Device CSR_Cluster (paper Fig. 6), rows-in-cluster padded to K.

    ``col_slots`` indexes the deduplicated (cluster, column) pairs:
      * ``cluster_ptr[c] .. cluster_ptr[c+1]`` — slots of cluster ``c``
      * ``cols[s]`` — column id of slot ``s`` (pad: ncols)
      * ``values[s, k]`` — value of row ``row_base[c]+k`` at that column
        (pad: 0 where the row has no entry there or k >= cluster_size[c])
    """

    _static = ("nrows", "ncols", "max_cluster")

    cluster_ptr: torch.Tensor  # (nclusters+1,) int32
    cols: torch.Tensor         # (slot_cap,) int32, pad=ncols
    values: torch.Tensor       # (slot_cap, K) float
    row_base: torch.Tensor     # (nclusters,) int32
    cluster_size: torch.Tensor  # (nclusters,) int32
    nrows: int
    ncols: int
    max_cluster: int

    @property
    def nclusters(self) -> int:
        return self.row_base.shape[0]

    @property
    def slot_cap(self) -> int:
        return self.cols.shape[0]

    def to_dense(self) -> torch.Tensor:
        slot_cluster = torch.searchsorted(
            self.cluster_ptr, _arange(self.slot_cap, self.cols).to(
                self.cluster_ptr.dtype), right=True) - 1
        cl = torch.clamp(slot_cluster, 0, self.nclusters - 1).long()
        base = self.row_base[cl].long()
        valid_col = self.cols < self.ncols
        out = torch.zeros((self.nrows + self.max_cluster, self.ncols + 1),
                          dtype=self.values.dtype, device=self.values.device)
        k = _arange(self.max_cluster, self.cols)
        rows = base[:, None] + k[None, :]                      # (S, K)
        cols = torch.where(valid_col, self.cols, self.ncols).long()
        cols = cols[:, None].expand(rows.shape)
        out.index_put_((rows, cols), self.values, accumulate=True)
        return out[: self.nrows, : self.ncols]


@dataclasses.dataclass(frozen=True)
class BCC:
    """Block-Clustered-Columns: fixed ``block_r``-row blocks, active
    columns grouped into ``block_k``-wide tiles. Per block, the list of
    active tile ids (padded with 0 alongside all-zero value slabs) and
    dense ``(block_r, block_k)`` value slabs, flat over (block, tile-slot)
    with a fixed ``tiles_per_block`` stride."""

    _static = ("nrows", "ncols", "block_r", "block_k", "tiles_per_block")

    tile_ids: torch.Tensor     # (nblocks * tiles_per_block,) int32, pad=0
    values: torch.Tensor       # (nblocks * tiles_per_block, block_r, block_k)
    ntiles: torch.Tensor       # (nblocks,) int32 — live tiles per block
    nrows: int
    ncols: int
    block_r: int
    block_k: int
    tiles_per_block: int

    @property
    def nblocks(self) -> int:
        return self.ntiles.shape[0]

    def to_dense(self) -> torch.Tensor:
        nb, t = self.nblocks, self.tiles_per_block
        br, bk = self.block_r, self.block_k
        out = torch.zeros((nb * br, (self.ncols + bk - 1) // bk * bk),
                          dtype=self.values.dtype, device=self.values.device)
        flat = _arange(nb * t, self.values)
        blk = flat // t
        live = (flat % t) < self.ntiles.long()[blk]
        slab = torch.where(live[:, None, None], self.values, 0)
        rows = blk[:, None, None] * br + _arange(br, flat)[None, :, None]
        cols = (self.tile_ids.long()[:, None, None] * bk
                + _arange(bk, flat)[None, None, :])
        shape = (nb * t, br, bk)
        out.index_put_((rows.expand(shape), cols.expand(shape)), slab,
                       accumulate=True)
        return out[: self.nrows, : self.ncols]


@dataclasses.dataclass(frozen=True)
class TiledCSR:
    """Tiled-sparse B operand of the Sp×Sp kernel.

    B is cut into a ``(nkb × nnb)`` lattice of ``(block_k, bn)`` tiles;
    only *live* tiles are stored, as dense slabs::

        tiles : (tile_cap, block_k, bn)   tiles[0] is the reserved all-zero
                                          tile; live tiles occupy 1..ntiles
        table : (nkb * nnb,) int32        (k-block kb, n-tile nb) → tile
                                          slot at table[kb * nnb + nb];
                                          0 = dead (points at the zero tile)
    """

    _static = ("nrows", "ncols", "block_k", "bn")

    tiles: torch.Tensor        # (tile_cap, block_k, bn) fp32 or bf16
    table: torch.Tensor        # (nkb * nnb,) int32, 0 = dead
    nrows: int
    ncols: int
    block_k: int
    bn: int

    @property
    def nkb(self) -> int:
        return (self.nrows + self.block_k - 1) // self.block_k

    @property
    def nnb(self) -> int:
        return (self.ncols + self.bn - 1) // self.bn

    @property
    def tile_cap(self) -> int:
        return self.tiles.shape[0]

    @property
    def ntiles_live(self) -> int:
        """Live tiles (excludes the reserved zero tile)."""
        return int((self.table > 0).sum())

    def nbytes_tiles(self) -> int:
        """Device footprint of the tile store."""
        return int(self.tiles.numel() * self.tiles.element_size())

    def to_dense(self) -> torch.Tensor:
        out = self.tiles[self.table.long()].reshape(
            self.nkb, self.nnb, self.block_k, self.bn).permute(0, 2, 1, 3)
        out = out.reshape(self.nkb * self.block_k, self.nnb * self.bn)
        return out[: self.nrows, : self.ncols]


@dataclasses.dataclass(frozen=True)
class CompactedC:
    """Sparse-C output format: only the *live* ``(block_r, bn)`` windows of
    C, as packed value slabs, and their window keys::

        slabs : (slab_cap, block_r, bn)   slabs[0] is the reserved
                                          all-zero slab; live window
                                          keys[i] occupies slab i + 1
        keys  : (nslabs_live,) int64      sorted window keys
                                          blk * nnb + j (row block blk,
                                          col strip j)

    Its bookkeeping grows with C's live windows, never with the
    ``nblocks × nnb`` window lattice; :attr:`table` derives the JAX
    package's dense window → slab lookup on demand.
    """

    _static = ("nrows", "ncols", "block_r", "bn")

    slabs: torch.Tensor        # (slab_cap, block_r, bn)
    keys: torch.Tensor         # (nslabs_live,) int64, ascending
    nrows: int
    ncols: int
    block_r: int
    bn: int

    @classmethod
    def from_table(cls, slabs, table, *, nrows: int, ncols: int,
                   block_r: int, bn: int) -> "CompactedC":
        """From the JAX package's layout: a dense ``(nblocks * nnb,)``
        window → slab table, whose live windows hold slabs ``1..L`` in
        ascending key order (:func:`compacted_c_table`'s numbering, the
        order its slabs are packed in); any other table raises."""
        slabs = torch.as_tensor(slabs)
        table = torch.as_tensor(table).to(slabs.device).long()
        keys = torch.nonzero(table > 0).view(-1)
        want = torch.arange(1, keys.shape[0] + 1, device=slabs.device)
        if not torch.equal(table[keys], want):
            raise ValueError("the table does not number its live windows "
                             "1..L in key order")
        return cls(slabs=slabs, keys=keys, nrows=nrows, ncols=ncols,
                   block_r=block_r, bn=bn)

    @property
    def nblocks(self) -> int:
        return (self.nrows + self.block_r - 1) // self.block_r

    @property
    def nnb(self) -> int:
        return (self.ncols + self.bn - 1) // self.bn

    @property
    def slab_cap(self) -> int:
        return self.slabs.shape[0]

    @property
    def nslabs_live(self) -> int:
        """Live windows (excludes the reserved zero slab)."""
        return int(self.keys.shape[0])

    @property
    def table(self) -> torch.Tensor:
        """The dense ``(nblocks * nnb,)`` int32 window → slab lookup (0 =
        dead, the zero slab), built here: ``nblocks × nnb`` entries, for
        parity with the JAX package and dense outputs only."""
        table = torch.zeros(self.nblocks * self.nnb, dtype=torch.int32,
                            device=self.keys.device)
        table[self.keys] = torch.arange(1, self.nslabs_live + 1,
                                        dtype=torch.int32,
                                        device=self.keys.device)
        return table

    def nbytes_slabs(self) -> int:
        """Device footprint of the slab store."""
        return int(self.slabs.numel() * self.slabs.element_size())

    def to_dense(self) -> torch.Tensor:
        # one gather through the table, window-major → row-major reshape
        windows = self.slabs[self.table.long()]
        out = windows.reshape(self.nblocks, self.nnb, self.block_r,
                              self.bn).permute(0, 2, 1, 3)
        out = out.reshape(self.nblocks * self.block_r, self.nnb * self.bn)
        return out[: self.nrows, : self.ncols]


# ---------------------------------------------------------------------------
# Host → device conversions
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ValueLayout:
    """The symbolic half of a packed operand: everything but its values.

    ``structure`` is the packed :class:`CSR` or :class:`CSRCluster` with
    an empty value array; ``dst[j]`` is the flat index, in the value array
    of ``shape``, of entry ``j`` of the source HostCSR (``None``: entry
    ``j`` lands at ``j``). The layout depends on the source's pattern and
    the packing's parameters only, so one layout serves every values
    array of that pattern: :func:`fill_values` makes the operand in one
    scatter on the structure's device.
    """

    structure: CSR | CSRCluster
    dst: torch.Tensor | None   # (nnz,) int32 (int64 past 2**31 slots)
    shape: tuple[int, ...]
    nnz: int


_VALUE_FIELD = {CSR: "data", CSRCluster: "values"}


def fill_values(layout: ValueLayout, data: np.ndarray,
                dtype: torch.dtype = torch.float32) -> CSR | CSRCluster:
    """The numeric half of a pack: the operand of ``layout`` holding
    ``data`` (the source's values, in its entry order), equal bit for bit
    to packing the source in full. One upload of ``data``, a zero fill
    and one scatter (the layout's slots are distinct)."""
    if data.shape[0] != layout.nnz:
        raise ValueError(f"{data.shape[0]} values for a layout of "
                         f"{layout.nnz} entries")
    field = _VALUE_FIELD[type(layout.structure)]
    empty = getattr(layout.structure, field)
    vals = torch.zeros(int(np.prod(layout.shape)), dtype=dtype,
                       device=empty.device)
    if layout.nnz:
        src = _tensor(data, empty.device, dtype)
        if layout.dst is None:
            vals[: layout.nnz] = src
        else:
            vals[layout.dst] = src
    return dataclasses.replace(layout.structure,
                               **{field: vals.view(layout.shape)})


def _permuted_pattern(h: HostCSR, perm
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """``(indptr, indices, gather)`` of ``h[perm, :]``'s pattern, and for
    each of its entries the index of that entry in ``h`` (``None``, and
    ``h``'s own pattern, without ``perm``)."""
    if perm is None:
        return h.indptr, h.indices, None
    indptr, gather = h.row_gather(perm)
    return indptr, h.indices[gather], gather


def _dst_tensor(dst: np.ndarray, gather: np.ndarray | None, size: int,
                device) -> torch.Tensor:
    """The permuted entries' destinations, in the source's entry order
    (``dst_source[gather] = dst``), as int32 where ``size`` slots fit."""
    if gather is not None:
        src_order = np.empty_like(dst)
        src_order[gather] = dst
        dst = src_order
    return _tensor(dst.astype(np.int32 if size < 2**31 else np.int64),
                   device)


def csr_layout(h: HostCSR, nnz_cap: int | None = None, *, perm=None,
               device) -> ValueLayout:
    """The :func:`csr_from_host` layout of ``h[perm, :]`` (of ``h``
    without ``perm``), its destinations indexed by ``h``'s entries."""
    cap = _round_up(max(h.nnz, 1), 8) if nnz_cap is None else nnz_cap
    if cap < h.nnz:
        raise ValueError(f"nnz_cap {cap} < nnz {h.nnz}")
    indptr, cols, gather = _permuted_pattern(h, perm)
    indices = np.full(cap, h.ncols, dtype=np.int32)
    indices[: h.nnz] = cols
    structure = CSR(indptr=_tensor(indptr.astype(np.int32), device),
                    indices=_tensor(indices, device),
                    data=torch.empty(0, device=device),
                    nrows=h.nrows, ncols=h.ncols)
    dst = (None if gather is None else _dst_tensor(
        np.arange(h.nnz, dtype=np.int64), gather, cap, device))
    return ValueLayout(structure, dst, (cap,), h.nnz)


def csr_from_host(h: HostCSR, nnz_cap: int | None = None,
                  dtype: torch.dtype = torch.float32, *, device) -> CSR:
    return fill_values(csr_layout(h, nnz_cap, device=device), h.data, dtype)


def csr_cluster_layout(h: HostCSR, boundaries: Sequence[int],
                       max_cluster: int, slot_cap: int | None = None, *,
                       perm=None, device) -> ValueLayout:
    """The :func:`csr_cluster_from_host` layout of ``h[perm, :]`` (of
    ``h`` without ``perm``; ``boundaries`` are rows of the permuted
    matrix), its destinations indexed by ``h``'s entries.

    One searchsorted maps every nonzero to its cluster, one argsort over
    the (cluster, column) key discovers the deduplicated column slots, and
    each nonzero's destination is ``slot * max_cluster + (row -
    row_base[cluster])`` in the flat value slab.
    """
    bounds = np.asarray(list(boundaries) + [h.nrows], dtype=np.int64)
    ncl = bounds.shape[0] - 1
    sizes = np.diff(bounds)
    over = sizes > max_cluster
    if over.any():
        raise ValueError(f"cluster {int(np.argmax(over))} larger than "
                         "max_cluster")
    row_base = bounds[:-1].astype(np.int32)
    csize = sizes.astype(np.int32)

    indptr, indices, gather = _permuted_pattern(h, perm)
    rows = expand_indptr(indptr)
    cols = indices.astype(np.int64)
    cl = np.searchsorted(bounds, rows, side="right") - 1
    key = cl * max(h.ncols, 1) + cols
    order = np.argsort(key, kind="stable")
    skey = key[order]
    first = boundary_mask(skey)
    slot_sorted = np.cumsum(first) - 1          # slot id per sorted nnz
    ukey = skey[first]                          # one key per (cluster, col)
    per_cluster = segmented_count(ukey // max(h.ncols, 1), ncl)
    ptr = np.zeros(ncl + 1, dtype=np.int64)
    np.cumsum(per_cluster, out=ptr[1:])
    total = int(ptr[-1])
    cap = _round_up(max(total, 1), 8) if slot_cap is None else slot_cap
    if cap < total:
        raise ValueError(f"slot_cap {cap} < required {total}")
    cols_out = np.full(cap, h.ncols, dtype=np.int32)
    cols_out[:total] = (ukey % max(h.ncols, 1)).astype(np.int32)
    slot = np.empty(h.nnz, dtype=np.int64)
    slot[order] = slot_sorted
    dst = slot * max_cluster + (rows - bounds[cl])
    structure = CSRCluster(
        cluster_ptr=_tensor(ptr.astype(np.int32), device),
        cols=_tensor(cols_out, device),
        values=torch.empty((0, max_cluster), device=device),
        row_base=_tensor(row_base, device),
        cluster_size=_tensor(csize, device),
        nrows=h.nrows, ncols=h.ncols, max_cluster=max_cluster)
    return ValueLayout(structure,
                       _dst_tensor(dst, gather, cap * max_cluster, device),
                       (cap, max_cluster), h.nnz)


def csr_cluster_from_host(h: HostCSR, boundaries: Sequence[int],
                          max_cluster: int, slot_cap: int | None = None,
                          dtype: torch.dtype = torch.float32, *,
                          device) -> CSRCluster:
    """Build CSR_Cluster from consecutive-row clusters
    (``boundaries``: cluster start rows, ending sentinel nrows implied):
    :func:`csr_cluster_layout`, then :func:`fill_values`."""
    return fill_values(csr_cluster_layout(h, boundaries, max_cluster,
                                          slot_cap, device=device),
                       h.data, dtype)


def bcc_from_host(h: HostCSR, block_r: int = 8, block_k: int = 128,
                  tiles_per_block: int | None = None,
                  dtype: torch.dtype = torch.float32, *, device) -> BCC:
    """Pack a (reordered) HostCSR into BCC tiles.

    Per-block tile discovery is one argsort over the
    ``block_id * nk + col // block_k`` key; the slab fill is one
    fancy-indexed assignment at (tile_slot, row % block_r, col % block_k).
    """
    nb = (h.nrows + block_r - 1) // block_r
    nk = (h.ncols + block_k - 1) // block_k
    rows = expand_indptr(h.indptr)
    cols = h.indices.astype(np.int64)
    key = (rows // block_r) * nk + cols // block_k
    order = np.argsort(key, kind="stable")
    skey = key[order]
    first = boundary_mask(skey)
    slot_sorted = np.cumsum(first) - 1          # live-tile id per sorted nnz
    ukey = skey[first]
    ublk = ukey // nk                           # block of each live tile
    per_block = segmented_count(ublk, nb)       # live tiles per block
    max_live = max(1, int(per_block.max()) if nb else 1)
    tpb = max_live if tiles_per_block is None else tiles_per_block
    if tpb < max_live:
        raise ValueError(f"tiles_per_block {tpb} < max live {max_live}")
    # padded flat position of each live tile: block * tpb + rank-in-block
    offs = np.zeros(nb, dtype=np.int64)
    np.cumsum(per_block[:-1], out=offs[1:])
    rank = np.arange(ublk.shape[0], dtype=np.int64) - offs[ublk]
    flat = ublk * tpb + rank
    tile_ids = np.zeros(nb * tpb, dtype=np.int32)
    tile_ids[flat] = (ukey % nk).astype(np.int32)
    values = np.zeros((nb * tpb, block_r, block_k), dtype=np.float32)
    nnz_flat = np.empty(h.nnz, dtype=np.int64)
    nnz_flat[order] = flat[slot_sorted]
    values[nnz_flat, rows % block_r, cols % block_k] = h.data
    ntiles = per_block.astype(np.int32)
    return BCC(tile_ids=_tensor(tile_ids, device),
               values=_tensor(values, device, dtype),
               ntiles=_tensor(ntiles, device),
               nrows=h.nrows, ncols=h.ncols,
               block_r=block_r, block_k=block_k, tiles_per_block=tpb)


def tiled_csr_from_host(h: HostCSR, block_k: int = 128, bn: int = 128,
                        tile_cap: int | None = None,
                        dtype: torch.dtype = torch.float32, *,
                        device) -> TiledCSR:
    """Pack a HostCSR into the tiled-sparse device format (fp32 or bf16
    tiles; bf16 rounds to nearest even once, at the end).

    Live-tile discovery is one argsort over the
    ``(row // block_k) * nnb + col // bn`` key; the table is one
    :func:`repro_torch.core.segment.key_table` scatter (``base=1`` — slot 0
    is the reserved zero tile); the slab fill is one fancy-indexed
    assignment at (slot, row % block_k, col % bn).
    """
    nkb = (h.nrows + block_k - 1) // block_k
    nnb = (h.ncols + bn - 1) // bn
    rows = expand_indptr(h.indptr)
    cols = h.indices.astype(np.int64)
    key = (rows // block_k) * nnb + cols // bn
    order = np.argsort(key, kind="stable")
    skey = key[order]
    first = boundary_mask(skey)
    slot_sorted = np.cumsum(first)              # live-tile slot (1-based)
    ukey = skey[first]
    nlive = int(ukey.shape[0])
    cap = nlive + 1 if tile_cap is None else tile_cap
    if cap < nlive + 1:
        raise ValueError(f"tile_cap {cap} < live tiles + zero tile "
                         f"{nlive + 1}")
    table = key_table(ukey, nkb * nnb, base=1)
    tiles = np.zeros((cap, block_k, bn), dtype=np.float32)
    if h.nnz:
        slot = np.empty(h.nnz, dtype=np.int64)
        slot[order] = slot_sorted
        tiles[slot, rows % block_k, cols % bn] = h.data
    return TiledCSR(tiles=_tensor(tiles, device, dtype),
                    table=_tensor(table, device),
                    nrows=h.nrows, ncols=h.ncols, block_k=block_k, bn=bn)


def tiled_live_tiles(h: HostCSR, block_k: int = 128, bn: int = 128) -> int:
    """Number of live ``(block_k, bn)`` tiles of ``h`` (no tile
    materialization).

    >>> tiled_live_tiles(HostCSR.from_dense(np.eye(256, dtype=np.float32)),
    ...                  128, 128)
    2
    """
    if h.nnz == 0:
        return 0
    rows = expand_indptr(h.indptr)
    nnb = (h.ncols + bn - 1) // bn
    key = (rows // block_k) * nnb + h.indices.astype(np.int64) // bn
    return int(np.unique(key).size)


def select_block_k(h: HostCSR, *, bn: int = 128,
                   candidates: Sequence[int] = (128, 256, 512),
                   step_overhead_bytes: int = 6144) -> int:
    """Heuristic k-tile height for the tiled Sp×Sp path: each candidate is
    scored by its B tile footprint plus a per-live-tile step cost, and the
    cheapest wins (the JAX package's rule, kept so both packages pack the
    same operands).

    >>> select_block_k(HostCSR.from_dense(np.eye(256, dtype=np.float32)))
    128
    >>> select_block_k(HostCSR.from_dense(np.ones((512, 512), np.float32)))
    512
    """
    best_bk, best_score = None, None
    for bk in candidates:
        if bk % 128:
            raise ValueError(f"block_k {bk} not a multiple of 128")
        live = tiled_live_tiles(h, bk, bn)
        score = live * bk * bn * 4 + live * step_overhead_bytes
        if best_score is None or score < best_score:
            best_bk, best_score = bk, score
    return int(best_bk)


# ---------------------------------------------------------------------------
# live-pair compacted stream (the Sp×Sp kernels' input)
# ---------------------------------------------------------------------------


def live_pair_stream(block_ids, tile_ids, table, *, nnb: int, nblocks: int,
                     step_live=None, pad_to: int = 8
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """Intersect A's compact (block, k-tile) stream with B's tile table:
    emit only the *live* pairs ``slot[s, j] = table[tile_ids[s] * nnb + j]
    > 0``, ordered by (block, s, j).

    Every block with no live pair still gets one zero-slot sentinel at its
    first stream step, and the stream is tail-padded to a multiple of
    ``pad_to`` with zero-slot repeats of the last pair. ``step_live``
    (optional (S,) bool) drops synthetic stream steps (zero slabs of empty
    blocks, tail padding) from the pair expansion.

    Returns ``(blocks, js, slots, a_idx)`` int32 arrays of equal length:
    output strip, column strip, B tile slot (0 = nothing to multiply) and
    A stream index of each pair.
    """
    block_ids = np.asarray(block_ids, dtype=np.int64)
    tile_ids = np.asarray(tile_ids, dtype=np.int64)
    table = np.asarray(table, dtype=np.int32)
    s_total = block_ids.shape[0]
    if step_live is None:
        step_live = np.ones(s_total, dtype=bool)
    step_live = np.asarray(step_live, dtype=bool)
    # B's live tiles, (k-block, j) ascending, as the rows of a CSR over
    # its k-blocks: each live step expands to its k-block's live tiles,
    # so the work follows the pairs, not steps × nnb
    live_keys = np.flatnonzero(table > 0)
    row_ptr = np.zeros(table.shape[0] // nnb + 1, dtype=np.int64)
    np.cumsum(np.bincount(live_keys // nnb, minlength=row_ptr.shape[0] - 1),
              out=row_ptr[1:])
    counts = np.where(step_live, row_ptr[tile_ids + 1] - row_ptr[tile_ids],
                      0)
    s_idx = np.repeat(np.arange(s_total, dtype=np.int64), counts)
    pos = (np.repeat(row_ptr[tile_ids] - (np.cumsum(counts) - counts),
                     counts) + np.arange(s_idx.shape[0], dtype=np.int64))
    j_idx = live_keys[pos] % nnb             # (s, j) ascending
    slot_vals = table[live_keys[pos]].astype(np.int64)
    # first stream step of every block (sentinel anchor)
    first = boundary_mask(block_ids)
    first_step = np.full(nblocks, -1, dtype=np.int64)
    first_step[block_ids[first]] = np.flatnonzero(first)
    covered = np.zeros(nblocks, dtype=bool)
    covered[block_ids[s_idx]] = True
    missing = np.flatnonzero(~covered)
    if missing.size and (first_step[missing] < 0).any():
        raise ValueError("stream must cover every block "
                         "(use cover_all_blocks=True)")
    sen_s = first_step[missing]
    # merge live pairs and sentinels in (s, j) order — block order follows
    # because block_ids is non-decreasing; sentinels take j = 0 and cannot
    # collide with a live (s, 0) pair (their block has no live pair at all)
    a_s = np.concatenate([s_idx, sen_s])
    a_j = np.concatenate([j_idx, np.zeros(sen_s.size, dtype=np.int64)])
    a_slot = np.concatenate([slot_vals,
                             np.zeros(sen_s.size, dtype=np.int64)])
    order = np.argsort(a_s * nnb + a_j, kind="stable")
    a_s, a_j, a_slot = a_s[order], a_j[order], a_slot[order]
    pad = (-a_s.size) % pad_to
    if pad:
        a_s = np.concatenate([a_s, np.repeat(a_s[-1], pad)])
        a_j = np.concatenate([a_j, np.repeat(a_j[-1], pad)])
        a_slot = np.concatenate([a_slot, np.zeros(pad, dtype=np.int64)])
    return (block_ids[a_s].astype(np.int32), a_j.astype(np.int32),
            a_slot.astype(np.int32), a_s.astype(np.int32))


# the single source of truth for counter units: every counter emitted by
# :func:`live_pair_counters` / :func:`compacted_c_counters` is listed here
# with the unit its value is expressed in. Fetch counters count the fetch
# events of a stream walked in order (consecutive equal indices fetch
# once); ``*_bytes`` counters are device-memory bytes.
COUNTER_UNITS = {
    "grid_steps": "grid steps (count)",
    "mxu_issues": "MXU contractions (count)",
    "a_fetches": "A slab DMAs after elision (count)",
    "a_bytes": "A slab HBM traffic (bytes)",
    "steps_per_mxu": "grid steps per MXU issue (ratio)",
    "b_tile_fetches": "live B tile DMAs after elision (count)",
    "b_tile_refetches": "live B tile DMAs beyond the first per tile (count)",
    "b_distinct_tiles": "distinct live B tiles touched (count)",
    "b_bytes": "live B tile HBM traffic (bytes)",
    "c_nnz": "C nonzeros (count)",
    "c_bytes_dense": "dense C row-strip HBM writes (bytes)",
    "c_bytes_sparse": "CompactedC live-slab HBM writes (bytes)",
    "c_compaction_steps": "sparse-C compaction windows written (count)",
}


def live_pair_counters(pairs, *, block_r: int, block_k: int,
                       bn: int | None = None, value_bytes: int = 4) -> dict:
    """Traffic counters of a live-pair stream (units per
    :data:`COUNTER_UNITS`).

    >>> blocks = [0, 0, 1, 1]; js = [0, 1, 0, 1]
    >>> slots  = [3, 5, 3, 5]; a_idx = [0, 0, 2, 2]
    >>> c = live_pair_counters((blocks, js, slots, a_idx),
    ...                        block_r=8, block_k=16, bn=16)
    >>> c["grid_steps"], c["mxu_issues"], c["a_fetches"]
    (4, 4, 2)
    >>> c["b_tile_fetches"], c["b_distinct_tiles"], c["b_tile_refetches"]
    (4, 2, 2)
    """
    blocks, js, slots, a_idx = (np.asarray(p) for p in pairs)
    grid_steps = int(a_idx.shape[0])
    mxu_issues = int((slots > 0).sum())
    a_fetches = int(boundary_mask(a_idx).sum()) if grid_steps else 0
    live = slots > 0
    b_fetches = int((boundary_mask(slots) & live).sum()) if grid_steps else 0
    b_distinct = int(np.unique(slots[live]).size)
    out = {
        "grid_steps": grid_steps,
        "mxu_issues": mxu_issues,
        "a_fetches": a_fetches,
        "a_bytes": a_fetches * block_r * block_k * value_bytes,
        "steps_per_mxu": grid_steps / max(mxu_issues, 1),
        "b_tile_fetches": b_fetches,
        "b_tile_refetches": b_fetches - b_distinct,
        "b_distinct_tiles": b_distinct,
    }
    if bn is not None:
        out["b_bytes"] = b_fetches * block_k * bn * value_bytes
    return out


# ---------------------------------------------------------------------------
# multi-core sharding + B-fetch-deduping revisit order of the pair stream
# ---------------------------------------------------------------------------
# (copied unchanged from the JAX package, 2 MiB window budget included, so
# the port's partitions and revisit streams equal the reference's)


def partition_pair_stream(pairs, *, nblocks: int, num_shards: int,
                          pad_to: int = 8
                          ) -> tuple[np.ndarray, list[tuple]]:
    """Split a live-pair stream into per-core contiguous block ranges.

    Row blocks own disjoint C row strips, so a partition at block
    boundaries needs no cross-core accumulation — each core runs its
    sub-stream against its own strip range. Balance is by per-block
    *live*-pair counts (slot > 0 — the MXU work; zero-slot sentinels and
    tail pads are free steps, excluded from the weights): boundary ``i``
    lands where the cumulative live-pair count is closest to
    ``i × total / num_shards`` (greedy bin-pack over the per-block prefix
    sums; ties take the earlier block, and every shard keeps at least
    one block). The stream must be block-sorted and cover
    every block (the :func:`live_pair_stream` contract — pair-less blocks
    travel with their zero-slot sentinel, so each lands in exactly one
    shard).

    Returns ``(ranges, shard_pairs)``: ``ranges`` is ``(S, 2)`` int64
    ``[start, end)`` block ranges covering ``0..nblocks`` (``S`` =
    ``min(num_shards, nblocks)``), and ``shard_pairs[i]`` is the i-th
    shard's ``(blocks, js, slots, a_idx)`` sub-stream, tail-padded to a
    multiple of ``pad_to`` with zero-slot repeats of its last pair. With
    ``num_shards=1`` the single shard is the input stream, bitwise.

    >>> blocks = [0, 0, 0, 1, 2, 2, 3, 3]; js = [0, 1, 2, 0, 0, 1, 0, 1]
    >>> slots  = [1, 2, 3, 4, 5, 6, 7, 8]; a_idx = [0, 0, 0, 1, 2, 2, 3, 3]
    >>> ranges, shards = partition_pair_stream(
    ...     (blocks, js, slots, a_idx), nblocks=4, num_shards=2, pad_to=1)
    >>> ranges.tolist()
    [[0, 2], [2, 4]]
    >>> shards[1][0].tolist()                    # second shard's blocks
    [2, 2, 3, 3]
    """
    blocks, js, slots, a_idx = (np.asarray(p) for p in pairs)
    if blocks.size and np.any(np.diff(blocks) < 0):
        raise ValueError("pair stream must be block-sorted")
    counts = np.bincount(blocks[slots > 0],
                         minlength=nblocks).astype(np.int64)
    cum = np.zeros(nblocks + 1, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])
    total = int(cum[-1])
    s_eff = max(1, min(int(num_shards), nblocks))
    bounds = [0]
    for i in range(1, s_eff):
        target = total * i / s_eff
        e0 = int(np.clip(np.searchsorted(cum, target, side="left"),
                         1, nblocks))
        e = e0 - 1 if target - cum[e0 - 1] <= cum[e0] - target else e0
        e = int(np.clip(e, bounds[-1] + 1, nblocks - (s_eff - i)))
        bounds.append(e)
    bounds.append(nblocks)
    ranges = np.stack([np.asarray(bounds[:-1], np.int64),
                       np.asarray(bounds[1:], np.int64)], axis=1)
    shard_pairs = []
    for start, end in ranges:
        lo = int(np.searchsorted(blocks, start, side="left"))
        hi = int(np.searchsorted(blocks, end, side="left"))
        sb, sj, ss, sa = (arr[lo:hi] for arr in (blocks, js, slots, a_idx))
        pad = (-sb.size) % pad_to
        if pad:
            sb = np.concatenate([sb, np.repeat(sb[-1], pad)])
            sj = np.concatenate([sj, np.repeat(sj[-1], pad)])
            ss = np.concatenate([ss, np.zeros(pad, ss.dtype)])
            sa = np.concatenate([sa, np.repeat(sa[-1], pad)])
        shard_pairs.append((sb, sj, ss, sa))
    return ranges, shard_pairs


def partition_pair_stream_reference(pairs, *, nblocks: int, num_shards: int,
                                    pad_to: int = 8
                                    ) -> tuple[np.ndarray, list[tuple]]:
    """Loop reference for :func:`partition_pair_stream` (test oracle)."""
    blocks, js, slots, a_idx = (np.asarray(p) for p in pairs)
    counts = [0] * nblocks
    for b, s in zip(blocks.tolist(), slots.tolist()):
        if s > 0:                              # live pairs only (the MXU
            counts[b] += 1                     # work being balanced)
    total = sum(counts)
    s_eff = max(1, min(int(num_shards), nblocks))
    cum = [0]
    for c in counts:
        cum.append(cum[-1] + c)
    bounds = [0]
    for i in range(1, s_eff):
        target = total * i / s_eff
        best_e, best_d = None, None
        for e in range(nblocks + 1):           # argmin |cum[e] - target|,
            d = abs(cum[e] - target)           # ties to the smaller e
            if best_d is None or d < best_d:
                best_e, best_d = e, d
        e = min(max(best_e, bounds[-1] + 1), nblocks - (s_eff - i))
        bounds.append(e)
    bounds.append(nblocks)
    ranges = np.asarray([[bounds[i], bounds[i + 1]]
                         for i in range(s_eff)], dtype=np.int64)
    shard_pairs = []
    for start, end in ranges:
        keep = [t for t in range(blocks.shape[0])
                if start <= blocks[t] < end]
        sb = [int(blocks[t]) for t in keep]
        sj = [int(js[t]) for t in keep]
        ss = [int(slots[t]) for t in keep]
        sa = [int(a_idx[t]) for t in keep]
        while len(sb) % pad_to:
            sb.append(sb[-1])
            sj.append(sj[-1])
            ss.append(0)
            sa.append(sa[-1])
        shard_pairs.append((np.asarray(sb, blocks.dtype),
                            np.asarray(sj, js.dtype),
                            np.asarray(ss, slots.dtype),
                            np.asarray(sa, a_idx.dtype)))
    return ranges, shard_pairs


def partition_balance(shard_pairs) -> float:
    """Worst-shard imbalance of a partition: max per-shard live-pair count
    over the ideal (total ÷ shards). 1.0 is a perfect split; the
    ``bench_kernels`` acceptance gate requires ≤ 1.2 (within 20% of
    ideal) on the quick-tier families.

    >>> even = [(0, 0, [1, 2], 0), (0, 0, [3, 4], 0)]
    >>> partition_balance(even)
    1.0
    """
    live = [int((np.asarray(p[2]) > 0).sum()) for p in shard_pairs]
    total = sum(live)
    if total == 0 or not live:
        return 1.0
    return max(live) / (total / len(live))


def revisit_window_blocks(nnb: int, *, block_r: int = 8, bn: int = 128,
                          budget_bytes: int = 2 * 2 ** 20,
                          value_bytes: int = 4) -> int:
    """Row-block capacity of the revisit kernel's C window: how many
    consecutive block strips of ``(block_r, nnb*bn)`` fp32 fit the VMEM
    accumulator budget. The revisit reorder (:func:`revisit_pair_stream`)
    may only interleave blocks *within* one such window — the kernel
    zero-initializes and owns one window at a time.

    >>> revisit_window_blocks(2, block_r=8, bn=128)   # 8 KiB per strip
    256
    >>> revisit_window_blocks(10 ** 6)                # huge strip: >= 1
    1
    """
    strip = block_r * nnb * bn * value_bytes
    return max(1, budget_bytes // max(strip, 1))


def revisit_pair_stream(pairs, *, window_blocks: int, block_base: int = 0
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """B-fetch-deduping revisit order of a live-pair stream.

    The (block, s, j) order of :func:`live_pair_stream` fetches a B tile
    once per *block* that touches it — the cross-block reuse the paper's
    cluster-wise argument (and Nagasaka et al.'s column-blocked multicore
    SpGEMM) says to exploit. This reorder makes triples sharing a B tile
    adjacent across blocks, so the streamed kernels' DMA elision collapses
    them into one fetch: within each window of ``window_blocks``
    consecutive row blocks (bounded so the C strips fit the VMEM
    accumulator budget — :func:`revisit_window_blocks`), triples sort by
    ``(j, slot, block)``.

    Output is **bit-identical** to the unordered kernel: for a fixed
    ``(block, j)`` C strip the B slot is monotone in the A stream step
    (table slots are assigned in ascending (kb, nb) key order), so sorting
    by slot preserves each strip's accumulation order; fp32 addition sees
    the same operand sequence per element. Zero-slot sentinels and tail
    pads ride along (they issue no MXU op wherever they land).

    ``block_base`` localizes windows for a shard's sub-stream (windows are
    relative to the shard's first block). The sort is stable; note that
    even ``window_blocks=1`` rewrites a block's *internal* order from
    (s, j) to (j, slot) — only the per-(block, j) accumulation order (and
    hence the output) is invariant, not the stream itself.

    >>> blocks = [0, 0, 1, 1]; js = [0, 1, 0, 1]
    >>> slots  = [3, 5, 3, 5]; a_idx = [0, 0, 2, 2]
    >>> b, j, s, a = revisit_pair_stream((blocks, js, slots, a_idx),
    ...                                  window_blocks=2)
    >>> s.tolist()                    # tile 3's fetches now adjacent
    [3, 3, 5, 5]
    >>> b.tolist()
    [0, 1, 0, 1]
    """
    blocks, js, slots, a_idx = (np.asarray(p) for p in pairs)
    if window_blocks < 1:
        raise ValueError("window_blocks must be >= 1")
    win = (blocks.astype(np.int64) - block_base) // window_blocks
    order = np.lexsort((blocks, slots, js, win))
    return (blocks[order], js[order], slots[order], a_idx[order])


# ---------------------------------------------------------------------------
# sparse-C output: CompactedC packers
# ---------------------------------------------------------------------------


def compacted_c_keys(pairs, *, nnb: int) -> np.ndarray:
    """The sorted keys ``blk * nnb + j`` of the distinct ``(blk, j)`` C
    windows touched by a live pair: a :class:`CompactedC`'s ``keys``.

    >>> compacted_c_keys(([0, 1, 1], [1, 0, 0], [3, 5, 0], [0, 1, 1]),
    ...                  nnb=2).tolist()
    [1, 2]
    """
    blocks, js, slots, _ = (np.asarray(p) for p in pairs)
    live = slots > 0
    return np.unique(blocks[live].astype(np.int64) * nnb
                     + js[live].astype(np.int64))


def compacted_c_table(pairs, *, nblocks: int, nnb: int
                      ) -> tuple[np.ndarray, int]:
    """Slab table of the live C windows: the distinct ``(blk, j)`` windows
    touched by a live pair get slabs ``1..nlive`` in ascending window-key
    order (slab 0 stays the reserved zero slab). Returns
    ``(table, nslabs_live)``: the JAX package's layout, ``nblocks × nnb``
    entries (the port's packs keep :func:`compacted_c_keys`).

    >>> table, n = compacted_c_table(([0, 1], [1, 0], [3, 5], [0, 1]),
    ...                              nblocks=2, nnb=2)
    >>> table.tolist(), n
    ([0, 1, 2, 0], 2)
    """
    ukey = compacted_c_keys(pairs, nnb=nnb)
    return key_table(ukey, nblocks * nnb, base=1), int(ukey.size)


def compacted_c_from_dense(dense: torch.Tensor, table, *, nrows: int,
                           ncols: int, block_r: int, bn: int) -> CompactedC:
    """Gather the live ``(block_r, bn)`` windows of a dense C into packed
    :class:`CompactedC` slabs (values moved, never recomputed), on
    ``dense``'s device. ``table`` is :func:`compacted_c_table`'s."""
    table = np.asarray(table, dtype=np.int32)
    nblocks = (nrows + block_r - 1) // block_r
    nnb = (ncols + bn - 1) // bn
    pad_r = max(nblocks * block_r - dense.shape[0], 0)
    pad_c = max(nnb * bn - dense.shape[1], 0)
    if pad_r or pad_c:
        dense = torch.nn.functional.pad(dense, (0, pad_c, 0, pad_r))
    windows = dense.reshape(nblocks, block_r, nnb, bn).permute(0, 2, 1, 3)
    windows = windows.reshape(nblocks * nnb, block_r, bn)
    live_keys = _tensor(np.flatnonzero(table > 0), dense.device)
    slabs = torch.cat([dense.new_zeros((1, block_r, bn)),
                       windows[live_keys]], dim=0)
    return CompactedC.from_table(slabs, _tensor(table, dense.device),
                                 nrows=nrows, ncols=ncols, block_r=block_r,
                                 bn=bn)


# segments (window rows) compacted_c_csr takes at a time: 2**18 × 128
# float32 values are 128 MiB of slabs
_CSR_CHUNK = 1 << 18


def compacted_c_csr(c: CompactedC
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C's CSR arrays from the slabs and the keys, on the slabs' device:
    int64 ``indptr``, int32 ``indices``, float32 ``data``, values moved
    bit-for-bit (16-bit slabs widened).

    Windows are disjoint and their keys sorted, so C's CSR order needs no
    sort: a row's entries lie in its block's windows in key (column
    strip) order, each window row's own in column order. Each segment's
    (a window's row's) nonzeros are counted, the segments placed
    row-major by a running sum over (block, row, window), and every
    nonzero scattered to its place — ``_CSR_CHUNK`` segments at a time
    (their nonzeros found twice: to count, then to place), so the
    transients stay small beside the slabs."""
    chunk = _CSR_CHUNK
    dev = c.slabs.device
    keys = c.keys.to(dev).long()
    nlive = keys.shape[0]
    br, bn = c.block_r, c.bn
    segs = c.slabs[1: nlive + 1].reshape(nlive * br, bn)
    blk, j = keys // c.nnb, keys % c.nnb
    seg_nnz = torch.zeros(nlive * br, dtype=torch.long, device=dev)
    for lo in range(0, nlive * br, chunk):
        part = segs[lo: lo + chunk]
        seg_nnz[lo: lo + part.shape[0]] = torch.bincount(
            torch.nonzero(part.reshape(-1)).view(-1) // bn,
            minlength=part.shape[0])
    # the CSR rank of segment (slab l, row r): the block's earlier rows,
    # all its windows each, then row r's earlier windows
    first = torch.searchsorted(blk, blk)               # block's 1st slab
    nwin = torch.searchsorted(blk, blk, right=True) - first
    rank = (br * first[:, None]
            + torch.arange(br, device=dev)[None, :] * nwin[:, None]
            + (torch.arange(nlive, device=dev) - first)[:, None]
            ).reshape(-1)
    by_rank = torch.zeros(nlive * br, dtype=torch.long, device=dev)
    by_rank[rank] = seg_nnz
    # a segment's first entry in CSR order, less its first in slab order
    seg_first = torch.cumsum(seg_nnz, 0) - seg_nnz
    shift = (torch.cumsum(by_rank, 0) - by_rank)[rank] - seg_first
    seg_col = (j * bn).repeat_interleave(br)           # its 1st column
    nnz = int(seg_nnz.sum())
    cols = torch.empty(nnz, dtype=torch.int32, device=dev)
    data = torch.empty(nnz, dtype=torch.float32, device=dev)
    for lo in range(0, nlive * br, chunk):
        part = segs[lo: lo + chunk].reshape(-1)
        flat = torch.nonzero(part).view(-1)            # slab order
        seg = flat // bn + lo
        dest = shift[seg] + seg_first[lo] + torch.arange(
            flat.shape[0], device=dev)
        cols[dest] = (seg_col[seg] + flat % bn).int()
        data[dest] = part[flat].float()
    row_nnz = torch.zeros(c.nblocks * br, dtype=torch.long,
                          device=dev).index_add_(
        0, (blk[:, None] * br
            + torch.arange(br, device=dev)[None, :]).reshape(-1), seg_nnz)
    if c.nblocks * br > c.nrows or c.nnb * bn > c.ncols:
        # entries in the windows' padding past C's edge are dropped
        rows = torch.repeat_interleave(
            torch.arange(c.nblocks * br, device=dev), row_nnz)
        keep = (rows < c.nrows) & (cols < c.ncols)
        rows, cols, data = rows[keep], cols[keep], data[keep]
        row_nnz = torch.bincount(rows, minlength=c.nrows)
    indptr = torch.zeros(c.nrows + 1, dtype=torch.long, device=dev)
    torch.cumsum(row_nnz[: c.nrows], 0, out=indptr[1:])
    return indptr, cols, data


def compacted_c_to_host(c: CompactedC) -> HostCSR:
    """CompactedC → HostCSR (:func:`compacted_c_csr`, copied to host
    numpy)."""
    indptr, cols, data = (t.cpu().numpy() for t in compacted_c_csr(c))
    return HostCSR(indptr, cols, data, (c.nrows, c.ncols))


def compacted_c_counters(c: CompactedC, *, c_nnz: int | None = None,
                         value_bytes: int = 4) -> dict:
    """C-side traffic counters of the sparse-C tier (units per
    :data:`COUNTER_UNITS`): what the dense row strips would have written
    vs what the compacted slabs write. ``c_nnz`` defaults to the numeric
    slab count.

    >>> c = compacted_c_from_dense(
    ...     torch.eye(8), [1, 0], nrows=8, ncols=16, block_r=8, bn=8)
    >>> k = compacted_c_counters(c)
    >>> k["c_nnz"], k["c_compaction_steps"]
    (8, 1)
    >>> k["c_bytes_dense"], k["c_bytes_sparse"]
    (512, 256)
    """
    live = c.nslabs_live
    if c_nnz is None:
        c_nnz = int(torch.count_nonzero(c.slabs))
    return {
        "c_nnz": int(c_nnz),
        "c_bytes_dense": c.nblocks * c.block_r * c.nnb * c.bn * value_bytes,
        "c_bytes_sparse": live * c.block_r * c.bn * value_bytes,
        "c_compaction_steps": live,
    }


# ---------------------------------------------------------------------------
# sparse-C symbolic pass: per-strip nnz bounds from the live-pair stream
# ---------------------------------------------------------------------------


def tile_col_occupancy(b: TiledCSR) -> np.ndarray:
    """(tile_cap, bn) bool — which lanes (output columns) of each B tile
    hold at least one nonzero. Row 0 (the reserved zero tile) is all
    False. A C window's column support is the union of its touching
    tiles' occupied lanes.

    >>> b = tiled_csr_from_host(
    ...     HostCSR.from_dense(np.eye(8, dtype=np.float32)),
    ...     block_k=8, bn=8, device="cpu")
    >>> tile_col_occupancy(b).astype(int).tolist()
    [[0, 0, 0, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1]]
    """
    return (b.tiles != 0).any(dim=1).cpu().numpy()


def symbolic_strip_nnz(pairs, occupancy, *, nblocks: int, nnb: int
                       ) -> np.ndarray:
    """Symbolic phase: per-C-row-strip nnz upper bound from the live-pair
    stream, without touching a value.

    For strip ``blk``, ``ub[blk] = Σ_j |∪ occupied lanes of the B tiles
    the live pairs (blk, j, slot) contract|``: a nonzero ``C[r, c]`` needs
    a ``k`` with ``A[r, k] ≠ 0`` (k-tile live in A's block) and
    ``B[k, c] ≠ 0`` (tile ``(kb, j)`` live, lane ``c % bn`` occupied), so
    every row's nnz in the strip is at most ``ub[blk]``.

    Vectorized: one stable argsort groups pairs by (blk, j) window, one
    ``np.logical_or.reduceat`` over the run starts takes each window's
    lane union, and a segmented sum folds windows into strips.
    Returns (nblocks,) int64.
    """
    blocks, js, slots, _ = (np.asarray(p) for p in pairs)
    occ = np.asarray(occupancy, dtype=bool)
    live = slots > 0
    b = blocks[live].astype(np.int64)
    j = js[live].astype(np.int64)
    s = slots[live].astype(np.int64)
    if b.size == 0:
        return np.zeros(nblocks, dtype=np.int64)
    key = b * nnb + j
    order = np.argsort(key, kind="stable")
    skey, ss = key[order], s[order]
    first = boundary_mask(skey)
    starts = np.flatnonzero(first)
    union = np.logical_or.reduceat(occ[ss], starts, axis=0)  # (W, bn)
    counts = union.sum(axis=1).astype(np.float64)
    return segmented_sum(skey[first] // nnb, counts,
                         nblocks).astype(np.int64)


def symbolic_strip_nnz_reference(pairs, occupancy, *, nblocks: int,
                                 nnb: int) -> np.ndarray:
    """Loop reference for :func:`symbolic_strip_nnz` (test oracle)."""
    blocks, js, slots, _ = (np.asarray(p) for p in pairs)
    occ = np.asarray(occupancy, dtype=bool)
    ub = np.zeros(nblocks, dtype=np.int64)
    for blk in range(nblocks):
        for j in range(nnb):
            union = np.zeros(occ.shape[1], dtype=bool)
            for t in range(blocks.shape[0]):
                if (int(blocks[t]) == blk and int(js[t]) == j
                        and int(slots[t]) > 0):
                    union |= occ[int(slots[t])]
            ub[blk] += int(union.sum())
    return ub


# ---------------------------------------------------------------------------
# Analytic footprints
# ---------------------------------------------------------------------------


def csr_nbytes(h: HostCSR) -> int:
    """Plain-CSR footprint (8 B indptr, 4 B index, 4 B value).

    >>> csr_nbytes(HostCSR.from_dense(np.eye(2, dtype=np.float32)))
    40
    """
    return h.nbytes()


def csr_cluster_nbytes_exact(h: HostCSR, boundaries: Sequence[int],
                             *, fixed_length: bool = False,
                             index_bytes: int = 4, value_bytes: int = 4,
                             ptr_bytes: int = 8) -> int:
    """Exact ragged CSR_Cluster footprint as the paper counts it.

    Per cluster: one col-id per *distinct* column + a value slab of
    (distinct_cols × cluster_size). Variable-length additionally stores
    the cluster-size array and a value-pointer array; fixed-length does
    not. Distinct (cluster, column) pairs are counted from one
    ``np.unique`` over the joint key; identical byte counts to
    :func:`csr_cluster_nbytes_exact_reference`.
    """
    bounds = np.asarray(list(boundaries) + [h.nrows], dtype=np.int64)
    ncl = bounds.shape[0] - 1
    sizes = np.diff(bounds)
    rows = expand_indptr(h.indptr)
    cl = np.searchsorted(bounds, rows, side="right") - 1
    key = cl * max(h.ncols, 1) + h.indices.astype(np.int64)
    ucl = np.unique(key) // max(h.ncols, 1)
    distinct = segmented_count(ucl, ncl)
    total_cols = int(distinct.sum())
    total_vals = int((distinct * sizes).sum())
    n = (ncl + 1) * ptr_bytes + total_cols * index_bytes \
        + total_vals * value_bytes
    if not fixed_length:
        n += ncl * index_bytes          # cluster sizes
        n += (ncl + 1) * ptr_bytes      # value pointers
    return n


def csr_cluster_nbytes_exact_reference(h: HostCSR,
                                       boundaries: Sequence[int],
                                       *, fixed_length: bool = False,
                                       index_bytes: int = 4,
                                       value_bytes: int = 4,
                                       ptr_bytes: int = 8) -> int:
    """Loop reference for :func:`csr_cluster_nbytes_exact` (test oracle)."""
    bounds = list(boundaries) + [h.nrows]
    ncl = len(bounds) - 1
    total_cols = 0
    total_vals = 0
    for c in range(ncl):
        lo, hi = bounds[c], bounds[c + 1]
        merged = np.unique(np.concatenate(
            [h.row(i)[0] for i in range(lo, hi)] or [np.empty(0, np.int32)]))
        total_cols += merged.size
        total_vals += merged.size * (hi - lo)
    n = (ncl + 1) * ptr_bytes + total_cols * index_bytes \
        + total_vals * value_bytes
    if not fixed_length:
        n += ncl * index_bytes          # cluster sizes
        n += (ncl + 1) * ptr_bytes      # value pointers
    return n
