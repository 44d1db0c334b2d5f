"""The padded-lattice SpMM's panel schedule (``spmm_panels``), on the CPU.

The panel kernel (K9, ``csrc/cluster_spmm.cu``) runs up to 8 blocks of
BCC's padded lattice per CTA and stages each B tile once for all of them.
Its schedule is built once per weight: blocks ordered by their tile lists,
cut into panels where their slot-by-slot tiles stop agreeing, and per
(panel, slot) the distinct tiles with a bit per block that names each.

* Against a loop oracle on lattices with interleaved shared tile sets (as
  SparseLinear's clustering leaves them), all blocks equal (a block count
  that is not a multiple of 8), all blocks different, pad slabs, blocks
  that agree at 3/4 of their slots and one block: every block is in exactly
  one panel, no panel holds more than 8, and each (panel, slot) lists the
  distinct tiles its blocks name, ascending, each with the right blocks.
* A plain walk of the schedule in the kernel's order — per entry the
  blocks it names, each slot's fp32 part added in slot order, rounded in
  B's dtype — equals ``cluster_spmm_plain`` exactly on integer operands,
  in fp32, bf16 and fp16: the schedule covers every slab once, in the
  order the rounding needs.
* ``SparseLinear``'s layer gets one entry per (panel, slot).

The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.cluster_spmm import (KERNEL_PANEL_BLOCKS,
                                              cluster_spmm_plain, spmm_panels)
from repro_torch.models.sparse_linear import SparseLinear


def _interleaved(nblocks=40, tpb=5, sets=4, ntiles=30, seed=0):
    """Blocks cycling through a few tile sets, as clustering leaves
    SparseLinear's weight: block b names set b % sets."""
    rng = np.random.default_rng(seed)
    lists = [np.sort(rng.choice(ntiles, tpb, replace=False))
             for _ in range(sets)]
    return np.stack([lists[b % sets] for b in range(nblocks)])


def _all_equal():
    return np.tile(np.array([3, 7, 8, 12]), (19, 1))


def _all_different():
    rng = np.random.default_rng(1)
    return np.stack([np.sort(rng.choice(200, 6, replace=False))
                     for _ in range(12)])


def _pads():
    """Live tiles first, the pad slots at the end naming tile 0."""
    ids = _interleaved(nblocks=17, tpb=6, sets=3, seed=2)
    ids[::2, 4:] = 0
    return ids


def _three_quarters():
    """Each block differs from the one before at one of 4 slots."""
    base = np.array([2, 5, 9, 11])
    rows = [base.copy() for _ in range(10)]
    for i in range(1, 10, 2):
        rows[i][3] = 20 + i
    return np.stack(rows)


LATTICES = {
    "interleaved": _interleaved,
    "all_equal": _all_equal,
    "all_different": _all_different,
    "pads": _pads,
    "three_quarters": _three_quarters,
    "one_block": lambda: np.array([[4, 0, 0]]),
}


def _schedule(name):
    ids = LATTICES[name]()
    tpb = ids.shape[1]
    return ids, spmm_panels(torch.from_numpy(ids.reshape(-1)).int(),
                            tiles_per_block=tpb)


@pytest.mark.parametrize("name", list(LATTICES))
def test_schedule_matches_a_loop_oracle(name):
    ids, p = _schedule(name)
    nblocks, tpb = ids.shape
    blocks = p.blocks.numpy()
    ptr = p.panel_ptr.numpy()
    eptr = p.entry_ptr.numpy()
    entries = p.entries.numpy()
    assert p.nblocks == nblocks and p.tiles_per_block == tpb
    assert sorted(blocks.tolist()) == list(range(nblocks))
    assert ptr[0] == 0 and ptr[-1] == nblocks and (np.diff(ptr) >= 1).all()
    assert np.diff(ptr).max() <= KERNEL_PANEL_BLOCKS
    assert eptr.shape == (p.npanels * tpb + 1,) and eptr[0] == 0
    assert eptr[-1] == p.nentries
    for q in range(p.npanels):
        members = blocks[ptr[q]: ptr[q + 1]]
        for t in range(tpb):
            got = entries[eptr[q * tpb + t]: eptr[q * tpb + t + 1]]
            want = sorted(set(ids[members, t].tolist()))
            assert got[:, 0].tolist() == want
            assert (got[:, 1] == t).all()
            for tile, _, mask in got:
                bits = [w for w, b in enumerate(members)
                        if ids[b, t] == tile]
                assert mask == sum(1 << w for w in bits)


@pytest.mark.parametrize("name,panels,tiles_per_slot", [
    ("interleaved", 8, 1.0),        # 4 sets of 10 blocks: 8 + 2 each
    ("all_equal", 3, 1.0),          # 19 blocks: 8 + 8 + 3
    ("all_different", 12, 1.0),     # panels of one
    # one run of 10 in tile-list order: the 5 equal blocks and 3 that
    # each name their own tile at slot 3 (3 + 4 entries), then 2 (3 + 2)
    ("three_quarters", 2, 1.5),
    ("one_block", 1, 1.0),
])
def test_blocks_that_share_tiles_share_panels(name, panels, tiles_per_slot):
    _, p = _schedule(name)
    assert p.npanels == panels
    assert p.tiles_per_slot == pytest.approx(tiles_per_slot)


def _walk(p, ids, a_values, b, dtype):
    """The panel kernel's sums in its order: per panel, the entries in
    (slot, tile) order; each named block's slab at the slot times B's
    rows of the tile (fp32, k ascending), added to the block's output in
    B's dtype after its slot."""
    nblocks, tpb = ids.shape
    block_r, block_k = a_values.shape[1:]
    k, n = b.shape
    bands = torch.nn.functional.pad(b.float(), (0, 0, 0, (-k) % block_k))
    out = torch.zeros((nblocks, block_r, n), dtype=dtype)
    blocks = p.blocks.tolist()
    ptr, eptr = p.panel_ptr.tolist(), p.entry_ptr.tolist()
    for q in range(p.npanels):
        for e in range(eptr[q * tpb], eptr[(q + 1) * tpb]):
            tile, slot, mask = p.entries[e].tolist()
            rows = bands[tile * block_k: (tile + 1) * block_k]
            for w in range(ptr[q + 1] - ptr[q]):
                if mask >> w & 1:
                    blk = blocks[ptr[q] + w]
                    part = a_values[blk * tpb + slot] @ rows
                    out[blk] = (out[blk].float() + part.to(dtype).float()
                                ).to(dtype)
    return out.view(nblocks * block_r, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", list(LATTICES))
def test_walking_the_schedule_equals_the_plain_version(name, dtype):
    ids, p = _schedule(name)
    nblocks, tpb = ids.shape
    block_k = 16
    rng = np.random.default_rng(3)
    a_values = torch.from_numpy(rng.integers(
        -2, 3, (nblocks * tpb, 8, block_k)).astype(np.float32))
    k = (int(ids.max()) + 1) * block_k - 5          # a ragged last tile
    b = torch.from_numpy(rng.integers(-3, 4, (k, 24)).astype(
        np.float32)).to(dtype)
    want = cluster_spmm_plain(torch.from_numpy(ids.reshape(-1)), a_values, b,
                              block_r=8, block_k=block_k,
                              tiles_per_block=tpb)
    assert torch.equal(_walk(p, ids, a_values, b, dtype), want)


def test_sparse_linear_layer_has_one_tile_per_panel_slot():
    """Blocks built from a few shared tile sets, rows shuffled: after the
    clustering each set's blocks form panels that stage one B tile per
    slot, and the layer keeps the schedule for its padded path."""
    rng = np.random.default_rng(0)
    rows, cols, sets = 128, 1024, 4
    tile_sets = [rng.choice(cols // 128, 3, replace=False)
                 for _ in range(sets)]
    w = np.zeros((rows, cols), np.float32)
    for i in range(rows):
        for t in tile_sets[i % sets]:
            sel = t * 128 + rng.choice(128, 30, replace=False)
            w[i, sel] = rng.integers(1, 4, 30)
    w = w[rng.permutation(rows)]
    layer = SparseLinear.from_dense(w, density=0.1, device="cpu")
    p = layer.panels
    assert p.nblocks == layer.bcc.nblocks
    assert p.tiles_per_slot == 1.0
    assert p.npanels < p.nblocks
    x = torch.from_numpy(rng.integers(-2, 3, (5, cols)).astype(np.float32))
    assert torch.equal(layer.apply(x, compact=False),
                       layer.apply(x, use_kernel=False))
