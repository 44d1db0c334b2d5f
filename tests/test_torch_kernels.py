"""The window kernel's and the compact SpMM kernel's plain versions
against the JAX package's Pallas kernels (interpret mode), on the same
packed operands.

The JAX package packs (BCC, TiledCSR, the compact stream, the live-pair
and the window-major streams); ``repro_torch.convert`` carries the packed
arrays across, and the port's plain versions must reproduce every Pallas
variant they replace: ``cluster_spgemm_pairs{,_resident,_db}`` (dense
strips), ``cluster_spgemm_pairs_sparse{,_db}`` (CompactedC slabs) and
``cluster_spmm_compact``. Integer-valued operands compare exactly; float
operands within ``rtol = atol = 1e-5`` (summation order differs); bf16 B
tiles within 1e-5 of the JAX bf16 kernel on the same bf16 inputs and
within the documented 2e-2 relative bound of the fp32 product. The
kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import formats as RF
from repro.kernels import cluster_spgemm as RK
from repro.kernels import ops as rops
from repro.kernels.cluster_spmm import cluster_spmm_compact as ref_spmm
from repro_torch import convert
from repro_torch.core import formats as PF
from repro_torch.kernels import ops as pops
from repro_torch.kernels.cluster_spgemm import (
    cluster_spgemm_windows, cluster_spgemm_windows_plain, windows_from_pairs)
from repro_torch.kernels.cluster_spmm import (cluster_spmm_compact,
                                              cluster_spmm_compact_plain)

from torch_port_helpers import (empty_rows_and_blocks, float_dense,
                                host_pair, integer_dense, ref_fields)

pytestmark = pytest.mark.pallas

# (a dense, b dense, block_k, exact) — bn is 16 throughout
CASES = {
    "ragged": (integer_dense(40, 48, 0.10, 0), integer_dense(48, 40, 0.1, 1),
               16, True),
    "max_ragged": (integer_dense(17, 33, 0.15, 3),
                   integer_dense(33, 17, 0.15, 4), 16, True),
    "empty_blocks": (empty_rows_and_blocks(), integer_dense(32, 24, 0.4, 7),
                     16, True),
    "block_k_32": (integer_dense(48, 64, 0.08, 5),
                   integer_dense(64, 40, 0.08, 6), 32, True),
    "float": (float_dense(40, 48, 0.12, 8), float_dense(48, 40, 0.12, 9),
              16, False),
}


class Packed:
    """One case packed by the JAX package, carried across to the port."""

    def __init__(self, name, b_dtype=jnp.float32):
        a, b, bk, self.exact = CASES[name]
        self.a_dense, self.b_dense = a, b
        ra, _ = host_pair(a)
        rb_h, _ = host_pair(b)
        self.bk, self.bn = bk, 16
        self.rb = RF.bcc_from_host(ra, block_k=bk)
        self.rt = RF.tiled_csr_from_host(rb_h, block_k=bk, bn=16,
                                         dtype=b_dtype)
        self.stream = rops.bcc_compact_stream(self.rb, cover_all_blocks=True)
        self.pairs = rops.build_live_pairs(self.rb, self.rt, self.stream)
        self.sparse = rops.build_sparse_c_pairs(self.rb, self.rt, self.pairs,
                                                self.stream)
        self.nblocks = self.rb.nblocks
        self.nnb = self.rt.nnb
        self.a_values = convert.tensor_from_numpy(self.stream[2],
                                                  device="cpu")
        self.tiles = convert.packed_from_numpy(
            "TiledCSR", ref_fields(self.rt), device="cpu").tiles

    def dense(self):
        """The port's dense-strip launch of this case (plain on the CPU)."""
        w = windows_from_pairs(*self.pairs, nblocks=self.nblocks,
                               nnb=self.nnb, block_r=8, bn=16, device="cpu")
        return cluster_spgemm_windows(w, self.a_values, self.tiles)

    def slabs(self):
        """The port's CompactedC-slab launch of this case, through the
        live window keys of the JAX package's slab table."""
        w = windows_from_pairs(*self.pairs, nblocks=self.nblocks,
                               nnb=self.nnb, block_r=8, bn=16, device="cpu",
                               keys=np.flatnonzero(self.sparse[3] > 0))
        return cluster_spgemm_windows(w, self.a_values, self.tiles)

    def check(self, got, want):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        assert got.shape == want.shape
        if self.exact:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_dense_strip_plain_matches_pallas_pairs_kernels(name):
    p = Packed(name)
    kw = dict(block_r=8, block_k=p.bk, bn=16, nblocks=p.nblocks, nnb=p.nnb)
    got = p.dense()
    variants = [RK.cluster_spgemm_pairs, RK.cluster_spgemm_pairs_resident,
                RK.cluster_spgemm_pairs_db]
    for kernel in variants:
        want = kernel(*(np.asarray(x) for x in p.pairs), p.stream[2],
                      p.rt.tiles, interpret=True, **kw)
        p.check(got.numpy(), want)
    p.check(got.numpy()[: p.a_dense.shape[0], : p.b_dense.shape[1]],
            p.a_dense @ p.b_dense)


@pytest.mark.parametrize("name", list(CASES))
def test_slab_plain_matches_pallas_sparse_kernels(name):
    p = Packed(name)
    c_slots, slots, a_idx, table, nslabs = p.sparse
    kw = dict(block_r=8, block_k=p.bk, bn=16, nslabs=int(nslabs))
    got = p.slabs()
    variants = [RK.cluster_spgemm_pairs_sparse,
                RK.cluster_spgemm_pairs_sparse_db]
    for kernel in variants:
        want = kernel(c_slots, slots, a_idx, p.stream[2], p.rt.tiles,
                      interpret=True, **kw)
        p.check(got.numpy(), want)
    cc = PF.CompactedC.from_table(got, torch.from_numpy(table),
                                  nrows=p.a_dense.shape[0],
                                  ncols=p.b_dense.shape[1], block_r=8, bn=16)
    p.check(cc.to_dense().numpy(), p.a_dense @ p.b_dense)


@pytest.mark.parametrize("name", ["ragged", "empty_blocks"])
def test_bf16_tiles_plain_matches_pallas(name):
    p = Packed(name, b_dtype=jnp.bfloat16)
    p.a_values = p.a_values.float()
    kw = dict(block_r=8, block_k=p.bk, bn=16, nblocks=p.nblocks, nnb=p.nnb)
    assert p.tiles.dtype == torch.bfloat16
    got = p.dense().numpy()
    want = np.asarray(RK.cluster_spgemm_pairs(
        *(np.asarray(x) for x in p.pairs), p.stream[2], p.rt.tiles,
        interpret=True, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    exact = (p.a_dense @ p.b_dense)
    scale = max(np.abs(exact).max(), 1e-9)
    assert np.abs(got[: exact.shape[0], : exact.shape[1]] - exact).max() \
        / scale < 2e-2


@pytest.mark.parametrize("name", ["ragged", "empty_blocks", "float"])
@pytest.mark.parametrize("n_cols", [16, 13])
def test_compact_spmm_plain_matches_pallas(name, n_cols):
    p = Packed(name)
    rng = np.random.default_rng(n_cols)
    k = p.a_dense.shape[1]
    bd = (rng.integers(-2, 3, (k, n_cols)) if p.exact
          else rng.standard_normal((k, n_cols))).astype(np.float32)
    # the Pallas kernel needs K and N padded to the tile; the port masks
    k_pad = p.rb.block_k * ((k + p.bk - 1) // p.bk)
    padded = np.zeros((k_pad, 16), np.float32)
    padded[:k, :n_cols] = bd
    want = np.asarray(ref_spmm(*(np.asarray(s) for s in p.stream[:2]),
                               p.stream[2], jnp.asarray(padded), block_r=8,
                               block_k=p.bk, nblocks=p.nblocks, bn=16,
                               interpret=True))[:, :n_cols]
    kw = dict(block_r=8, block_k=p.bk, nblocks=p.nblocks)
    got = cluster_spmm_compact(p.stream[0], p.stream[1], p.a_values,
                               torch.from_numpy(bd), **kw)
    p.check(got.numpy(), want)
    plain = cluster_spmm_compact_plain(p.stream[0], p.stream[1],
                                       p.a_values, torch.from_numpy(bd),
                                       **kw)
    assert torch.equal(plain, got)


def test_windows_regroup_matches_build_sparse_c_pairs():
    """The window regrouping (a stable sort by window key) visits pairs in
    exactly the order of the JAX package's window-major stream, s
    ascending within each window, on both routes; with the slab table's
    live window keys its windows land on the stream's slabs."""
    for name in CASES:
        p = Packed(name)
        c_slots, slots, a_idx, table, nslabs = p.sparse
        dense = windows_from_pairs(*p.pairs, nblocks=p.nblocks, nnb=p.nnb,
                                   block_r=8, bn=16, device="cpu")
        slab = windows_from_pairs(*p.pairs, nblocks=p.nblocks, nnb=p.nnb,
                                  block_r=8, bn=16, device="cpu",
                                  keys=np.flatnonzero(table > 0))
        live = slots > 0
        counts = np.bincount(c_slots[live], minlength=int(nslabs))[1:]
        for w in (dense, slab):
            assert np.array_equal(w.slots.numpy(), slots[live])
            assert np.array_equal(w.a_idx.numpy(), a_idx[live])
            assert np.array_equal(np.diff(w.win_ptr.numpy()), counts)
        assert slab.out_shape == (int(nslabs), 8, 16)
        assert dense.nwin == int(nslabs) - 1 == int((table > 0).sum())
        # slab w+1 ↔ window key of the w-th live table entry
        keys = np.flatnonzero(table > 0)
        want_out = ((keys // p.nnb) * 8 * p.nnb * 16 + (keys % p.nnb) * 16)
        assert np.array_equal(dense.win_out.numpy(), want_out)
        assert np.array_equal(slab.win_out.numpy(),
                              np.arange(1, int(nslabs)) * 8 * 16)


def test_windows_plain_handles_no_live_pairs():
    zeros = np.zeros(8, np.int32)
    w = windows_from_pairs(zeros, zeros, zeros, zeros, nblocks=1, nnb=1,
                           block_r=8, bn=16, device="cpu")
    assert w.nwin == 0 and w.npairs == 0
    out = cluster_spgemm_windows(w, torch.zeros((1, 8, 16)),
                                 torch.zeros((1, 16, 16)))
    assert out.shape == (8, 16) and not out.any()
    assert torch.equal(out, cluster_spgemm_windows_plain(
        w, torch.zeros((1, 8, 16)), torch.zeros((1, 16, 16))))


def test_wrapper_rejects_mismatched_operands():
    p = Packed("ragged")
    w = windows_from_pairs(*p.pairs, nblocks=p.nblocks, nnb=p.nnb,
                           block_r=8, bn=16, device="cpu")
    with pytest.raises(ValueError, match="b_tiles"):
        cluster_spgemm_windows(w, p.a_values, p.tiles[:, :8])
    with pytest.raises(ValueError, match="float32"):
        cluster_spgemm_windows(w, p.a_values.double(), p.tiles)


# ---------------------------------------------------------------------------
# ops level: the port's wrappers against the JAX package's
# ---------------------------------------------------------------------------


def _ops_pair(name, **tiled_kw):
    a, b, bk, exact = CASES[name]
    ra, pa = host_pair(a)
    rb, pb = host_pair(b)
    ref = (RF.bcc_from_host(ra, block_k=bk),
           RF.tiled_csr_from_host(rb, block_k=bk, bn=16))
    port = (PF.bcc_from_host(pa, block_k=bk, device="cpu"),
            PF.tiled_csr_from_host(pb, block_k=bk, bn=16, device="cpu"))
    return ref, port, exact


@pytest.mark.parametrize("name", ["ragged", "empty_blocks", "block_k_32"])
def test_ops_host_packers_match(name):
    (rb, rt), (pb, pt), _ = _ops_pair(name)
    rs = rops.bcc_compact_stream(rb, cover_all_blocks=True)
    ps = pops.bcc_compact_stream(pb, cover_all_blocks=True)
    for got, want in zip((ps[0], ps[1], ps[2].numpy()), rs):
        assert np.array_equal(got, want)
    rp, pp = rops.build_live_pairs(rb, rt, rs), pops.build_live_pairs(pb, pt)
    assert all(np.array_equal(g, w) for g, w in zip(pp, rp))
    rsp = rops.build_sparse_c_pairs(rb, rt, rp, rs)
    psp = pops.build_sparse_c_pairs(pb, pt, pp, ps)
    assert all(np.array_equal(g, w) for g, w in zip(psp, rsp))
    kw = dict(nblocks=rb.nblocks, nnb=rt.nnb)
    assert pops.predict_c_window_density(pp, **kw) \
        == rops.predict_c_window_density(rp, **kw)
    assert pops.compact_grid_ok(pb, pt) == rops.compact_grid_ok(rb, rt)
    for ncols in (1, 1024, 65536, 65537, 10 ** 6):
        assert pops.compact_grid_ok_ncols(ncols) \
            == rops.compact_grid_ok_ncols(ncols)


@pytest.mark.parametrize("name", ["ragged", "empty_blocks", "float"])
def test_ops_spgemm_matches(name):
    (rb, rt), (pb, pt), exact = _ops_pair(name)
    want = np.asarray(rops.bcc_spgemm_tiled(rb, rt, interpret=True))
    packs = [None] + [pops.pack_spgemm(pb, pt, sparse_c=sc)
                      for sc in (False, True)]
    for pack in packs:
        got = pops.bcc_spgemm_tiled(pb, pt, pack=pack).numpy()
        if exact:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    rc = rops.bcc_spgemm_sparse_c(rb, rt, interpret=True, epilogue="kernel")
    pc = pops.bcc_spgemm_sparse_c(pb, pt)
    assert np.array_equal(pc.table.numpy(), np.asarray(rc.table))
    np.testing.assert_allclose(pc.slabs.numpy(), np.asarray(rc.slabs),
                               rtol=0 if exact else 1e-5,
                               atol=0 if exact else 1e-5)


@pytest.mark.parametrize("name", ["ragged", "empty_blocks"])
def test_ops_spmm_matches(name):
    (rb, _), (pb, _), _ = _ops_pair(name)
    bd = np.random.default_rng(3).integers(
        -2, 3, (rb.ncols, 24)).astype(np.float32)
    want = np.asarray(rops.bcc_spmm_compact(rb, jnp.asarray(bd),
                                            interpret=True))
    got = pops.bcc_spmm_compact(pb, torch.from_numpy(bd)).numpy()
    assert np.array_equal(got, want)


def test_ops_route_labels_and_padded_grid_refusal():
    from repro_torch.obs import metrics as obs_metrics
    (rb, rt), (pb, pt), _ = _ops_pair("ragged")
    reg = obs_metrics.get_registry()

    def count(v):
        return reg.counter("kernel_launches", variant=v).value

    before = {v: count(v) for v in ("resident", "sparse_c")}
    for sparse_c in (False, True):
        pops.bcc_spgemm_tiled(
            pb, pt, pack=pops.pack_spgemm(pb, pt, sparse_c=sparse_c))
    assert count("resident") == before["resident"] + 1    # small B store
    assert count("sparse_c") == before["sparse_c"] + 1
    pack = pops.pack_spgemm(pb, pt, sparse_c=False)
    with pytest.raises(ValueError, match="dense route"):
        pops.bcc_spgemm_sparse_c(pb, pt, pack=pack)
    # a C row strip past the budget is not refused any more: it runs on
    # the padded per-tile grid, labelled "padded", and builds no pairs
    wide = PF.tiled_csr_from_host(
        PF.HostCSR.from_dense(np.eye(128, 70000, dtype=np.float32)),
        block_k=128, device="cpu")
    a = PF.bcc_from_host(
        PF.HostCSR.from_dense(np.eye(8, 128, dtype=np.float32)),
        device="cpu")
    assert not pops.compact_grid_ok(a, wide)
    pack = pops.pack_spgemm(a, wide)
    assert pack.route == "padded" and pack.pairs is None
    padded = count("padded")
    got = pops.bcc_spgemm_tiled(a, wide, pack=pack)
    assert count("padded") == padded + 1
    assert np.array_equal(got.numpy(), np.eye(8, 70000, dtype=np.float32))
