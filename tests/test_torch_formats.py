"""The port's formats against the JAX package's, field for field.

Every packer of ``repro_torch.core.formats`` works on the host exactly
as ``repro.core.formats`` does; the tensors it makes must equal the JAX
arrays element for element (``np.array_equal``), on six suite families
plus empty rows and empty blocks. ``to_dense``, the live-pair stream,
the CompactedC table and round trip, and the carry-across of
``repro_torch.convert`` are held to the same standard.
"""
import doctest

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import formats as RF
from repro.core import suite as ref_suite
from repro.core.clustering import fixed_length_clusters
from repro.kernels import ops as rops
from repro.planner.plan_cache import Plan as RefPlan
from repro_torch import convert
from repro_torch.core import formats as PF
from repro_torch.core import suite as port_suite
from repro_torch.kernels import ops as pops
from repro_torch.planner import cost_model as port_cost_model

from torch_port_helpers import (FAMILIES, assert_same_fields,
                                empty_rows_and_blocks, family_pair,
                                float_dense, host_pair, ref_fields)

CASES = FAMILIES + ("empty_rows_blocks",)


def _pair(name):
    if name == "empty_rows_blocks":
        return host_pair(empty_rows_and_blocks())
    return family_pair(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_suite_generators_match(name):
    spec_r = next(s for s in ref_suite.SUITE if s.name == name)
    spec_p = next(s for s in port_suite.SUITE if s.name == name)
    ref, port = ref_suite.generate(spec_r), port_suite.generate(spec_p)
    assert ref.shape == port.shape
    for field in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(ref, field), getattr(port, field))


@pytest.mark.parametrize("name", CASES)
def test_csr_and_csr_cluster_match(name):
    ref, port = _pair(name)
    assert_same_fields(RF.csr_from_host(ref),
                       PF.csr_from_host(port, device="cpu"))
    bounds = fixed_length_clusters(ref, 8).boundaries.tolist()
    rc = RF.csr_cluster_from_host(ref, bounds, 8)
    pc = PF.csr_cluster_from_host(port, bounds, 8, device="cpu")
    assert_same_fields(rc, pc)
    dense = port.to_dense()
    assert np.array_equal(PF.csr_from_host(port, device="cpu")
                          .to_dense().numpy(), dense)
    assert np.array_equal(pc.to_dense().numpy(), dense)


@pytest.mark.parametrize("block_k", [16, 128])
@pytest.mark.parametrize("name", CASES)
def test_bcc_matches(name, block_k):
    ref, port = _pair(name)
    rb = RF.bcc_from_host(ref, block_k=block_k)
    pb = PF.bcc_from_host(port, block_k=block_k, device="cpu")
    assert_same_fields(rb, pb)
    assert np.array_equal(pb.to_dense().numpy(), port.to_dense())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_tiled_csr_matches(name, bf16):
    ref, port = _pair(name)
    rt = RF.tiled_csr_from_host(ref, block_k=32, bn=32,
                                dtype=jnp.bfloat16 if bf16 else jnp.float32)
    pt = PF.tiled_csr_from_host(port, block_k=32, bn=32, device="cpu",
                                dtype=torch.bfloat16 if bf16
                                else torch.float32)
    assert_same_fields(rt, pt)
    assert pt.ntiles_live == rt.ntiles_live == PF.tiled_live_tiles(port, 32,
                                                                   32)
    assert pt.nbytes_tiles() == rt.nbytes_tiles()
    if not bf16:
        assert np.array_equal(pt.to_dense().numpy(), port.to_dense())


@pytest.mark.parametrize("name", CASES)
def test_select_block_k_and_footprints_match(name):
    ref, port = _pair(name)
    assert PF.select_block_k(port) == RF.select_block_k(ref)
    assert PF.csr_nbytes(port) == RF.csr_nbytes(ref)
    for bk, bn in ((16, 16), (128, 128)):
        assert PF.tiled_live_tiles(port, bk, bn) == RF.tiled_live_tiles(
            ref, bk, bn)


@pytest.mark.parametrize("name", CASES)
def test_live_pair_stream_and_compacted_c_match(name):
    ref, port = _pair(name)
    rb = RF.bcc_from_host(ref, block_k=16)
    rt = RF.tiled_csr_from_host(ref, block_k=16, bn=16)
    pb = PF.bcc_from_host(port, block_k=16, device="cpu")
    pt = PF.tiled_csr_from_host(port, block_k=16, bn=16, device="cpu")
    rs = rops.bcc_compact_stream(rb, cover_all_blocks=True)
    ps = pops.bcc_compact_stream(pb, cover_all_blocks=True)
    kw = dict(nnb=rt.nnb, nblocks=rb.nblocks)
    rp = RF.live_pair_stream(rs[0], rs[1], np.asarray(rt.table), **kw)
    pp = PF.live_pair_stream(ps[0], ps[1], pt.table.numpy(), **kw)
    for got, want in zip(pp, rp):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert PF.live_pair_counters(pp, block_r=8, block_k=16, bn=16) \
        == RF.live_pair_counters(rp, block_r=8, block_k=16, bn=16)
    rtab, rn = RF.compacted_c_table(rp, nblocks=rb.nblocks, nnb=rt.nnb)
    ptab, pn = PF.compacted_c_table(pp, nblocks=rb.nblocks, nnb=rt.nnb)
    assert pn == rn and np.array_equal(ptab, rtab)


@pytest.mark.parametrize("name", CASES)
def test_compacted_c_round_trip_matches(name):
    ref, port = _pair(name)
    dense = port.to_dense()[:, : min(port.ncols, 64)]
    nrows, ncols = dense.shape
    nblocks, nnb = (nrows + 7) // 8, (ncols + 15) // 16
    win = np.abs(dense[: nblocks * 8]).reshape(-1, 8, ncols)
    live = np.zeros((nblocks, nnb), bool)
    for j in range(nnb):
        live[: win.shape[0], j] = win[:, :, j * 16:(j + 1) * 16].sum(
            axis=(1, 2)) > 0
    table = np.zeros(nblocks * nnb, np.int32)
    table[live.ravel()] = np.arange(1, int(live.sum()) + 1)
    kw = dict(nrows=nrows, ncols=ncols, block_r=8, bn=16)
    rc = RF.compacted_c_from_dense(dense, table, **kw)
    pc = PF.compacted_c_from_dense(torch.from_numpy(dense), table, **kw)
    assert_same_fields(rc, pc)
    assert np.array_equal(pc.to_dense().numpy(), dense)
    assert PF.compacted_c_counters(pc) == RF.compacted_c_counters(rc)
    back_r, back_p = RF.compacted_c_to_host(rc), PF.compacted_c_to_host(pc)
    for field in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(back_p, field), getattr(back_r, field))
    assert np.array_equal(back_p.to_dense(), dense)


def test_to_dense_matches_reference_small():
    """``to_dense`` of every device format against the JAX package's own
    ``to_dense`` (a small ragged float case: its loops are per tile)."""
    dense = float_dense(20, 36, 0.2, 5)
    ref, port = host_pair(dense)
    pairs = [
        (RF.csr_from_host(ref), PF.csr_from_host(port, device="cpu")),
        (RF.csr_cluster_from_host(ref, [0, 5, 9, 16], 8),
         PF.csr_cluster_from_host(port, [0, 5, 9, 16], 8, device="cpu")),
        (RF.bcc_from_host(ref, block_k=16),
         PF.bcc_from_host(port, block_k=16, device="cpu")),
        (RF.tiled_csr_from_host(ref, block_k=8, bn=16),
         PF.tiled_csr_from_host(port, block_k=8, bn=16, device="cpu")),
    ]
    for r, p in pairs:
        assert np.array_equal(p.to_dense().numpy(), np.asarray(r.to_dense()))


@pytest.mark.parametrize("kind,build", [
    ("CSR", lambda h: RF.csr_from_host(h)),
    ("CSRCluster", lambda h: RF.csr_cluster_from_host(h, [0, 5, 13, 16], 8)),
    ("BCC", lambda h: RF.bcc_from_host(h, block_k=16)),
    ("TiledCSR", lambda h: RF.tiled_csr_from_host(h, block_k=16, bn=16)),
    ("TiledCSR", lambda h: RF.tiled_csr_from_host(h, block_k=16, bn=16,
                                                  dtype=jnp.bfloat16)),
    ("CompactedC", lambda h: RF.compacted_c_from_dense(
        h.to_dense(), np.arange(3 * 2, dtype=np.int32) % 3, nrows=h.nrows,
        ncols=h.ncols, block_r=8, bn=16)),
])
def test_packed_from_numpy_round_trips(kind, build):
    ref, _ = host_pair(float_dense(24, 32, 0.25, 9))
    obj = build(ref)
    port = convert.packed_from_numpy(kind, ref_fields(obj), device="cpu")
    assert type(port).__name__ == kind
    assert_same_fields(obj, port)
    assert np.array_equal(port.to_dense().float().numpy(),
                          np.asarray(obj.to_dense(), dtype=np.float32))


def test_plan_from_numpy_round_trips():
    plan = RefPlan(fingerprint="abc", reorder="rcm", scheme="pallas",
                   reuse_hint=20, max_cluster=8, workload="spmm",
                   perm=np.array([2, 0, 1]), boundaries=np.array([0, 2]),
                   preprocess_s=0.5, predicted={"kernel_rel": 0.7})
    got = convert.plan_from_numpy(ref_fields(plan))
    assert (got.fingerprint, got.reorder, got.scheme, got.reuse_hint,
            got.max_cluster, got.workload, got.preprocess_s,
            got.predicted) == ("abc", "rcm", "pallas", 20, 8, "spmm", 0.5,
                               {"kernel_rel": 0.7})
    assert np.array_equal(got.perm, [2, 0, 1])
    assert np.array_equal(got.boundaries, [0, 2])
    bare = convert.plan_from_numpy(ref_fields(RefPlan(
        fingerprint="f", reorder="original", scheme="rowwise",
        reuse_hint=1)))
    assert bare.perm is None and bare.boundaries is None and bare.is_identity


@pytest.mark.parametrize("module", [PF, port_cost_model],
                         ids=["formats", "cost_model"])
def test_port_doctests(module):
    result = doctest.testmod(module, optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0
