"""The port's gather/scatter tier against ``repro.core.spgemm``.

The binned row-wise and cluster-wise SpGEMM passes and both SpMM passes
run on the same packed operands in both packages (JAX on the CPU, the
port with ``device="cpu"``), over the six suite families plus empty rows
and blocks. Integer-valued operands make every fp32 sum exact in any
order, so the results must be equal; one float case per function is held
to ``rtol = atol = 1e-5`` (the two frameworks add in different orders).
"""
import numpy as np
import pytest
import torch

from repro.core import formats as RF
from repro.core import spgemm as RS
from repro.core.clustering import fixed_length_clusters
from repro_torch.core import formats as PF
from repro_torch.core import spgemm as PS

from torch_port_helpers import (FAMILIES, empty_rows_and_blocks,
                                family_pair, float_dense, host_pair)

CASES = FAMILIES + ("empty_rows_blocks", "float")


def _pair(name):
    if name == "empty_rows_blocks":
        dense = empty_rows_and_blocks()
        return host_pair(np.concatenate([dense, dense[:, :8]], axis=1))
    if name == "float":
        return host_pair(float_dense(96, 96, 0.08, 3))
    return family_pair(name)


def _check(got: torch.Tensor, want, name):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    if name == "float":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.array_equal(got, want)


def _row_inputs(h, b_lens, cap, indices):
    fetch = np.zeros(cap, dtype=np.int64)
    fetch[: h.nnz] = b_lens[indices.astype(np.int64)]
    return RS.length_bins(fetch, pad_sentinel=cap)


@pytest.mark.parametrize("name", CASES)
def test_gather_scatter_tier_matches(name):
    ref, port = _pair(name)
    rng = np.random.default_rng(7)
    # A² through the binned row-wise pass
    ra, pa = RF.csr_from_host(ref), PF.csr_from_host(port, device="cpu")
    bins = _row_inputs(ref, ref.row_nnz(), ra.nnz_cap, ref.indices)
    srows = RS.slot_rows_host(np.asarray(ra.indptr), ra.nnz_cap)
    assert np.array_equal(PS.slot_rows_host(port.indptr, pa.nnz_cap), srows)
    pbins = PS.length_bins(np.concatenate([
        port.row_nnz()[port.indices.astype(np.int64)],
        np.zeros(pa.nnz_cap - port.nnz, np.int64)]), pad_sentinel=pa.nnz_cap)
    assert [w for _, w in pbins] == [w for _, w in bins]
    assert all(np.array_equal(p, r) for (p, _), (r, _) in zip(pbins, bins))
    _check(PS.spgemm_rowwise_dense_binned(pa, pa, pbins, srows),
           RS.spgemm_rowwise_dense_binned(ra, ra, bins, srows), name)
    # … and the cluster-wise pass (Alg. 1) over fixed-length clusters
    bounds = fixed_length_clusters(ref, 8).boundaries.tolist()
    rc = RF.csr_cluster_from_host(ref, bounds, 8)
    pc = PF.csr_cluster_from_host(port, bounds, 8, device="cpu")
    total = int(np.asarray(rc.cluster_ptr)[-1])
    cols = np.asarray(rc.cols)[:total].astype(np.int64)
    fetch = np.zeros(rc.slot_cap, dtype=np.int64)
    fetch[:total] = np.where(cols < ref.nrows, ref.row_nnz()[
        np.clip(cols, 0, ref.nrows - 1)], 0)
    cbins = RS.length_bins(fetch, pad_sentinel=rc.slot_cap)
    sclust = RS.slot_rows_host(np.asarray(rc.cluster_ptr), rc.slot_cap)
    _check(PS.spgemm_clusterwise_dense_binned(pc, pa, cbins, sclust),
           RS.spgemm_clusterwise_dense_binned(rc, ra, cbins, sclust), name)
    # slot maps computed inside the passes when not given
    _check(PS.spgemm_rowwise_dense_binned(pa, pa, pbins),
           RS.spgemm_rowwise_dense_binned(ra, ra, bins), name)
    # tall-skinny SpMM, both dataflows
    if name == "float":
        bd = rng.standard_normal((ref.ncols, 12)).astype(np.float32)
    else:
        bd = rng.integers(-2, 3, (ref.ncols, 12)).astype(np.float32)
    bt = torch.from_numpy(bd)
    _check(PS.spmm_rowwise(pa, bt), RS.spmm_rowwise(ra, bd), name)
    _check(PS.spmm_clusterwise(pc, bt), RS.spmm_clusterwise(rc, bd), name)
    # the oracle and the flop count
    assert np.array_equal(PS.spgemm_reference(port, port),
                          RS.spgemm_reference(ref, ref))
    assert PS.flops_spgemm(port, port) == RS.flops_spgemm(ref, ref)


def test_general_spgemm_rectangular():
    """A·B with B a different, rectangular matrix (the ``ab`` path)."""
    ref_a, port_a = host_pair(float_dense(40, 56, 0.1, 11))
    ref_b, port_b = host_pair(float_dense(56, 24, 0.15, 12))
    ra, rb = RF.csr_from_host(ref_a), RF.csr_from_host(ref_b)
    pa = PF.csr_from_host(port_a, device="cpu")
    pb = PF.csr_from_host(port_b, device="cpu")
    bins = _row_inputs(ref_a, ref_b.row_nnz(), ra.nnz_cap, ref_a.indices)
    np.testing.assert_allclose(
        PS.spgemm_rowwise_dense_binned(pa, pb, bins).numpy(),
        np.asarray(RS.spgemm_rowwise_dense_binned(ra, rb, bins)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        PS.spgemm_rowwise_dense_binned(pa, pb, bins).numpy(),
        port_a.to_dense() @ port_b.to_dense(), rtol=1e-5, atol=1e-5)


def test_length_bins_empty_and_floor():
    assert PS.length_bins(np.zeros(5, np.int64)) == []
    bins = PS.length_bins(np.array([0, 1, 3, 9, 40]))
    assert [w for _, w in bins] == [8, 16, 64]
    ref = RS.length_bins(np.array([0, 1, 3, 9, 40]))
    assert all(np.array_equal(p, r) and pw == rw
               for (p, pw), (r, rw) in zip(bins, ref))
