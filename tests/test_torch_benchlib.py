"""The port's measurement tier against the JAX package's, on the CPU.

The same seeded suite matrices go through both packages:

* the paper's work counters (``symbolic_nnz``, ``symbolic_row_nnz``,
  ``gathers_*``, ``b_bytes_*``, ``csr_cluster_nbytes_exact``,
  ``tile_col_occupancy``, ``symbolic_strip_nnz``) and the two loop
  references are equal as integers;
* the unbinned oracles ``spgemm_rowwise_dense`` /
  ``spgemm_clusterwise_dense`` agree within 1e-5 relative on float values
  and exactly on integer values;
* ``benchlib``'s ``BenchResult`` carries the same ``nnz``, ``flops``,
  ``mem_bytes`` and ``nclusters`` (timings differ by nature), and
  ``representative_subset`` names the same specs;
* the port's sweep cache round-trips through a file of its own, keyed by
  the measuring device's generation tag.
"""
import json

import numpy as np
import pytest
import torch

from repro import benchlib as ref_bench
from repro.core import formats as ref_formats
from repro.core import spgemm as ref_spgemm
from repro.core.clustering import (fixed_length_clusters as ref_fixed,
                                   hierarchical_clusters as ref_hier,
                                   variable_length_clusters as ref_var)
from repro.kernels import ops as ref_ops
from repro_torch import benchlib
from repro_torch.core import formats as port_formats
from repro_torch.core import spgemm as port_spgemm
from repro_torch.core.clustering import (fixed_length_clusters,
                                         hierarchical_clusters,
                                         variable_length_clusters)
from repro_torch.kernels import ops as port_ops

from torch_port_helpers import family_pair

SPECS = ("kron_10_8", "cave_1024_16", "plaw_1024_10", "mesh2d_24",
         "kron_10_8_scr")
SCHEMES = ("fixed", "variable", "hierarchical")


def _clusterings(ref_h, port_h, scheme):
    """(reference, port) clustered matrices and boundaries of a scheme."""
    if scheme == "fixed":
        rc, pc = ref_fixed(ref_h, 8), fixed_length_clusters(port_h, 8)
        return ref_h, port_h, rc, pc
    if scheme == "variable":
        return ref_h, port_h, ref_var(ref_h), variable_length_clusters(port_h)
    rc, pc = ref_hier(ref_h), hierarchical_clusters(port_h)
    return (ref_h.permute_symmetric(rc.perm),
            port_h.permute_symmetric(pc.perm), rc, pc)


# ---------------------------------------------------------------------------
# work counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_work_counters_equal_the_jax_package(spec):
    ref_h, port_h = family_pair(spec)
    assert port_spgemm.symbolic_nnz(port_h, port_h) \
        == ref_spgemm.symbolic_nnz(ref_h, ref_h)
    np.testing.assert_array_equal(
        port_spgemm.symbolic_row_nnz(port_h, port_h),
        ref_spgemm.symbolic_row_nnz(ref_h, ref_h))
    assert port_spgemm.gathers_rowwise(port_h) \
        == ref_spgemm.gathers_rowwise(ref_h) == port_h.nnz
    lens = port_h.row_nnz()[port_h.indices]
    ref_bins = ref_spgemm.length_bins(ref_h.row_nnz()[ref_h.indices])
    port_bins = port_spgemm.length_bins(lens)
    got = port_spgemm.b_bytes_rowwise_binned(port_bins, port_h.nnz)
    assert got == ref_spgemm.b_bytes_rowwise_binned(ref_bins, ref_h.nnz)
    assert got > 0
    for bk in (128, 256):
        live = port_formats.tiled_live_tiles(port_h, bk)
        assert live == ref_formats.tiled_live_tiles(ref_h, bk)
        assert port_spgemm.b_bytes_tiled(live, bk) \
            == ref_spgemm.b_bytes_tiled(live, bk)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("spec", SPECS)
def test_cluster_bytes_and_slots_equal_the_jax_package(spec, scheme):
    ref_h, port_h = family_pair(spec)
    ref_a, port_a, rc, pc = _clusterings(ref_h, port_h, scheme)
    assert pc.boundaries.tolist() == rc.boundaries.tolist()
    bounds = pc.boundaries.tolist()
    fixed = scheme == "fixed"
    got = port_formats.csr_cluster_nbytes_exact(port_a, bounds,
                                                fixed_length=fixed)
    assert got == ref_formats.csr_cluster_nbytes_exact(ref_a, bounds,
                                                       fixed_length=fixed)
    assert got == port_formats.csr_cluster_nbytes_exact_reference(
        port_a, bounds, fixed_length=fixed)
    assert got == ref_formats.csr_cluster_nbytes_exact_reference(
        ref_a, bounds, fixed_length=fixed)
    # deduplicated (cluster, column) slots: the cluster-wise gathers
    cc = port_formats.csr_cluster_from_host(port_a, bounds, pc.max_cluster,
                                            device="cpu")
    ref_cc = ref_formats.csr_cluster_from_host(ref_a, bounds,
                                               max_cluster=rc.max_cluster)
    nslots = int(cc.cluster_ptr[-1])
    assert nslots == int(np.asarray(ref_cc.cluster_ptr)[-1])
    assert port_spgemm.gathers_clusterwise(nslots) \
        == ref_spgemm.gathers_clusterwise(nslots) <= port_h.nnz


@pytest.mark.parametrize("spec", SPECS)
def test_symbolic_strip_bounds_equal_the_jax_package(spec):
    """Occupancy, the vectorized per-strip bound and its loop reference,
    in both packages, on the live-pair stream of A² (block_r 32, so the
    loop references stay quick); each bound dominates the exact rows."""
    ref_h, port_h = family_pair(spec)
    br = 32
    ref_bcc = ref_formats.bcc_from_host(ref_h, block_r=br)
    ref_tiled = ref_formats.tiled_csr_from_host(ref_h)
    ref_pairs = ref_ops.build_live_pairs(ref_bcc, ref_tiled)
    bcc = port_formats.bcc_from_host(port_h, block_r=br, device="cpu")
    tiled = port_formats.tiled_csr_from_host(port_h, device="cpu")
    pairs = port_ops.build_live_pairs(bcc, tiled)
    occ = port_formats.tile_col_occupancy(tiled)
    ref_occ = ref_formats.tile_col_occupancy(ref_tiled)
    np.testing.assert_array_equal(occ, ref_occ)
    assert occ.dtype == bool and not occ[0].any()
    nblocks = (port_h.nrows + br - 1) // br
    kw = dict(nblocks=nblocks, nnb=tiled.nnb)
    ub = port_formats.symbolic_strip_nnz(pairs, occ, **kw)
    np.testing.assert_array_equal(
        ub, ref_formats.symbolic_strip_nnz(ref_pairs, ref_occ, **kw))
    np.testing.assert_array_equal(
        ub, port_formats.symbolic_strip_nnz_reference(pairs, occ, **kw))
    np.testing.assert_array_equal(
        ub, ref_formats.symbolic_strip_nnz_reference(ref_pairs, ref_occ,
                                                     **kw))
    exact = port_spgemm.symbolic_row_nnz(port_h, port_h)
    assert (exact <= ub[np.arange(port_h.nrows) // br]).all()


def test_tile_col_occupancy_reads_bf16_tiles():
    _, port_h = family_pair("mesh2d_24")
    f32 = port_formats.tiled_csr_from_host(port_h, device="cpu")
    bf16 = port_formats.tiled_csr_from_host(port_h, dtype=torch.bfloat16,
                                            device="cpu")
    np.testing.assert_array_equal(port_formats.tile_col_occupancy(bf16),
                                  port_formats.tile_col_occupancy(f32))


# ---------------------------------------------------------------------------
# the unbinned oracles
# ---------------------------------------------------------------------------


def _max_row(h):
    return max(int(h.row_nnz().max()), 1)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("spec", ["kron_10_8", "cave_1024_16",
                                  "mesh2d_24"])
def test_unbinned_rowwise_oracle_matches_the_jax_package(spec, integer):
    ref_h, port_h = family_pair(spec, integer=integer)
    w = _max_row(port_h)
    want = np.asarray(ref_spgemm.spgemm_rowwise_dense(
        ref_formats.csr_from_host(ref_h), ref_formats.csr_from_host(ref_h),
        w))
    csr = port_formats.csr_from_host(port_h, device="cpu")
    got = port_spgemm.spgemm_rowwise_dense(csr, csr, w).numpy()
    _agree(got, want, integer)
    _agree(got, port_h.to_dense() @ port_h.to_dense(), integer)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_unbinned_clusterwise_oracle_matches_the_jax_package(scheme,
                                                             integer):
    ref_h, port_h = family_pair("cave_1024_16", integer=integer)
    ref_a, port_a, rc, pc = _clusterings(ref_h, port_h, scheme)
    bounds = pc.boundaries.tolist()
    w = _max_row(port_a)
    want = np.asarray(ref_spgemm.spgemm_clusterwise_dense(
        ref_formats.csr_cluster_from_host(ref_a, bounds,
                                          max_cluster=rc.max_cluster),
        ref_formats.csr_from_host(ref_a), w))
    got = port_spgemm.spgemm_clusterwise_dense(
        port_formats.csr_cluster_from_host(port_a, bounds, pc.max_cluster,
                                           device="cpu"),
        port_formats.csr_from_host(port_a, device="cpu"), w).numpy()
    _agree(got, want, integer)
    _agree(got, port_a.to_dense() @ port_a.to_dense(), integer)


def _agree(got, want, integer):
    assert got.shape == want.shape
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# benchlib on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_caches(monkeypatch, tmp_path):
    """Empty in-process caches in both packages, files in ``tmp_path``."""
    monkeypatch.setattr(ref_bench, "_CACHE", {})
    monkeypatch.setattr(benchlib, "_CACHE", {})
    monkeypatch.setattr(ref_bench, "CACHE_PATH",
                        str(tmp_path / "ref_cache.json"))
    monkeypatch.setattr(benchlib, "CACHE_PATH",
                        str(tmp_path / "bench_cache_torch.json"))
    return tmp_path


def _fields(res):
    return (res.nnz, res.flops, res.mem_bytes, res.nclusters)


def _spec_pair(name):
    ref_h, port_h = family_pair(name, integer=False)
    return ref_h, port_h


@pytest.mark.parametrize("algo", ["original", "rcm"])
@pytest.mark.parametrize("spec", ["kron_10_8_scr", "cave_1024_16"])
def test_bench_results_carry_the_jax_package_fields(fresh_caches, spec,
                                                    algo):
    ref_h, port_h = _spec_pair(spec)
    want = ref_bench.bench_rowwise_on(ref_h, algo, name=spec, reps=1)
    got = benchlib.bench_rowwise_on(port_h, algo, name=spec, reps=1,
                                    device="cpu")
    assert _fields(got) == _fields(want)
    assert got.kernel_s > 0 and got.preprocess_s >= 0
    for scheme in SCHEMES:
        want = ref_bench.bench_clusterwise_on(ref_h, algo, scheme, name=spec,
                                              reps=1)
        got = benchlib.bench_clusterwise_on(port_h, algo, scheme, name=spec,
                                            reps=1, device="cpu")
        assert _fields(got) == _fields(want), scheme
        assert got.nclusters > 0 and got.mem_bytes > 0


@pytest.mark.parametrize("scheme", ["rowwise", "hierarchical"])
def test_tallskinny_results_carry_the_jax_package_fields(fresh_caches,
                                                         scheme):
    ref_h, port_h = _spec_pair("plaw_1024_10_scr")
    want = ref_bench.bench_tallskinny_on(ref_h, "rcm", scheme, name="p",
                                         width=32, reps=1)
    got = benchlib.bench_tallskinny_on(port_h, "rcm", scheme, name="p",
                                       width=32, reps=1, device="cpu")
    assert _fields(got) == _fields(want)


def test_binned_passes_equal_the_unbinned_oracle():
    """What benchlib times is the product: the binned row-wise and
    cluster-wise passes equal the unbinned oracle on integer values."""
    _, port_h = family_pair("kron_10_8")
    csr = port_formats.csr_from_host(port_h, device="cpu")
    want = port_spgemm.spgemm_rowwise_dense(csr, csr, _max_row(port_h))
    bins = port_spgemm.length_bins(port_h.row_nnz()[port_h.indices],
                                   pad_sentinel=csr.nnz_cap)
    assert torch.equal(port_spgemm.spgemm_rowwise_dense_binned(
        csr, csr, bins), want)
    cl = fixed_length_clusters(port_h, 8)
    cc = port_formats.csr_cluster_from_host(
        port_h, cl.boundaries.tolist(), cl.max_cluster, device="cpu")
    slot_cols = cc.cols[: int(cc.cluster_ptr[-1])].numpy().astype(np.int64)
    bins = port_spgemm.length_bins(port_h.row_nnz()[slot_cols],
                                   pad_sentinel=cc.slot_cap)
    assert torch.equal(port_spgemm.spgemm_clusterwise_dense_binned(
        cc, csr, bins), want)


@pytest.mark.parametrize("scheme", ("rowwise",) + SCHEMES)
def test_bench_check_sees_the_timed_product(fresh_caches, scheme):
    """``check`` gets the reordered (and clustered) operand and the timed
    pass's padded product, whose corner is that operand's square; a cache
    hit measures nothing and checks nothing."""
    _, port_h = family_pair("kron_10_8_scr")
    seen = []

    def check(b, c):
        want = b.to_dense() @ b.to_dense()
        assert c.shape[0] >= b.nrows
        np.testing.assert_array_equal(c[: b.nrows, : b.ncols].numpy(), want)
        seen.append(b.nnz)

    def bench():
        if scheme == "rowwise":
            return benchlib.bench_rowwise_on(port_h, "rcm", name="k", reps=1,
                                             device="cpu", check=check)
        return benchlib.bench_clusterwise_on(port_h, "rcm", scheme, name="k",
                                             reps=1, device="cpu",
                                             check=check)
    first = bench()
    assert seen == [port_h.nnz]
    assert bench() == first and len(seen) == 1


@pytest.mark.parametrize("limit", [8, 18])
def test_representative_subset_names_the_jax_package_specs(limit):
    got = [s.name for s in benchlib.representative_subset(limit)]
    assert got == [s.name for s in ref_bench.representative_subset(limit)]
    assert len(got) == limit == len(set(got))


def test_cache_round_trip_keys_the_measuring_device(fresh_caches):
    _, port_h = _spec_pair("mesh2d_24")
    first = benchlib.bench_rowwise_on(port_h, "original", name="m", reps=1,
                                      device="cpu")
    benchlib.save_cache()
    with open(benchlib.CACHE_PATH) as f:
        raw = json.load(f)
    assert list(raw) == ["m|original|rowwise|a2|torch1-cpu"]
    assert benchlib.kernel_gen("cpu") == "torch1-cpu"
    assert benchlib.kernel_gen("cuda:0") == "torch1-cuda"
    benchlib._CACHE = {}
    benchlib.load_cache()
    # served from the file: the stored timing comes back unchanged
    again = benchlib.bench_rowwise_on(port_h, "original", name="m",
                                      reps=1, device="cpu")
    assert again == first
    assert not (fresh_caches / "ref_cache.json").exists()


def test_time_fn_times_every_rep_and_returns_the_best():
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(4)

    t = benchlib.time_fn(fn, reps=3, warmup=2)
    assert len(calls) == 5 and 0 < t < 1
    assert benchlib.time_host_fn(lambda n: sum(range(n)), 1000, reps=2) > 0


def test_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, port_h = _spec_pair("mesh2d_24")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchlib.bench_rowwise_on(port_h, "original", name="m")
