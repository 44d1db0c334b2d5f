"""The hand-written CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA card (Hopper: the kernels are built for
``sm_90a``) and skips without one; on a card run them with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
Integer-valued operands compare exactly (``torch.equal``); bf16 B tiles
are compared with the plain version on the same bf16 inputs within 1e-5
of the largest value (fp32 summation order is the only difference).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.formats import (HostCSR, bcc_from_host,
                                      tiled_csr_from_host)
from repro_torch.kernels import ops
from repro_torch.kernels.cluster_spgemm import (
    cluster_spgemm_padded, cluster_spgemm_padded_plain,
    cluster_spgemm_revisit, cluster_spgemm_revisit_plain,
    cluster_spgemm_sharded, cluster_spgemm_sharded_plain,
    cluster_spgemm_windows, cluster_spgemm_windows_plain)
from repro_torch.kernels.cluster_spmm import (cluster_spmm_compact,
                                              cluster_spmm_compact_plain)
from repro_torch.planner.features import fingerprint
from repro_torch.planner.plan_cache import Plan, PlanCache
from repro_torch.planner.service import Planner
from repro_torch.resilience import ResiliencePolicy, faults
from repro_torch.serve.engine import SpGEMMServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _host(n, m, density, seed, *, integer=True):
    rng = np.random.default_rng(seed)
    vals = (rng.integers(1, 4, (n, m)) if integer
            else rng.uniform(0.5, 2.0, (n, m)))
    return HostCSR.from_dense(((rng.random((n, m)) < density)
                               * vals).astype(np.float32))


@pytest.mark.parametrize("n,k,m,density,block_k,sparse_c", [
    (40, 48, 40, 0.1, 128, False),        # ragged, one tile
    (300, 260, 200, 0.05, 128, True),     # ragged, slab output
    (512, 512, 512, 0.02, 256, False),
    (520, 1030, 384, 0.01, 512, False),   # block_k 512: 8 K sub-tiles
])
def test_window_kernel_matches_plain(card, n, k, m, density, block_k,
                                     sparse_c):
    a, b = _host(n, k, density, 1), _host(k, m, density, 2)
    bcc = bcc_from_host(a, block_k=block_k, device=card)
    tiled = tiled_csr_from_host(b, block_k=block_k, device=card)
    pack = ops.pack_spgemm(bcc, tiled, sparse_c=sparse_c)
    before = cluster_spgemm_windows.launches
    got = cluster_spgemm_windows(pack.launch, pack.stream[2], tiled.tiles)
    torch.cuda.synchronize()
    assert cluster_spgemm_windows.launches == before + 1
    want = cluster_spgemm_windows_plain(pack.launch, pack.stream[2],
                                        tiled.tiles)
    assert torch.equal(got, want)
    dense = ops.bcc_spgemm_tiled(bcc, tiled, pack=pack).cpu().numpy()
    assert np.array_equal(dense, a.to_dense() @ b.to_dense())


def test_window_kernel_bf16_tiles(card):
    a, b = _host(256, 256, 0.05, 3, integer=False), _host(256, 200, 0.05, 4,
                                                          integer=False)
    bcc = bcc_from_host(a, device=card)
    tiled = tiled_csr_from_host(b, device=card, dtype=torch.bfloat16)
    pack = ops.pack_spgemm(bcc, tiled, sparse_c=False)
    got = cluster_spgemm_windows(pack.launch, pack.stream[2], tiled.tiles)
    want = cluster_spgemm_windows_plain(pack.launch, pack.stream[2],
                                        tiled.tiles)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("n_cols", [64, 40, 200])
def test_compact_spmm_kernel_matches_plain(card, n_cols):
    a = _host(300, 260, 0.05, 5)
    bcc = bcc_from_host(a, device=card)
    block_ids, tile_ids, vals = ops.bcc_compact_stream(
        bcc, cover_all_blocks=True)
    rng = np.random.default_rng(n_cols)
    bd = torch.from_numpy(rng.integers(-2, 3, (260, n_cols)).astype(
        np.float32)).to(card)
    kw = dict(block_r=8, block_k=128, nblocks=bcc.nblocks)
    before = cluster_spmm_compact.launches
    got = cluster_spmm_compact(block_ids, tile_ids, vals, bd, **kw)
    torch.cuda.synchronize()
    assert cluster_spmm_compact.launches == before + 1
    assert torch.equal(got, cluster_spmm_compact_plain(
        block_ids, tile_ids, vals, bd, **kw))
    assert np.array_equal(got[:300].cpu().numpy(),
                          a.to_dense() @ bd.cpu().numpy())


def test_server_defaults_to_the_card(card):
    a = _host(200, 200, 0.05, 6)
    resp = SpGEMMServer().submit(a, reuse_hint=1)
    assert np.array_equal(resp.result, a.to_dense() @ a.to_dense())


def _wide(n, k, m, seed):
    """A (n, k) times B (k, m) with B wider than the live-pair grid's
    strip budget (m > 65,536): B is the identity plus a few random
    integers per row."""
    rng = np.random.default_rng(seed)
    a = _host(n, k, 0.002, seed)
    rows = np.repeat(np.arange(k), 3)
    cols = np.concatenate([np.arange(k)[:, None],
                           rng.integers(0, m, (k, 2))], axis=1).ravel()
    dense = np.zeros((k, m), np.float32)
    dense[rows, cols] = rng.integers(1, 4, rows.size)
    return a, HostCSR.from_dense(dense)


@pytest.mark.parametrize("block_k,dtype", [
    (128, torch.float32), (512, torch.float32), (128, torch.bfloat16)])
def test_padded_kernel_matches_plain(card, block_k, dtype):
    a, b = _wide(40, 1030, 66000, 7)
    bcc = bcc_from_host(a, block_k=block_k, device=card)
    tiled = tiled_csr_from_host(b, block_k=block_k, dtype=dtype,
                                device=card)
    pack = ops.pack_spgemm(bcc, tiled)
    assert pack.route == "padded"
    before = cluster_spgemm_padded.launches
    got = cluster_spgemm_padded(pack.launch, pack.stream[2], tiled.tiles)
    torch.cuda.synchronize()
    assert cluster_spgemm_padded.launches == before + 1
    assert got.dtype == dtype
    want = cluster_spgemm_padded_plain(pack.launch, pack.stream[2],
                                       tiled.tiles)
    assert torch.equal(got, want)       # integer sums, rounded once
    dense = ops.bcc_spgemm_tiled(None, tiled, pack=pack).float().cpu()
    assert np.array_equal(dense.numpy(), a.to_dense() @ b.to_dense())


@pytest.mark.parametrize("n,m", [(300, 200), (2100, 16384)])
def test_revisit_kernel_matches_plain_and_window_kernel(card, n, m):
    """(300, 200): nnb = 2, 256-block windows — the accumulator lives in
    global memory; (2100, 16384): nnb = 128, 4-block windows in shared
    memory."""
    a, b = _host(n, n, 0.02, 8), _host(n, m, 0.002, 9)
    bcc = bcc_from_host(a, device=card)
    tiled = tiled_csr_from_host(b, device=card)
    pack = ops.pack_spgemm(bcc, tiled, revisit=True)
    assert pack.route == "sharded_revisit"
    before = cluster_spgemm_revisit.launches
    got = cluster_spgemm_revisit(pack.launch, pack.stream[2], tiled.tiles)
    torch.cuda.synchronize()
    assert cluster_spgemm_revisit.launches == before + 1
    assert torch.equal(got, cluster_spgemm_revisit_plain(
        pack.launch, pack.stream[2], tiled.tiles))
    flat = ops.pack_spgemm(bcc, tiled, sparse_c=False)
    assert torch.equal(got, cluster_spgemm_windows(
        flat.launch, flat.stream[2], tiled.tiles))


@pytest.mark.parametrize("revisit", [False, True])
@pytest.mark.parametrize("shards", [3, 132])
def test_sharded_kernel_matches_plain(card, shards, revisit):
    a = _host(1030, 1030, 0.01, 10)
    bcc = bcc_from_host(a, device=card)
    tiled = tiled_csr_from_host(a, device=card)
    pack = ops.pack_spgemm(bcc, tiled, shards=shards, revisit=revisit)
    before = cluster_spgemm_sharded.launches
    got = cluster_spgemm_sharded(pack.launch, pack.stream[2], tiled.tiles)
    torch.cuda.synchronize()
    assert cluster_spgemm_sharded.launches == before + 1
    assert torch.equal(got, cluster_spgemm_sharded_plain(
        pack.launch, pack.stream[2], tiled.tiles))
    dense = ops.bcc_spgemm_tiled(None, tiled, pack=pack).cpu().numpy()
    assert np.array_equal(dense, a.to_dense() @ a.to_dense())


def test_server_ladder_degrades_to_the_fixed_rung_on_the_card(card):
    a = _host(256, 256, 0.03, 11)
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(a), reorder="original",
                   scheme="pallas", reuse_hint=20))
    server = SpGEMMServer(Planner(cache=cache, device=card,
                                  resilience=ResiliencePolicy()))
    with faults.injected(faults.FaultPlan(0, sites=["kernel_launch"])):
        resp = server.submit(a)
    assert resp.degraded and resp.fallback_scheme == "fixed"
    assert np.array_equal(resp.result, a.to_dense() @ a.to_dense())
    nxt = server.submit(a)
    assert nxt.scheme != "pallas" and not nxt.degraded
