"""The hand-written CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA card (Hopper: the kernels are built for
``sm_90a``) and skips without one; on a card run them with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The measurement tier is checked here too: ``benchlib.time_fn`` waits
for the card, ``benchlib``'s byte and flop fields do not depend on the
device, and a cold kron-14-pattern request plans what the kernel tier's
prior ranks first. This file imports no JAX, so it runs where only the
port is installed.
Integer-valued operands compare exactly (``torch.equal``); bf16 B tiles
are compared with the plain version on the same bf16 inputs within 1e-5
of the largest value (fp32 summation order is the only difference). The
flash-attention and SSD chunk-scan kernels sum in another order than
their plain versions: attention within 1e-5 absolute plus 1e-4 relative,
the scan within 1e-4 of its largest output (its sums run over up to 300
decayed terms).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import smoke_config
from repro_torch.core.formats import (HostCSR, bcc_from_host,
                                      block_diag_csr, tiled_csr_from_host)
from repro_torch.kernels import ops
from repro_torch.kernels.cluster_spgemm import (
    cluster_spgemm_padded, cluster_spgemm_padded_plain,
    cluster_spgemm_revisit, cluster_spgemm_revisit_plain,
    cluster_spgemm_sharded, cluster_spgemm_sharded_plain,
    cluster_spgemm_windows, cluster_spgemm_windows_plain)
from repro_torch.kernels.cluster_spmm import (cluster_spmm,
                                              cluster_spmm_compact,
                                              cluster_spmm_compact_plain,
                                              cluster_spmm_plain)
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain, flash_attention_tolerance)
from repro_torch.kernels.ssd_chunk import (ssd_chunk_scan,
                                           ssd_chunk_scan_plain)
from repro_torch.launch.serve import run_serving
from repro_torch.models.sparse_linear import SparseLinear
from repro_torch.models.transformer import init_params, prefill
from repro_torch.planner.executor import GatherSpMM
from repro_torch.planner.features import fingerprint
from repro_torch.planner.plan_cache import Plan, PlanCache
from repro_torch.planner.service import Planner
from repro_torch.resilience import ResiliencePolicy, faults
from repro_torch.serve.batcher import BatchPolicy
from repro_torch.serve.engine import Request, ServingEngine, SpGEMMServer
from repro_torch.serve.frontend import AsyncSpGEMMServer

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
    """(300, 200): nnb = 2, 256-block windows, split into segments of 4
    blocks for the shared-memory accumulator; (2100, 16384): nnb = 128,
    4-block windows."""
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


@pytest.mark.parametrize("block_k,dtype", [
    (128, torch.bfloat16), (512, torch.float32), (512, torch.bfloat16)])
def test_revisit_kernel_wide_windows_bf16_and_block_k_512(card, block_k,
                                                          dtype):
    """K7 at nnb = 2 (256-block windows in 4-block segments) with bf16
    tiles and at block_k = 512: integer values, so exact against the plain
    version and the window kernel."""
    a, b = _host(300, 1030, 0.02, 12), _host(1030, 200, 0.01, 13)
    bcc = bcc_from_host(a, block_k=block_k, device=card)
    tiled = tiled_csr_from_host(b, block_k=block_k, device=card,
                                dtype=dtype)
    pack = ops.pack_spgemm(bcc, tiled, revisit=True)
    assert pack.launch.window_blocks == 256 and pack.launch.max_nblk == 4
    before = cluster_spgemm_revisit.launches
    got = cluster_spgemm_revisit(pack.launch, pack.stream[2], tiled.tiles,
                                 pack.cols)
    torch.cuda.synchronize()
    assert cluster_spgemm_revisit.launches == before + 1
    assert torch.equal(got, cluster_spgemm_revisit_plain(
        pack.launch, pack.stream[2], tiled.tiles))
    flat = ops.pack_spgemm(bcc, tiled, sparse_c=False)
    assert torch.equal(got, cluster_spgemm_windows(
        flat.launch, flat.stream[2], tiled.tiles, flat.cols))
    dense = ops.bcc_spgemm_tiled(None, tiled, pack=pack).cpu().numpy()
    assert np.array_equal(dense, a.to_dense() @ b.to_dense())


@pytest.mark.parametrize("revisit", [False, True])
@pytest.mark.parametrize("shards", [1, 3, 132])
def test_sharded_kernel_one_cta_per_window_equals_window_kernel(
        card, shards, revisit):
    """K8 over 1, 3 and 132 shards, with and without the revisit order:
    one launch of one CTA per window or segment of every shard, exact
    against the plain version and the window kernel."""
    from repro_torch.core.formats import partition_pair_stream
    a = _host(1030, 1030, 0.01, 14)
    bcc = bcc_from_host(a, device=card)
    tiled = tiled_csr_from_host(a, device=card)
    if shards == 1 and not revisit:
        # one shard is not sharded by default: hand pack_spgemm the
        # partition
        pairs = ops.build_live_pairs(bcc, tiled)
        ranges, sp = partition_pair_stream(pairs, nblocks=bcc.nblocks,
                                           num_shards=1)
        pack = ops.pack_spgemm(bcc, tiled, shard_pack=(ranges, sp, None))
    else:
        pack = ops.pack_spgemm(bcc, tiled, shards=shards, revisit=revisit)
    work = pack.launch
    assert work.shard_ptr.shape[0] - 1 == min(shards, bcc.nblocks)
    before = cluster_spgemm_sharded.launches
    got = cluster_spgemm_sharded(work, pack.stream[2], tiled.tiles,
                                 pack.cols)
    torch.cuda.synchronize()
    assert cluster_spgemm_sharded.launches == before + 1
    assert torch.equal(got, cluster_spgemm_sharded_plain(
        work, pack.stream[2], tiled.tiles, pack.cols))
    flat = ops.pack_spgemm(bcc, tiled, sparse_c=False)
    assert torch.equal(got, cluster_spgemm_windows(
        flat.launch, flat.stream[2], tiled.tiles, flat.cols))


def test_server_ladder_degrades_to_the_fixed_rung_on_the_card(card):
    from repro_torch.obs import metrics as obs_metrics
    a = _host(256, 256, 0.03, 11)
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(a), reorder="original",
                   scheme="pallas", reuse_hint=20))
    server = SpGEMMServer(Planner(cache=cache, device=card,
                                  resilience=ResiliencePolicy()))
    want = a.to_dense() @ a.to_dense()
    reg = obs_metrics.get_registry()
    kernel, gather = (reg.counter("kernel_tier_products"),
                      reg.counter("gather_tier_products"))

    def tiers():
        return kernel.value, gather.value

    with faults.injected(faults.FaultPlan(0, sites=["kernel_launch"])):
        resp = server.submit(a)
    assert resp.degraded and resp.fallback_scheme == "fixed"
    assert np.array_equal(resp.result, want)
    # the breaker quarantines the failed (fingerprint, scheme, reorder)
    # triple; the re-plan takes the card prior's next candidate for a
    # sparse B, the kernel tier under rcm, and runs on it
    k0, g0 = tiers()
    nxt = server.submit(a)
    assert (nxt.reorder, nxt.scheme) == ("rcm", "pallas")
    assert not nxt.degraded
    assert tiers() == (k0 + 1, g0)
    assert np.array_equal(nxt.result, want)
    # a fault that persists in the kernel tier costs one degraded request
    # per reorder: rcm+pallas degrades in turn, and with both kernel-tier
    # triples quarantined the next plan is the prior's first gather scheme
    with faults.injected(faults.FaultPlan(0, sites=["kernel_launch"],
                                          max_fires=None)):
        third = server.submit(a)
    assert (third.reorder, third.scheme) == ("rcm", "pallas")
    assert third.degraded and third.fallback_scheme == "fixed"
    assert tiers() == (k0 + 1, g0 + 1)
    assert np.array_equal(third.result, want)
    last = server.submit(a)
    assert (last.reorder, last.scheme) == ("degree", "rowwise")
    assert not last.degraded
    assert tiers() == (k0 + 1, g0 + 2)
    assert np.array_equal(last.result, want)


@pytest.mark.parametrize("n_cols", [64, 40, 5])
def test_padded_spmm_kernel_matches_plain(card, n_cols):
    """BCC's padded lattice (K9): every block's tiles_per_block slabs,
    pads included; ragged K (260 rows) and N masked in the kernel."""
    a = _host(300, 260, 0.05, 12)
    bcc = bcc_from_host(a, device=card)
    assert int(bcc.ntiles.min()) < bcc.tiles_per_block   # some pad slabs
    rng = np.random.default_rng(n_cols)
    bd = torch.from_numpy(rng.integers(-2, 3, (260, n_cols)).astype(
        np.float32)).to(card)
    kw = dict(block_r=8, block_k=128, tiles_per_block=bcc.tiles_per_block)
    before = cluster_spmm.launches
    got = cluster_spmm(bcc.tile_ids, bcc.values, bd,
                       bn=min(128, max(8, n_cols)), **kw)
    torch.cuda.synchronize()
    assert cluster_spmm.launches == before + 1
    assert torch.equal(got, cluster_spmm_plain(bcc.tile_ids, bcc.values,
                                               bd, **kw))
    assert np.array_equal(ops.bcc_spmm(bcc, bd).cpu().numpy(),
                          a.to_dense() @ bd.cpu().numpy())


@pytest.mark.parametrize("compact", [False, True])
def test_sparse_linear_on_the_card(card, compact):
    rng = np.random.default_rng(13)
    w = ((rng.random((96, 700)) < 0.08)
         * rng.integers(1, 4, (96, 700))).astype(np.float32)
    lin = SparseLinear.from_dense(w, density=0.05, device=card)
    x = torch.from_numpy(rng.integers(-2, 3, (3, 5, 700)).astype(
        np.float32)).to(card)
    got = lin.apply(x, compact=compact)
    want = lin.apply(x, use_kernel=False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bh,sq,sk,d,causal", [
    (3, 128, 128, 16, True),
    (2, 256, 256, 64, True),
    (4, 1000, 1000, 80, True),       # ragged tail of a 64-row block
    (2, 300, 300, 128, True),
    (2, 100, 260, 80, False),
    (1, 1, 1, 80, True),
    (160, 1024, 1024, 128, True),    # qwen3-14b's prefill, 4 x 40 heads
    (96, 1024, 1024, 64, True),      # granite-moe-3b's prefill, 4 x 24 heads
])
def test_flash_attention_kernel_matches_plain(card, bh, sq, sk, d, causal):
    g = torch.Generator(device=card).manual_seed(bh * sq + d)
    q, k, v = (torch.randn((bh, s, d), generator=g, device=card)
               for s in (sq, sk, sk))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bh,sq,sk,d,causal", [
    (4, 1000, 1000, 80, True),
    (2, 100, 260, 80, False),
    (2, 129, 129, 7, True),          # scalar loads
    (2, 300, 300, 160, True),        # 32-key blocks
    (1, 200, 200, 256, False),
])
def test_flash_attention_kernel_in_16_bits(card, dtype, bh, sq, sk, d,
                                           causal):
    g = torch.Generator(device=card).manual_seed(bh * sq + d)
    q, k, v = (torch.randn((bh, s, d), generator=g, device=card).to(dtype)
               for s in (sq, sk, sk))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype
    want = flash_attention_plain(q, k, v, causal=causal)
    # per element, three unit roundoffs of what each row sums
    tol = flash_attention_tolerance(q, k, v, want, causal=causal)
    excess = float(((got.float() - want.float()).abs() / tol).max())
    assert excess <= 1.0, excess


@pytest.mark.parametrize("d,sq,causal", [(160, 300, True), (129, 64, False),
                                         (256, 1000, True)])
def test_flash_attention_kernel_past_d_128(card, d, sq, causal):
    g = torch.Generator(device=card).manual_seed(sq + d)
    q, k, v = (torch.randn((2, sq, d), generator=g, device=card)
               for _ in range(3))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, flash_attention_plain(q, k, v,
                                                          causal=causal),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="D <= 256"):
        flash_attention(*(torch.zeros((1, 8, 257), device=card)
                          for _ in range(3)))


def _rounding_operands(card, seed):
    """Integer A and B whose partial sums pass bf16's 8-bit significand
    (values 1..15 at density 0.5, K = 300: three 128-wide k-tiles)."""
    rng = np.random.default_rng(seed)
    a = HostCSR.from_dense(((rng.random((64, 300)) < 0.5)
                            * rng.integers(1, 16, (64, 300))).astype(
                                np.float32))
    b = ((rng.random((300, 40)) < 0.5)
         * rng.integers(1, 16, (300, 40))).astype(np.float32)
    bcc = bcc_from_host(a, device=card)
    return bcc, torch.from_numpy(b).to(card)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_spmm_kernels_in_16_bits_round_after_every_step(card, dtype):
    """K4 and K9 with 16-bit B give C in B's dtype, each step's fp32
    product rounded to it and added in it, as the JAX package's kernels
    do: equal to the plain versions, and (bf16) not the fp32 product
    rounded once."""
    bcc, b32 = _rounding_operands(card, 31)
    b = b32.to(dtype)
    bids, tids, vals = ops.bcc_compact_stream(bcc, cover_all_blocks=True)
    kw = dict(block_r=8, block_k=128, nblocks=bcc.nblocks)
    got4 = cluster_spmm_compact(bids, tids, vals, b, bn=40, **kw)
    pkw = dict(block_r=8, block_k=128, tiles_per_block=bcc.tiles_per_block)
    got9 = cluster_spmm(bcc.tile_ids, bcc.values, b, bn=40, **pkw)
    torch.cuda.synchronize()
    assert got4.dtype == got9.dtype == dtype
    assert torch.equal(got4, cluster_spmm_compact_plain(bids, tids, vals, b,
                                                        **kw))
    assert torch.equal(got9, cluster_spmm_plain(bcc.tile_ids, bcc.values, b,
                                                **pkw))
    once = cluster_spmm_compact(bids, tids, vals, b32, bn=40, **kw).to(dtype)
    if dtype == torch.bfloat16:
        assert not torch.equal(got4, once)
        assert not torch.equal(got9, once)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n_cols,block_k", [(64, 128), (13, 128), (130, 128),
                                            (64, 512)])
def test_column_spmm_kernel_in_16_bits_exact_on_integers(card, dtype, n_cols,
                                                         block_k):
    a = _host(300, 1100, 0.02, 21)
    bcc, (bids, tids, vals), bd = _spmm_operands(card, a, n_cols,
                                                 block_k=block_k)
    bd = bd.to(dtype)
    cols = ops.slab_columns(vals)
    kw = dict(block_r=8, block_k=block_k, nblocks=bcc.nblocks)
    got = cluster_spmm_compact(bids, tids, vals, bd, bn=min(128, n_cols),
                               cols=cols, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, cluster_spmm_compact_plain(bids, tids, vals, bd,
                                                       cols=cols, **kw))
    assert np.array_equal(got[: a.nrows].float().cpu().numpy(),
                          a.to_dense() @ bd.float().cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_column_spmm_non_finite_16_bit_b_equals_plain(card, dtype):
    a = _host(300, 1100, 0.02, 22)
    bcc, (bids, tids, vals), bd = _spmm_operands(card, a, 64)
    bd = bd.to(dtype)
    bd[5, 3] = float("inf")
    bd[700, 10] = float("nan")
    bd[1099, 0] = -float("inf")
    kw = dict(block_r=8, block_k=128, nblocks=bcc.nblocks)
    got = cluster_spmm_compact(bids, tids, vals, bd, bn=64, **kw)
    want = cluster_spmm_compact_plain(bids, tids, vals, bd, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    assert bool(got.isnan().any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("compact", [False, True])
def test_sparse_linear_on_the_card_in_16_bits(card, dtype, compact):
    rng = np.random.default_rng(13)
    w = ((rng.random((96, 700)) < 0.08)
         * rng.integers(1, 4, (96, 700))).astype(np.float32)
    lin = SparseLinear.from_dense(w, density=0.05, device=card)
    x = torch.from_numpy(rng.integers(-2, 3, (3, 5, 700)).astype(
        np.float32)).to(card)
    got = lin.apply(x.to(dtype), compact=compact)
    assert got.dtype == dtype
    assert torch.equal(got.float(), lin.apply(x, use_kernel=False))
    assert lin.apply(x.double(), compact=compact).dtype == torch.float32


def test_flash_mha_gqa_on_the_card(card):
    g = torch.Generator(device=card).manual_seed(14)
    q = torch.randn((2, 8, 192, 80), generator=g, device=card)
    k, v = (torch.randn((2, 2, 192, 80), generator=g, device=card)
            for _ in range(2))
    got = ops.flash_mha(q, k, v)
    want = flash_attention_plain(
        q.reshape(16, 192, 80),
        torch.repeat_interleave(k, 4, dim=1).reshape(16, 192, 80),
        torch.repeat_interleave(v, 4, dim=1).reshape(16, 192, 80))
    torch.testing.assert_close(got, want.reshape(2, 8, 192, 80), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("hq,hkv,d", [
    (40, 8, 128),                    # qwen3-14b: 5 query heads per KV head
    (48, 1, 128),                    # granite-34b: multi-query
    (24, 8, 64),                     # granite-moe-3b: 3 per KV head
])
def test_flash_mha_at_the_zoo_head_ratios(card, hq, hkv, d):
    g = torch.Generator(device=card).manual_seed(hq * d + hkv)
    q = torch.randn((2, hq, 256, d), generator=g, device=card)
    k, v = (torch.randn((2, hkv, 256, d), generator=g, device=card)
            for _ in range(2))
    before = flash_attention.launches
    got = ops.flash_mha(q, k, v)
    assert flash_attention.launches == before + 1
    rep = hq // hkv
    want = flash_attention_plain(
        q.reshape(2 * hq, 256, d),
        torch.repeat_interleave(k, rep, dim=1).reshape(2 * hq, 256, d),
        torch.repeat_interleave(v, rep, dim=1).reshape(2 * hq, 256, d))
    torch.testing.assert_close(got, want.reshape(2, hq, 256, d), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("bh,nc,q,p,n,rep", [
    (4, 3, 64, 16, 16, 1),
    (3, 2, 256, 64, 64, 1),          # the zamba2 chunk
    (2, 1, 300, 64, 64, 1),          # one ragged chunk of a whole sequence
    (2, 2, 32, 64, 128, 1),
    (2, 3, 1, 8, 8, 1),
    (8, 2, 256, 64, 64, 8),          # one group (G = 1) of 8 heads
    (6, 1, 75, 16, 16, 3),           # groups with BH·nc·Q not a multiple of 4
])
def test_ssd_chunk_kernel_matches_plain(card, bh, nc, q, p, n, rep):
    g = torch.Generator(device=card).manual_seed(bh * q + n)
    x = torch.randn((bh, nc, q, p), generator=g, device=card) * 0.3
    a = -torch.rand((bh, nc, q), generator=g, device=card) * 0.3
    b, c = (torch.randn((bh // rep, nc, q, n), generator=g, device=card)
            for _ in range(2))
    before = ssd_chunk_scan.launches
    y, h = ssd_chunk_scan(x, a, b, c, heads_per_group=rep)
    torch.cuda.synchronize()
    assert ssd_chunk_scan.launches == before + 1
    y0, h0 = ssd_chunk_scan_plain(x, a, b, c, heads_per_group=rep)
    for got, want in ((y, y0), (h, h0)):
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), err


def test_run_serving_launches_both_lm_kernels(card):
    """The zamba2 smoke config (4 Mamba2 layers, the shared attention
    block after every 2): one prefill is 2 flash-attention and 4 SSD
    launches; decoding launches neither."""
    flash_attention.launches = 0
    ssd_chunk_scan.launches = 0
    out = run_serving("zamba2-2.7b", smoke=True, batch=2, prompt_len=40,
                      gen=4)
    assert (flash_attention.launches, ssd_chunk_scan.launches) == (2, 4)
    assert out["tokens"].shape == (2, 4)
    assert (out["tokens"] < 128).all()


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m",
                                  "musicgen-large", "qwen2-vl-72b"])
def test_zoo_prefill_launches_flash_attention(card, arch):
    """The smoke configs of the four families on the card: one prefill is
    one flash-attention launch per layer, its logits within 2e-3 of the
    largest of the chunked path's; ``run_serving`` decodes in the
    vocabulary."""
    cfg = smoke_config(arch)
    params = init_params(cfg, 0, device=card)
    rng = np.random.default_rng(0)
    if cfg.frontend == "tokens":
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 64))).to(card)}
    else:
        batch = {"embeddings": torch.from_numpy(rng.standard_normal(
            (2, 64, cfg.d_model)).astype(np.float32)).to(card)}
    flash_attention.launches = 0
    kern, _ = prefill(cfg, params, batch, 70, use_pallas=True)
    assert flash_attention.launches == cfg.num_layers
    chunked, _ = prefill(cfg, params, batch, 70, use_pallas=False)
    v = cfg.vocab_size
    err = float((kern[..., :v] - chunked[..., :v]).abs().max())
    assert err <= 2e-3 * float(chunked[..., :v].abs().max())
    out = run_serving(arch, smoke=True, batch=2, prompt_len=40, gen=4)
    assert (out["tokens"] < v).all()


def test_serving_engine_on_the_card(card):
    """The engine on the qwen3 smoke config: 3 requests on 2 slots, the
    shared ``pos`` past ``max_len`` 8 (the last slot rewritten)."""
    cfg = smoke_config("qwen3-14b")
    eng = ServingEngine(cfg, init_params(cfg, 0, device=card), slots=2,
                        max_len=8)
    reqs = [Request(prompt=np.asarray(p), max_new_tokens=4)
            for p in ([1, 2, 3], [4, 5, 6, 7, 8], [9, 10])]
    for r in reqs:
        eng.submit(r)
    eng.run(steps=32)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
    assert eng.cache["pos"] == 18 and eng.cache["k"].device.type == "cuda"


# -- the live-column kernels (K4's compact SpMM, K1's window walk) ---------


def _spmm_operands(card, a, n_cols, *, block_k=128, integer=True, seed=0):
    bcc = bcc_from_host(a, block_k=block_k, device=card)
    stream = ops.bcc_compact_stream(bcc, cover_all_blocks=True)
    rng = np.random.default_rng(seed)
    bd = (rng.integers(-2, 3, (a.ncols, n_cols)) if integer
          else rng.standard_normal((a.ncols, n_cols)))
    return bcc, stream, torch.from_numpy(bd.astype(np.float32)).to(card)


@pytest.mark.parametrize("n_cols,block_k", [
    (64, 128), (40, 128),      # bn < 128: threads follow the strip width
    (13, 128),                 # N not a multiple of 4: scalar loads
    (130, 128),                # two strips, the last 2 wide
    (64, 512),                 # block_k 512
])
def test_column_spmm_kernel_exact_on_integers(card, n_cols, block_k):
    a = _host(300, 1100, 0.02, 21)
    bcc, (bids, tids, vals), bd = _spmm_operands(card, a, n_cols,
                                                 block_k=block_k)
    cols = ops.slab_columns(vals)
    kw = dict(block_r=8, block_k=block_k, nblocks=bcc.nblocks,
              bn=min(128, n_cols))
    before = cluster_spmm_compact.launches
    got = cluster_spmm_compact(bids, tids, vals, bd, cols=cols, **kw)
    torch.cuda.synchronize()
    assert cluster_spmm_compact.launches == before + 1
    kw.pop("bn")
    assert torch.equal(got, cluster_spmm_compact_plain(
        bids, tids, vals, bd, cols=cols, **kw))
    assert np.array_equal(got[:300].cpu().numpy(),
                          a.to_dense() @ bd.cpu().numpy())


@pytest.mark.parametrize("n_cols", [64, 40])
def test_column_spmm_equals_the_tile_padded_sums_on_floats(card, n_cols):
    """Skipping zero columns is exact (fmaf(0, b, x) == x), and each step
    is summed k ascending and added to the block in step order, as the
    tile-padded body (still K9's, on the padded lattice) sums it: the two
    agree bit for bit on float data too."""
    a = _host(300, 700, 0.03, 22, integer=False)
    bcc, (bids, tids, vals), bd = _spmm_operands(card, a, n_cols,
                                                 integer=False)
    got = cluster_spmm_compact(bids, tids, vals, bd, block_r=8,
                               block_k=128, nblocks=bcc.nblocks, bn=n_cols)
    tiled = cluster_spmm(bcc.tile_ids, bcc.values, bd, block_r=8,
                         block_k=128, tiles_per_block=bcc.tiles_per_block,
                         bn=n_cols)
    assert torch.equal(got, tiled)
    want = cluster_spmm_compact_plain(bids, tids, vals, bd, block_r=8,
                                      block_k=128, nblocks=bcc.nblocks)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_column_spmm_all_zero_stream(card):
    a = HostCSR.from_dense(np.zeros((40, 300), np.float32))
    bcc, (bids, tids, vals), bd = _spmm_operands(card, a, 64)
    cols = ops.slab_columns(vals)
    assert cols.ncols == 0
    got = cluster_spmm_compact(bids, tids, vals, bd, block_r=8,
                               block_k=128, nblocks=bcc.nblocks, bn=64,
                               cols=cols)
    torch.cuda.synchronize()
    assert got.shape == (40, 64) and not got.any()


def test_column_spmm_on_a_dense_sparse_linear_slab(card):
    """The column form's worst case: every column of every slab live."""
    rng = np.random.default_rng(23)
    w = rng.integers(1, 4, (64, 384)).astype(np.float32) * rng.choice(
        [-1, 1], (64, 384))
    layer = SparseLinear.from_dense(w, density=1.0, device=card)
    assert layer.cols.ncols == layer.stream[2].shape[0] * 128
    x = torch.from_numpy(rng.integers(-2, 3, (96, 384)).astype(
        np.float32)).to(card)
    before = cluster_spmm_compact.launches
    y = layer.apply(x)
    torch.cuda.synchronize()
    assert cluster_spmm_compact.launches == before + 1
    assert torch.equal(y, layer.apply(x, use_kernel=False))


@pytest.mark.parametrize("bn,block_k,dtype", [
    (128, 128, torch.float32),
    (40, 128, torch.float32),     # bn < 128
    (30, 128, torch.float32),     # bn not a multiple of 4: scalar loads
    (128, 512, torch.float32),    # block_k 512
    (128, 128, torch.bfloat16),   # bf16 tiles, 8-byte loads
    (40, 256, torch.bfloat16),
])
def test_column_window_kernel_exact_on_integers(card, bn, block_k, dtype):
    a, b = _host(400, 900, 0.02, 24), _host(900, 300, 0.02, 25)
    bcc = bcc_from_host(a, block_k=block_k, device=card)
    tiled = tiled_csr_from_host(b, block_k=block_k, bn=bn, dtype=dtype,
                                device=card)
    for sparse_c in (False, True):
        pack = ops.pack_spgemm(bcc, tiled, sparse_c=sparse_c)
        assert pack.cols is not None
        before = cluster_spgemm_windows.launches
        got = cluster_spgemm_windows(pack.launch, pack.stream[2],
                                     tiled.tiles, pack.cols)
        torch.cuda.synchronize()
        assert cluster_spgemm_windows.launches == before + 1
        assert torch.equal(got, cluster_spgemm_windows_plain(
            pack.launch, pack.stream[2], tiled.tiles, pack.cols))
        dense = ops.bcc_spgemm_tiled(None, tiled, pack=pack).cpu().numpy()
        assert np.array_equal(dense, a.to_dense() @ b.to_dense())


def test_column_window_kernel_all_zero_slabs(card):
    """Live pairs whose A slab has no live column (values cancelled to
    zero after packing) add nothing and leave their windows zero."""
    a, b = _host(64, 256, 0.05, 26), _host(256, 128, 0.05, 27)
    bcc = bcc_from_host(a, device=card)
    tiled = tiled_csr_from_host(b, device=card)
    pack = ops.pack_spgemm(bcc, tiled, sparse_c=False)
    zeros = torch.zeros_like(pack.stream[2])
    got = cluster_spgemm_windows(pack.launch, zeros, tiled.tiles)
    torch.cuda.synchronize()
    assert pack.launch.npairs > 0 and not got.any()


def test_padded_kernel_rounds_bf16_after_every_step(card):
    """K6 with bf16 B tiles rounds each step's product to bf16 and the
    running tile again, as the JAX package's padded kernels do: integer
    sums past bf16's 8-bit significand tell that apart from rounding the
    fp32 sum once."""
    rng = np.random.default_rng(28)
    a = HostCSR.from_dense(((rng.random((64, 96)) < 0.5)
                            * rng.integers(1, 16, (64, 96))).astype(
                                np.float32))
    b = HostCSR.from_dense(((rng.random((96, 64)) < 0.5)
                            * rng.integers(1, 16, (96, 64))).astype(
                                np.float32))
    bcc = bcc_from_host(a, block_k=16, device=card)
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        tiled = tiled_csr_from_host(b, block_k=16, bn=16, dtype=dtype,
                                    device=card)
        pack = ops.pack_spgemm(bcc, tiled, compact=False)
        got[dtype] = cluster_spgemm_padded(pack.launch, pack.stream[2],
                                           tiled.tiles)
        torch.cuda.synchronize()
        assert torch.equal(got[dtype], cluster_spgemm_padded_plain(
            pack.launch, pack.stream[2], tiled.tiles))
    once = got[torch.float32].to(torch.bfloat16)
    assert not torch.equal(got[torch.bfloat16], once)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_column_kernels_run_several_units_per_cta(card, dtype):
    """Seventeen k-tiles per row block: the window kernel gets 17 pairs
    per window and the SpMM kernel 17 steps per block, so both CTAs run
    several unit groups (a ragged last round included) and add their
    parts in unit order."""
    a, b = _host(64, 2100, 0.3, 29), _host(2100, 256, 0.3, 30)
    bcc = bcc_from_host(a, device=card)
    tiled = tiled_csr_from_host(b, dtype=dtype, device=card)
    pack = ops.pack_spgemm(bcc, tiled, sparse_c=False)
    assert pack.launch.npairs >= 8 * pack.launch.nwin
    got = cluster_spgemm_windows(pack.launch, pack.stream[2], tiled.tiles,
                                 pack.cols)
    torch.cuda.synchronize()
    assert torch.equal(got, cluster_spgemm_windows_plain(
        pack.launch, pack.stream[2], tiled.tiles, pack.cols))
    if dtype == torch.float32:
        assert np.array_equal(got[:64, :256].cpu().numpy(),
                              a.to_dense() @ b.to_dense())
    bids, tids, vals = ops.bcc_compact_stream(bcc, cover_all_blocks=True)
    bd = torch.from_numpy(np.random.default_rng(31).integers(
        -2, 3, (2100, 64)).astype(np.float32)).to(card)
    kw = dict(block_r=8, block_k=128, nblocks=bcc.nblocks)
    out = cluster_spmm_compact(bids, tids, vals, bd, bn=64, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, cluster_spmm_compact_plain(bids, tids, vals, bd,
                                                       **kw))


def _same_values(got, want):
    """Equal position for position: NaN where the other is NaN, inf of
    the same sign, equal finite values."""
    return bool(((got == want) | (got.isnan() & want.isnan())).all())


@pytest.mark.parametrize("n_cols,block_k", [(64, 128), (40, 128), (13, 128),
                                            (130, 128), (64, 512)])
def test_column_spmm_non_finite_b_equals_plain(card, n_cols, block_k):
    """Inf and NaN values of B in live columns, in slabs' dead columns,
    in a tile no slab covers and in the ragged last tile: the kernel and
    its plain version give NaN at the same positions, inf of the same
    sign and equal finite values, and a dead column's non-finite value
    reaches its block."""
    a = _host(120, 3 * block_k - 37, 0.03, 41)
    bcc, (bids, tids, vals), bd = _spmm_operands(card, a, n_cols,
                                                 block_k=block_k, seed=42)
    rng = np.random.default_rng(43)
    k = a.ncols
    for row, col, val in zip(rng.integers(0, k, 24),
                             rng.integers(0, n_cols, 24),
                             [np.inf, -np.inf, np.nan] * 8):
        bd[int(row), int(col)] = float(val)
    bd[k - 1, 0] = np.inf
    kw = dict(block_r=8, block_k=block_k, nblocks=bcc.nblocks)
    before = cluster_spmm_compact.launches
    got = cluster_spmm_compact(bids, tids, vals, bd, **kw)
    torch.cuda.synchronize()
    assert cluster_spmm_compact.launches == before + 1
    want = cluster_spmm_compact_plain(bids, tids, vals, bd, **kw)
    assert _same_values(got, want)
    assert got.isnan().any() and got.isinf().any()
    # some block is reached only through a dead column of its slabs
    dense = torch.from_numpy(a.to_dense()).to(card)
    nb = bcc.nblocks
    live = (dense.view(nb, 8, k) != 0).any(dim=1).float()
    via_live = (live @ (~bd.isfinite()).float()) > 0
    bad = (~got.isfinite()).view(nb, 8, n_cols).any(dim=1)
    assert (bad & ~via_live).any()
    # finite outputs are the exact product's
    fin = got.isfinite()
    exact = dense @ torch.nan_to_num(bd, nan=0.0, posinf=0.0, neginf=0.0)
    assert torch.equal(got[fin], exact[fin])


FLASH_D = [16, 64, 72, 80, 96, 128]
FLASH_SQ = [1, 63, 64, 65, 1000, 1024]


def _flash_check(card, bh, sq, sk, d, causal, *, offset=0):
    g = torch.Generator(device=card).manual_seed(bh * sq + 7 * sk + d)
    q, k, v = (torch.randn((bh * s * d + offset,), generator=g,
                           device=card)[offset:].view(bh, s, d)
               for s in (sq, sk, sk))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.isfinite().all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq", FLASH_SQ)
@pytest.mark.parametrize("d", FLASH_D)
def test_flash_attention_kernel_over_widths_and_lengths(card, d, sq, causal):
    """Every head-width template (D padded to 16: 72 runs the 80-wide
    instantiation with four zero columns) at query lengths around the
    64-row tile and the zamba2-2.7b prefill's 1024."""
    _flash_check(card, 2, sq, sq, d, causal)


@pytest.mark.parametrize("sq,sk", [(300, 130), (1000, 64), (65, 1),
                                   (130, 300), (1, 200), (64, 1024)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [72, 80])
def test_flash_attention_kernel_unequal_lengths(card, d, sq, sk, causal):
    """Sq > Sk and Sq < Sk: the top-left causal mask and the ragged last
    KV block."""
    _flash_check(card, 3, sq, sk, d, causal)


@pytest.mark.parametrize("d", [18, 80])
def test_flash_attention_kernel_unaligned_rows(card, d):
    """Rows that are not 16-byte aligned (a storage offset of one float,
    or D % 4 != 0) take the 4-byte copies."""
    _flash_check(card, 2, 200, 150, d, True, offset=1)


def _padded_operands(case, block_k):
    """A·B for the padded grid: ``dead_block`` gives row block 1 steps
    only in k-tile 1, whose B rows are all zero (no live tile), and
    leaves row block 3 empty (its stream step is a zero slab); ``all_live``
    makes every tile of C live."""
    rng = np.random.default_rng(block_k)
    if case == "dead_block":
        k = 3 * block_k
        a = ((rng.random((40, k)) < 0.05)
             * rng.integers(1, 4, (40, k))).astype(np.float32)
        a[8:16] = 0.0
        a[8:16, block_k + 1] = 2.0
        a[24:32] = 0.0
        b = ((rng.random((k, 300)) < 0.1)
             * rng.integers(1, 4, (k, 300))).astype(np.float32)
        b[block_k: 2 * block_k] = 0.0
    else:
        a = rng.integers(1, 4, (24, 2 * block_k)).astype(np.float32)
        b = rng.integers(1, 4, (2 * block_k, 200)).astype(np.float32)
    return HostCSR.from_dense(a), HostCSR.from_dense(b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_k", [16, 128, 512])
@pytest.mark.parametrize("case", ["dead_block", "all_live"])
def test_padded_kernel_fill_and_live_tiles(card, case, block_k, dtype):
    """K6's zero-fill and its live-tile launch: exact against the plain
    version (bf16 bit for bit), a block with no live tile stays zero, and
    every tile live leaves nothing to the fill."""
    a, b = _padded_operands(case, block_k)
    bcc = bcc_from_host(a, block_k=block_k, device=card)
    tiled = tiled_csr_from_host(b, block_k=block_k, dtype=dtype,
                                device=card)
    pack = ops.pack_spgemm(bcc, tiled, compact=False)
    g = pack.launch
    assert pack.route == "padded"
    before = cluster_spgemm_padded.launches
    got = cluster_spgemm_padded(g, pack.stream[2], tiled.tiles)
    torch.cuda.synchronize()
    assert cluster_spgemm_padded.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, cluster_spgemm_padded_plain(g, pack.stream[2],
                                                        tiled.tiles))
    live = g.live_tiles.cpu().numpy()
    if case == "dead_block":
        # block 3's one (zero) slab reads k-tile 0 and lists its tiles
        assert not (live // g.nnb == 1).any()
        assert not got[8:16].any() and not got[24:32].any()
        assert 0 < live.size < g.nblocks * g.nnb
    else:
        assert live.tolist() == list(range(g.nblocks * g.nnb))
    if dtype == torch.float32:
        assert np.array_equal(got[:a.nrows, :b.ncols].cpu().numpy(),
                              a.to_dense() @ b.to_dense())


def test_padded_zero_fill_on_spans_off_the_16_byte_grid(card):
    """The fill behind K6 zeroes exactly the span it is given, whose start
    and size need not sit on its 16-byte stores (a padded grid's C always
    does: 8 rows of 2- or 4-byte values), and nothing around it."""
    import ctypes

    from repro_torch.kernels import _build
    fn = _build.load("cluster_spgemm_padded").cluster_spgemm_padded_zero
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.empty(70001, dtype=torch.bfloat16, device=card)
    stream = torch.cuda.current_stream(card).cuda_stream
    for start, n in [(3, 37), (0, 8), (1, 70000), (5, 0), (8, 7), (2, 1)]:
        buf.fill_(7.0)
        assert fn(buf[start:].data_ptr(), 2 * n, stream) == 0
        torch.cuda.synchronize()
        assert not buf[start:start + n].any()
        assert (buf[:start] == 7).all() and (buf[start + n:] == 7).all()


def _non_finite_b(b, seed, count=12):
    """``b`` with ``count`` of its values (seeded positions) made inf,
    -inf and NaN in turn."""
    data = b.data.copy()
    pos = np.random.default_rng(seed).choice(b.nnz, count, replace=False)
    data[pos] = [np.inf, -np.inf, np.nan] * (count // 3)
    return HostCSR(b.indptr, b.indices, data, b.shape)


NON_FINITE_ROUTES = {
    "dense_strips": (dict(sparse_c=False), cluster_spgemm_windows,
                     cluster_spgemm_windows_plain),
    "sparse_c": (dict(sparse_c=True), cluster_spgemm_windows,
                 cluster_spgemm_windows_plain),
    "padded_grid": (dict(compact=False), cluster_spgemm_padded,
                    lambda g, a, t, c: cluster_spgemm_padded_plain(g, a, t)),
    "revisit": (dict(revisit=True), cluster_spgemm_revisit,
                lambda g, a, t, c: cluster_spgemm_revisit_plain(g, a, t)),
    "sharded": (dict(shards=5), cluster_spgemm_sharded,
                cluster_spgemm_sharded_plain),
    "sharded_revisit": (dict(shards=5, revisit=True),
                        cluster_spgemm_sharded, cluster_spgemm_sharded_plain),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_k", [128, 512])
@pytest.mark.parametrize("route", list(NON_FINITE_ROUTES))
def test_spgemm_kernels_non_finite_b_equal_plain(card, route, block_k,
                                                 dtype):
    """K1 (dense strips), K5 (CompactedC slabs), K6 (padded grid), K7
    (revisit) and K8 (5 shards, both orders) on a B with inf, -inf and
    NaN values: each kernel gives its plain version's NaN positions, inf
    signs and finite values -- a dead slab column that meets a
    non-finite value makes its block NaN there, as the whole-slab
    product does -- and the same dense product as the dense strips."""
    a = _host(300, 700, 0.02, 51)
    b = _non_finite_b(_host(700, 300, 0.02, 52), 53)
    bcc = bcc_from_host(a, block_k=block_k, device=card)
    tiled = tiled_csr_from_host(b, block_k=block_k, dtype=dtype,
                                device=card)
    kw, fn, plain = NON_FINITE_ROUTES[route]
    pack = ops.pack_spgemm(bcc, tiled, **kw)
    args = (pack.launch, pack.stream[2], tiled.tiles, pack.cols)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert _same_values(got, plain(*args))
    dense = ops.bcc_spgemm_tiled(None, tiled, pack=pack).float()
    flat = ops.bcc_spgemm_tiled(
        None, tiled, pack=ops.pack_spgemm(bcc, tiled, sparse_c=False))
    assert torch.equal(dense.isnan(), flat.isnan())
    assert torch.equal(dense.isinf() & (dense > 0), flat.isinf() & (flat > 0))
    if route != "padded_grid" or dtype == torch.float32:
        # (the padded grid rounds its bf16 output after every step)
        assert _same_values(dense, flat)
    assert dense.isnan().any() and dense.isfinite().any()


def test_spgemm_census_leaves_finite_b_bit_identical(card):
    """On finite B the census raises no flag: every route equals the
    dense strips bit for bit, and the exact product."""
    a = _host(300, 700, 0.02, 54)
    b = _host(700, 300, 0.02, 55)
    bcc = bcc_from_host(a, device=card)
    tiled = tiled_csr_from_host(b, device=card)
    want = a.to_dense() @ b.to_dense()
    for kw, _, _ in NON_FINITE_ROUTES.values():
        pack = ops.pack_spgemm(bcc, tiled, **kw)
        got = ops.bcc_spgemm_tiled(None, tiled, pack=pack)
        assert np.array_equal(got.float().cpu().numpy(), want)


def _lattice(card, case, *, block_k=128, k=None, seed=0):
    """Padded-lattice operands for K9: per-block tile lists by ``case``,
    integer slabs with about half their columns dead, ``k`` rows of B."""
    rng = np.random.default_rng(seed)
    if case == "interleaved":          # 4 tile sets, block b names b % 4
        sets = [np.sort(rng.choice(12, 4, replace=False)) for _ in range(4)]
        ids = np.stack([sets[b % 4] for b in range(37)])
    elif case == "all_equal":          # 19 blocks: panels of 8, 8 and 3
        ids = np.tile(np.array([1, 4, 6, 9]), (19, 1))
    elif case == "all_different":      # panels of one
        ids = np.stack([np.sort(rng.choice(12, 4, replace=False))
                        for _ in range(21)])
    elif case == "pads":               # pad slots name tile 0, zero slabs
        ids = np.tile(np.array([2, 5, 7, 10, 11]), (26, 1))
        ids[::3, 3:] = 0
    else:
        raise ValueError(case)
    nblocks, tpb = ids.shape
    vals = rng.integers(-3, 4, (nblocks * tpb, 8, block_k)).astype(
        np.float32)
    vals *= rng.random((nblocks * tpb, 1, block_k)) < 0.5
    if case == "pads":
        vals.reshape(nblocks, tpb, 8, block_k)[::3, 3:] = 0.0
    k = 12 * block_k if k is None else k
    return (torch.from_numpy(ids.reshape(-1).astype(np.int32)).to(card),
            torch.from_numpy(vals).to(card), tpb, k)


@pytest.mark.parametrize("case,k,n_cols,bn", [
    ("interleaved", 12 * 128, 256, 128),
    ("all_equal", 12 * 128, 300, 128),        # ragged last strip
    ("all_different", 12 * 128 - 37, 64, 64),  # ragged K, bn < 128
    ("pads", 12 * 128, 77, 32),               # ragged N, narrow strips
    ("interleaved", 11 * 128 + 5, 5, 8),      # ragged K in a live tile
])
def test_panel_spmm_kernel_exact_on_integers(card, case, k, n_cols, bn):
    """K9's panel kernel against its plain version, exactly, on integer
    operands: panels of 1 to 8 blocks (a block count that is not a
    multiple of 8, blocks that all agree or all differ), pad slabs,
    ragged K and N, strips narrower than 128."""
    tile_ids, vals, tpb, _ = _lattice(card, case)
    rng = np.random.default_rng(n_cols)
    b = torch.from_numpy(rng.integers(-2, 3, (k, n_cols)).astype(
        np.float32)).to(card)
    kw = dict(block_r=8, block_k=128, tiles_per_block=tpb)
    before = cluster_spmm.launches
    got = cluster_spmm(tile_ids, vals, b, bn=bn, **kw)
    torch.cuda.synchronize()
    assert cluster_spmm.launches == before + 1
    assert torch.equal(got, cluster_spmm_plain(tile_ids, vals, b, **kw))
    panels = ops.spmm_panels(tile_ids, tiles_per_block=tpb)
    assert torch.equal(cluster_spmm(tile_ids, vals, b, bn=bn, panels=panels,
                                    **kw), got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", ["interleaved", "pads"])
def test_panel_spmm_kernel_rounds_16_bits_like_plain(card, case, dtype):
    """16-bit B: each slot's fp32 part rounded to B's dtype and added in
    it, slot by slot, as the plain version does; sums large enough to
    round (values 1..15)."""
    tile_ids, vals, tpb, k = _lattice(card, case, seed=5)
    rng = np.random.default_rng(6)
    vals = vals.abs() * 4
    b = torch.from_numpy(rng.integers(1, 16, (k, 96)).astype(
        np.float32)).to(card).to(dtype)
    kw = dict(block_r=8, block_k=128, tiles_per_block=tpb)
    got = cluster_spmm(tile_ids, vals, b, **kw)
    want = cluster_spmm_plain(tile_ids, vals, b, **kw)
    assert got.dtype == dtype and torch.equal(got, want)
    once = cluster_spmm(tile_ids, vals, b.float(), **kw).to(dtype)
    if dtype == torch.bfloat16:
        assert not torch.equal(got, once)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_panel_spmm_kernel_non_finite_b_in_tile_0_and_dead_columns(card,
                                                                   dtype):
    """Nothing is skipped: an inf in B's tile 0 reaches the pad slabs
    (zero values naming tile 0) as NaN, and a NaN under a dead column
    reaches its blocks, as in the whole-slab product."""
    tile_ids, vals, tpb, k = _lattice(card, "pads", seed=7)
    b = torch.from_numpy(np.random.default_rng(8).integers(
        -2, 3, (k, 64)).astype(np.float32)).to(card)
    b[3, 5] = float("inf")                      # tile 0
    vals.view(-1, tpb, 8, 128)[:, 1, :, 17] = 0.0   # dead in every slot-1
    b[5 * 128 + 17, 9] = float("nan")           # slab; slot 1 is tile 5
    b = b.to(dtype)
    kw = dict(block_r=8, block_k=128, tiles_per_block=tpb)
    got = cluster_spmm(tile_ids, vals, b, **kw)
    want = cluster_spmm_plain(tile_ids, vals, b, **kw)
    assert _same_values(got, want)
    assert got[:, 9].isnan().all()
    pad_rows = torch.arange(0, got.shape[0] // 8, 3, device=card)
    assert got.view(-1, 8, 64)[pad_rows, :, 5].isnan().all()


# ---------------------------------------------------------------------------
# the async front-end: block-diagonal batches on the window kernel
# ---------------------------------------------------------------------------


def _burst_server(device, mats, group, *, batching=True):
    """A front-end (``workers=0``) over a planner on ``device`` with
    pallas plans seeded for each group's pack and each member."""
    cache = PlanCache()
    for g in range(0, len(mats), group):
        pack = block_diag_csr(mats[g:g + group])
        cache.put(Plan(fingerprint=fingerprint(pack.host),
                       reorder="original", scheme="pallas", reuse_hint=20,
                       workload="batch"))
    for m in mats:
        cache.put(Plan(fingerprint=fingerprint(m), reorder="original",
                       scheme="pallas", reuse_hint=20))
    planner = Planner(cache=cache, device=device,
                      resilience=ResiliencePolicy())
    return AsyncSpGEMMServer(SpGEMMServer(planner), workers=0, capacity=64,
                             batch_policy=BatchPolicy(enabled=batching))


def _serve_burst(fe, mats):
    tickets = [fe.submit(m, reuse_hint=20) for m in mats]
    fe.pump()
    return [t.result(0) for t in tickets]


def test_batched_burst_one_window_launch_per_batch(card):
    """16 distinct integer-valued members (32 to 64 rows) in two batches
    of eight: one window-kernel launch per batch, every ticket batched and
    equal to the dense product."""
    mats = [_host(32 + 8 * (i % 5), 32 + 8 * (i % 5), 0.1, 300 + i)
            for i in range(16)]
    fe = _burst_server(card, mats, 8)
    before = cluster_spgemm_windows.launches
    resps = _serve_burst(fe, mats)
    assert cluster_spgemm_windows.launches == before + 2
    for r, m in zip(resps, mats):
        assert r.batched and r.batch_size == 8 and not r.degraded
        assert r.scheme == "pallas"
        assert np.array_equal(r.result, m.to_dense() @ m.to_dense())
    assert fe.stats()["batching"]["launch_amortization"] == 8.0


def _named_members():
    hub = np.zeros((24, 24), np.float32)
    hub[0, :] = 3.0
    hub[:, 5] = 2.0
    hub[3, 3] = 1.0
    return {"ragged": [_host(n, n, 0.08, 40 + i)
                       for i, n in enumerate((16, 40, 8, 64))],
            "hub": [HostCSR.from_dense(hub), _host(24, 24, 0.08, 46),
                    _host(12, 12, 0.3, 47)],
            "wide_ragged": [_host(n, n, 0.05, 60 + i)
                            for i, n in enumerate((200, 56, 130, 8))]}


@pytest.mark.parametrize("sparse_c", [False, True])
@pytest.mark.parametrize("shape", ["ragged", "hub", "wide_ragged"])
def test_ragged_named_shapes_on_the_card_equal_the_plain_path(card, shape,
                                                              sparse_c):
    """Members whose rows are not multiples of 8 straddle 8-row blocks and
    128-column k-tiles in the pack: the window kernel on both output
    routes equals its plain version on the CPU, and the served batch
    equals the CPU front-end's, per ticket."""
    mats = _named_members()[shape]
    pack = block_diag_csr(mats).host
    want = pack.to_dense() @ pack.to_dense()
    outs = []
    for dev in (card, torch.device("cpu")):
        bcc = bcc_from_host(pack, device=dev)
        tiled = tiled_csr_from_host(pack, device=dev)
        p = ops.pack_spgemm(bcc, tiled, sparse_c=sparse_c)
        outs.append(ops.bcc_spgemm_tiled(None, tiled, pack=p).cpu())
    assert torch.equal(outs[0], outs[1])
    assert np.array_equal(outs[0].numpy(), want)
    served = [_serve_burst(_burst_server(dev, mats, len(mats)), mats)
              for dev in (card, "cpu")]
    for on_card, on_cpu, m in zip(*served, mats):
        assert on_card.batched and on_cpu.batched
        assert np.array_equal(on_card.result, on_cpu.result)
        assert np.array_equal(on_card.result, m.to_dense() @ m.to_dense())


def test_batched_float_values_within_fp32_reassociation(card):
    """Non-integer values: a member's sums in the pack may be formed in
    another order than alone (the launch's unit groups follow the whole
    pack), so batched and unbatched agree within 1e-5 of the largest
    value; each diagonal block is the member's product."""
    mats = [_host(64, 64, 0.1, 400 + i, integer=False) for i in range(8)]
    got = _serve_burst(_burst_server(card, mats, 8), mats)
    alone = _serve_burst(_burst_server(card, mats, 8, batching=False), mats)
    for b, u, m in zip(got, alone, mats):
        assert b.batched and not u.batched
        scale = float(np.abs(u.result).max())
        assert float(np.abs(b.result - u.result).max()) <= 1e-5 * scale
        exact = m.to_dense().astype(np.float64) @ m.to_dense()
        assert float(np.abs(b.result - exact).max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the measurement tier and the kernel tier's prior on the card
# ---------------------------------------------------------------------------


def test_time_fn_waits_for_the_card(card):
    """``benchlib.time_fn`` synchronizes: its best time is never shorter
    than the device time CUDA events give the same calls."""
    from repro_torch import benchlib
    a = torch.randn(4096, 4096, device=card)
    events = []

    def fn():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = a @ a
        end.record()
        events.append((start, end))
        return out

    best = benchlib.time_fn(fn, reps=5, warmup=1)
    torch.cuda.synchronize()
    device_ms = [s.elapsed_time(e) for s, e in events[1:]]
    assert len(device_ms) == 5
    assert best * 1e3 >= min(device_ms) > 0


@pytest.mark.parametrize("scheme", ["rowwise", "fixed"])
def test_value_only_repack_on_the_card_equals_the_cpus_full_pack(card,
                                                                 scheme):
    """A served sequence of fresh values on one pattern: the first request
    packs in full, the rest fill the cached layout on the card (one
    scatter), each operand bit for bit the CPU's full pack."""
    from repro_torch.core.formats import csr_cluster_from_host, csr_from_host
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.planner.cost_model import Candidate
    from repro_torch.planner.service import _materialize
    h = _host(300, 300, 0.03, 61)
    perm, bounds, mc, _ = _materialize(h, Candidate("degree", "fixed"))
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(h), reorder="degree",
                   scheme=scheme, reuse_hint=20, max_cluster=mc, perm=perm,
                   boundaries=None if scheme == "rowwise" else bounds,
                   workload="spmm"))
    srv = SpGEMMServer(Planner(cache=cache, device=card))
    b = np.random.default_rng(62).integers(-2, 3, (300, 16)).astype(
        np.float32)
    hits = obs_metrics.get_registry().counter("pack_layout_hits")
    before = hits.value
    for seed in range(3):
        hv = HostCSR(h.indptr, h.indices, np.random.default_rng(
            63 + seed).integers(1, 4, h.nnz).astype(np.float32), h.shape)
        assert np.array_equal(srv.submit(hv, b).result, hv.to_dense() @ b)
        (packed,) = [v for _, v in srv.planner.exec_cache.items()
                     if isinstance(v, GatherSpMM)][-1:]
        op = packed.op
        ap = hv.permute_rows(perm)
        want = (csr_from_host(ap, device="cpu") if scheme == "rowwise" else
                csr_cluster_from_host(ap, [int(x) for x in bounds],
                                      max_cluster=mc, device="cpu"))
        for f in (("indptr", "indices", "data") if scheme == "rowwise" else
                  ("cluster_ptr", "cols", "values", "row_base",
                   "cluster_size")):
            assert torch.equal(getattr(op, f).cpu(), getattr(want, f)), f
    assert hits.value - before == 2


@pytest.mark.parametrize("scheme", ["rowwise", "fixed", "variable",
                                    "hierarchical"])
def test_bench_fields_on_the_card_equal_the_cpus(card, scheme, monkeypatch,
                                                 tmp_path):
    from repro_torch import benchlib
    from repro_torch.core.suite import SUITE, generate
    monkeypatch.setattr(benchlib, "_CACHE", {})
    monkeypatch.setattr(benchlib, "CACHE_PATH", str(tmp_path / "c.json"))
    h = generate(next(s for s in SUITE if s.name == "kron_10_8_scr"))
    got = {}
    for dev in ("cpu", card):
        if scheme == "rowwise":
            r = benchlib.bench_rowwise_on(h, "rcm", name="k", reps=1,
                                          device=dev)
        else:
            r = benchlib.bench_clusterwise_on(h, "rcm", scheme, name="k",
                                              reps=1, device=dev)
        got[torch.device(dev).type] = r
    assert [(r.nnz, r.flops, r.mem_bytes, r.nclusters)
            for r in got.values()] == [
        (got["cpu"].nnz, got["cpu"].flops, got["cpu"].mem_bytes,
         got["cpu"].nclusters)] * 2
    assert sorted(k.rsplit("|", 1)[1] for k in benchlib._CACHE) == [
        "torch1-cpu", "torch1-cuda"]


def test_cold_kron_request_plans_what_the_prior_ranks_first(card):
    """An unseeded, unmeasured kron-14-pattern request: the plan is the
    prior's first amortizing candidate at the server's reuse, and the
    result equals scipy's product."""
    import scipy.sparse as sp

    from repro_torch.core.suite import gen_kron
    from repro_torch.planner.features import extract_features
    pattern = gen_kron(14, 16, seed=0)
    vals = np.random.default_rng(0).integers(1, 4, pattern.nnz)
    h = HostCSR(pattern.indptr, pattern.indices, vals.astype(np.float32),
                pattern.shape)
    server = SpGEMMServer(device=card)
    first = server.planner.cost_model.choose(extract_features(h),
                                             server.default_reuse_hint)
    resp = server.submit(h)
    assert f"{resp.reorder}+{resp.scheme}" == first.candidate.key
    assert not resp.degraded and not resp.plan_cache_hit
    s = sp.csr_matrix((h.data, h.indices, h.indptr), shape=h.shape)
    assert np.array_equal(resp.result, (s @ s).toarray().astype(np.float32))


@pytest.mark.parametrize("scale", [12, 14])
def test_cold_kron_a2_runs_on_the_kernel_tier(card, scale):
    """An unmeasured server (``measure=False``) on a Graph500-style kron
    graph: the card prices the kernel tier for a sparse B by its own
    gather cost, so A² plans ``original+pallas``, counts its products in
    ``kernel_tier_products`` (never ``gather_tier_products``), and each
    answer equals scipy's float64 square exactly."""
    import scipy.sparse as sp

    from repro_torch.core.suite import gen_kron
    from repro_torch.obs import metrics as obs_metrics
    pattern = gen_kron(scale, 16, seed=scale)
    vals = np.random.default_rng(scale).integers(1, 4, pattern.nnz)
    h = HostCSR(pattern.indptr, pattern.indices, vals.astype(np.float32),
                pattern.shape)
    s = sp.csr_matrix((h.data.astype(np.float64), h.indices, h.indptr),
                      shape=h.shape)
    want = (s @ s).toarray()
    reg = obs_metrics.get_registry()
    kernel, gather = (reg.counter("kernel_tier_products"),
                      reg.counter("gather_tier_products"))
    k0, g0 = kernel.value, gather.value
    server = SpGEMMServer(device=card, measure=False)
    for _ in range(2):
        resp = server.submit(h)
        assert (resp.reorder, resp.scheme) == ("original", "pallas")
        assert not resp.degraded
        assert np.array_equal(resp.result, want)
    assert (kernel.value - k0, gather.value - g0) == (2, 0)


def test_wide_sparse_a2_is_served_on_the_sparse_c_route(card):
    """A 9-point mesh of 262,144 rows, past the TPU's 65,536-column strip
    budget, served by ``submit(a, hops=1)``: the cold plan is
    ``original+pallas``, the hop runs K5 into CompactedC slabs (no padded
    grid), and the CSR answer equals scipy's float64 square bit for bit,
    twice. The same product stored in bfloat16 differs."""
    import scipy.sparse as sp

    from repro_torch.core.suite import gen_mesh2d
    from repro_torch.obs import metrics as obs_metrics
    pattern = gen_mesh2d(512, seed=0, stencil=9)
    assert not ops.compact_grid_ok_ncols(pattern.ncols)
    vals = np.random.default_rng(5).integers(1, 16, pattern.nnz)
    h = HostCSR(pattern.indptr, pattern.indices, vals.astype(np.float32),
                pattern.shape)
    s = sp.csr_matrix((h.data.astype(np.float64), h.indices, h.indptr),
                      shape=h.shape)
    want = (s @ s).tocsr()
    want.sort_indices()
    reg = obs_metrics.get_registry()
    sparse_c, padded = (reg.counter("kernel_launches", variant=v)
                        for v in ("sparse_c", "padded"))
    s0, p0 = sparse_c.value, padded.value
    server = SpGEMMServer(device=card, measure=False)
    for _ in range(2):
        resp = server.submit(h, hops=1)
        assert (resp.reorder, resp.scheme) == ("original", "pallas")
        assert not resp.degraded
        c = resp.result
        assert np.array_equal(c.indptr, want.indptr)
        assert np.array_equal(c.indices, want.indices)
        assert np.array_equal(c.data.astype(np.float64), want.data)
    assert (sparse_c.value - s0, padded.value - p0) == (2, 0)
    stored = torch.from_numpy(want.data).float().to(torch.bfloat16)
    assert not np.array_equal(stored.double().numpy(), want.data)


# ---------------------------------------------------------------------------
# served results copied into page-locked host memory
# ---------------------------------------------------------------------------


def _copies():
    from repro_torch.obs import metrics as obs_metrics
    snap = obs_metrics.get_registry().snapshot()
    return (snap.get("host_copies{memory=pinned}", 0),
            snap.get("host_copies{memory=pageable}", 0))


def _a2_server(card, h, *, policy=None):
    """A server with an ``original+pallas`` A² plan seeded for ``h``'s
    pattern: every request runs K1 on the dense route."""
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(h), reorder="original",
                   scheme="pallas", reuse_hint=20))
    return SpGEMMServer(Planner(cache=cache, device=card,
                                resilience=policy or ResiliencePolicy()))


def _revalued(h, seed):
    """``h``'s pattern with fresh integer values."""
    return HostCSR(h.indptr, h.indices, np.random.default_rng(seed).integers(
        1, 4, h.nnz).astype(np.float32), h.shape)


def test_served_a2_answer_lies_in_page_locked_memory(card):
    """The answer is the numpy view of a pinned block from PyTorch's
    caching host allocator: one ``host_copies{memory="pinned"}`` a
    request, none pageable, the ``copy`` span marked ``pinned``, and
    ``Planner.stats`` counts the block among the pinned bytes held."""
    from repro_torch.obs.trace import get_tracer
    h = _host(512, 512, 0.02, 71)
    srv = _a2_server(card, h)
    want = h.to_dense() @ h.to_dense()
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        for _ in range(2):
            before = _copies()
            resp = srv.submit(h)
            assert resp.scheme == "pallas" and not resp.degraded
            assert np.array_equal(resp.result, want)
            assert torch.from_numpy(resp.result).is_pinned()
            assert tuple(x - y for x, y in zip(_copies(), before)) == (1, 0)
        spans = [sp for sp in tracer.spans() if sp.name == "copy"]
    finally:
        tracer.disable()
        tracer.clear()
    assert [sp.attrs for sp in spans] == [
        {"bytes": want.nbytes, "pinned": True}] * 2
    assert srv.planner.stats["pinned_host_bytes"] >= want.nbytes


def test_kept_answers_survive_later_requests_of_the_pattern(card):
    """Three answers kept while seven more requests of the same pattern
    (fresh values each) are served: no live block is handed out again, so
    each kept answer still equals its own product."""
    h = _host(512, 512, 0.02, 72)
    srv = _a2_server(card, h)
    kept = []
    for seed in range(10):
        hv = _revalued(h, 80 + seed)
        resp = srv.submit(hv)
        assert np.array_equal(resp.result, hv.to_dense() @ hv.to_dense())
        if seed < 3:
            kept.append((hv, resp.result))
    assert len({ans.ctypes.data for _, ans in kept}) == 3
    for hv, ans in kept:
        assert torch.from_numpy(ans).is_pinned()
        assert np.array_equal(ans, hv.to_dense() @ hv.to_dense())


def test_batched_members_stay_correct_after_the_next_burst(card):
    """A burst's members are views of one pinned batch answer: a second
    burst of the same patterns with fresh values leaves them intact, and
    each batched launch copies once."""
    mats = [_host(32 + 8 * (i % 5), 32 + 8 * (i % 5), 0.1, 500 + i)
            for i in range(8)]
    fe = _burst_server(card, mats, 8)
    before = _copies()
    first = _serve_burst(fe, mats)
    assert tuple(x - y for x, y in zip(_copies(), before)) == (1, 0)
    again = [_revalued(m, 600 + i) for i, m in enumerate(mats)]
    second = _serve_burst(fe, again)
    for resps, ms in ((first, mats), (second, again)):
        for r, m in zip(resps, ms):
            assert r.batched and r.batch_size == 8 and not r.degraded
            assert np.array_equal(r.result, m.to_dense() @ m.to_dense())


def test_wide_bf16_answer_is_the_padded_grids_output_widened(card,
                                                             monkeypatch):
    """A served wide A·B under ``pallas_b_dtype=bfloat16`` on the padded
    grid (K6): the bf16 output widens on the card before one pinned copy,
    and the answer equals that output widened on the host (the copy's
    former path), value for value."""
    from repro_torch.planner import service
    monkeypatch.setattr(ops, "_COMPACT_C_STRIP_BUDGET", 4096)
    rng = np.random.default_rng(23)
    a = HostCSR.from_dense(((rng.random((48, 96)) < 0.5)
                            * rng.integers(1, 16, (48, 96))).astype(
                                np.float32))
    b = HostCSR.from_dense(((rng.random((96, 200)) < 0.5)
                            * rng.integers(1, 16, (96, 200))).astype(
                                np.float32))
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(a), reorder="original",
                   scheme="pallas", reuse_hint=20))
    srv = SpGEMMServer(Planner(cache=cache, device=card,
                               pallas_b_dtype=torch.bfloat16))
    outs = []
    to_host = service._to_host

    def capturing(out, span):
        outs.append(out.clone())
        return to_host(out, span)
    monkeypatch.setattr(service, "_to_host", capturing)
    launches = cluster_spgemm_padded.launches
    resp = srv.submit(a, b)
    assert resp.scheme == "pallas" and not resp.degraded
    assert cluster_spgemm_padded.launches == launches + 1
    (out,) = outs
    assert out.is_cuda and out.dtype == torch.bfloat16
    assert resp.result.dtype == np.float32
    assert torch.from_numpy(resp.result).is_pinned()
    assert np.array_equal(resp.result, out.cpu().float().numpy())
    exact = a.to_dense() @ b.to_dense()
    assert np.abs(exact).max() > 256
    assert not np.array_equal(resp.result, exact)


def test_output_guard_raises_on_a_pinned_answer_and_the_ladder_recovers(
        card):
    """The ``output`` fault site pokes a NaN into the pinned answer's
    copy: the guard raises ``NonFiniteOutputError``, and served, the
    ladder's next rung answers exactly."""
    from repro_torch.resilience.errors import NonFiniteOutputError
    h = _host(256, 256, 0.03, 73)
    srv = _a2_server(card, h)
    want = h.to_dense() @ h.to_dense()
    plan = srv.planner.cache.get(fingerprint(h), 20)
    assert plan is not None and plan.scheme == "pallas"
    with faults.injected(faults.FaultPlan(0, sites=["output"])):
        with pytest.raises(NonFiniteOutputError):
            srv.planner._guarded_execute(plan, h, None)
    with faults.injected(faults.FaultPlan(0, sites=["output"])):
        resp = srv.submit(h)
    assert resp.degraded and resp.fallback_scheme == "fixed"
    assert np.array_equal(resp.result, want)
    assert torch.from_numpy(resp.result).is_pinned()


# ---------------------------------------------------------------------------
# the training path (no kernel: the model's own chunked attention and SSD
# scan, as the reference trains)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m",
                                  "mamba2-370m", "zamba2-2.7b",
                                  "musicgen-large", "qwen2-vl-72b"])
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    """One step (2 microbatches) from the same weights and data on the
    card and on the CPU: loss within 1e-5 relative, grad norm and first
    moments within 1e-4 of the largest, parameters within 1e-6 but for
    at most 1e-3 of the elements (gradients near Adam's eps), those
    within 2 lr."""
    import copy

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = smoke_config(arch)
    ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, TrainConfig(microbatches=2, optimizer=ocfg))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                      seed=1, frontend=cfg.frontend, d_model=cfg.d_model,
                      m_rope=cfg.m_rope)
    start = init_params(cfg, 0, device="cpu")
    out = []
    for dev in (card, torch.device("cpu")):
        params = copy.deepcopy(start).to(dev)
        opt = init_opt_state(params, ocfg, device=dev)
        params, opt, m = step(params, opt, make_batch(dcfg, 0, device=dev))
        out.append((m, {k: p.detach().cpu()
                        for k, p in params.named_parameters()},
                    {k: v.cpu() for k, v in opt.mu.items()}))
    (md, pd, mud), (mc, pc, muc) = out
    assert float(md["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-5)
    assert float(md["grad_norm"]) == pytest.approx(float(mc["grad_norm"]),
                                                   rel=1e-4)
    off = total = 0
    for k in pc:
        err = (pd[k] - pc[k]).abs()
        off += int((err > 1e-6).sum())
        total += err.numel()
        assert float(err.max()) <= 2 * float(mc["lr"]), k
        assert float((mud[k] - muc[k]).abs().max()) <= 1e-4 * float(
            muc[k].abs().max()), k
    assert off <= 1e-3 * total, (off, total)


def test_run_training_on_the_card_launches_no_lm_kernel(card):
    from repro_torch.launch.train import run_training
    flash_attention.launches = 0
    ssd_chunk_scan.launches = 0
    out = run_training("zamba2-2.7b", steps=12, batch=4, seq=64, lr=1e-3,
                       log_every=1000)
    assert (flash_attention.launches, ssd_chunk_scan.launches) == (0, 0)
    assert all(np.isfinite(out["losses"]))
    assert out["final_loss"] < out["first_loss"]
    assert out["peak_device_bytes"] > 0
    assert out["params"]["final_norm"].device.type == "cuda"


def test_kernels_refused_under_autograd_on_the_card(card):
    from repro_torch.models.transformer import loss_fn
    cfg = smoke_config("zamba2-2.7b")
    params = init_params(cfg, 0, device=card).requires_grad_(True)
    toks = torch.zeros((2, 64), dtype=torch.long, device=card)
    with pytest.raises(NotImplementedError, match="no backward"):
        loss_fn(cfg, params, {"tokens": toks, "labels": toks},
                use_pallas=True)


def test_pipeline_apply_in_a_world_of_one_nccl_rank(card, tmp_path):
    import datetime

    import torch.distributed as dist
    from repro_torch.distributed.pipeline import pipeline_apply
    g = torch.Generator(device=card).manual_seed(0)
    w = torch.randn((1, 16, 16), generator=g, device=card)
    x = torch.randn((6, 2, 16), generator=g, device=card)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        got = pipeline_apply(lambda p, a: a + torch.tanh(a @ p["w"]),
                             {"w": w}, x)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, x + torch.tanh(x @ w[0]))


def test_flop_counter_on_the_card_equals_trace_cost(card):
    """FlopCounterMode around a smoke zamba2 train step on the card counts
    what trace_cost counts of the same step on fake tensors."""
    import copy
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.flop_cost import trace_cost
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = smoke_config("zamba2-2.7b")
    ocfg = AdamWConfig()
    step = make_train_step(cfg, TrainConfig(microbatches=2,
                                            skip_nonfinite=False,
                                            optimizer=ocfg))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    cpu = init_params(cfg, 0, device="cpu")
    want = trace_cost(step, copy.deepcopy(cpu),
                      init_opt_state(cpu, ocfg, device="cpu"),
                      make_batch(dcfg, 0, device="cpu"))["flops"]
    params = copy.deepcopy(cpu).to(card)
    with FlopCounterMode(display=False) as fc:
        step(params, init_opt_state(params, ocfg, device=card),
             make_batch(dcfg, 0, device=card))
    assert fc.get_total_flops() == want


def test_dtensor_train_step_on_a_one_rank_nccl_mesh(card, tmp_path):
    """The sharding rules' DTensor train step on a 1 × 1 × 1 mesh over
    NCCL equals the plain step on the card: loss within 1e-5 relative,
    parameters within 1e-5 but for at most 1e-3 of the elements (a
    gradient near Adam's ε), those within 2 lr — the bounds of
    ``tests/test_torch_distributed.py``."""
    import copy
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        rules = shd.Rules(mesh=mesh, data_axes=("pod", "data"))
        cfg = smoke_config("qwen3-14b")
        ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=5)
        step = make_train_step(cfg, TrainConfig(microbatches=2,
                                                optimizer=ocfg))
        batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=4), 0, device=card)
        start = init_params(cfg, 0, device=card)
        ref = copy.deepcopy(start)
        ref, _, m_ref = step(ref, init_opt_state(ref, ocfg, device=card),
                             batch)
        params = copy.deepcopy(start)
        opt = shd.shard_opt_state(init_opt_state(params, ocfg, device=card),
                                  mesh, shd.param_specs(cfg, rules,
                                                        fsdp=True))
        shd.shard_params(params, mesh, shd.param_specs(cfg, rules))
        sp = shd.batch_specs(cfg, rules, "train")
        with shd.use_rules(rules), implicit_replication():
            params, _, m = step(params, opt, {
                k: shd.shard_tensor(v, mesh, sp[k]) for k, v in
                batch.items()})
        assert float(m["loss"].full_tensor()) == pytest.approx(
            float(m_ref["loss"]), rel=1e-5)
        want = dict(ref.named_parameters())
        errs = torch.cat([(p.detach().full_tensor()
                           - want[name].detach()).abs().flatten()
                          for name, p in params.named_parameters()])
        assert int((errs > 1e-5).sum()) <= 1e-3 * errs.numel()
        assert float(errs.max()) <= 2 * float(m["lr"])
    finally:
        dist.destroy_process_group()
