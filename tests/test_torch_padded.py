"""The padded per-tile grid (K6) of the port against the JAX package's.

``cluster_spgemm_padded``'s plain version runs on the JAX package's own
packed operands (its compact A stream, B's table and tile store) and must
reproduce both Pallas padded kernels in interpret mode,
``cluster_spgemm_tiled`` (streamed B) and ``cluster_spgemm_resident``
(pinned B): exactly on integer-valued fp32 operands. With bf16 B tiles
the output is bf16 in both packages and both round after every step
(``o = bf16(o + bf16(dot))``): bit for bit on integer operands whose
partial sums pass bf16's 8-bit significand, within one bf16 ulp per
element on float operands, and within the documented 2e-2 relative bound
of the exact product. The wide route end to end — B past the live-pair grid's strip
budget — is held by lowering both packages' ``_COMPACT_C_STRIP_BUDGET``
inside the test (monkeypatch; no file changes): the served product, its
scheme and its ``padded`` launch label must match. The kernel itself runs
only on a card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import formats as RF
from repro.kernels import cluster_spgemm as RK
from repro.kernels import ops as rops
from repro.obs import metrics as ref_metrics
from repro.planner.features import fingerprint as ref_fingerprint
from repro.planner.plan_cache import Plan as RefPlan
from repro.planner.plan_cache import PlanCache as RefPlanCache
from repro.planner.service import Planner as RefPlanner
from repro.resilience import reset_policy
from repro.serve.engine import SpGEMMServer as RefServer
from repro_torch import convert
from repro_torch.core import formats as PF
from repro_torch.kernels import ops as pops
from repro_torch.kernels.cluster_spgemm import (cluster_spgemm_padded,
                                                cluster_spgemm_padded_plain,
                                                padded_grid)
from repro_torch.obs import metrics as port_metrics
from repro_torch.planner.executor import KernelSpGEMM
from repro_torch.planner.features import fingerprint
from repro_torch.planner.plan_cache import Plan, PlanCache
from repro_torch.planner.service import Planner
from repro_torch.resilience import reset_policy as reset_port_policy
from repro_torch.serve.engine import SpGEMMServer

from torch_port_helpers import (empty_rows_and_blocks, float_dense,
                                host_pair, integer_dense, ref_fields)

pytestmark = pytest.mark.pallas

# (a dense, b dense, block_k) — bn is 16 throughout; integer-valued
CASES = {
    "ragged": (integer_dense(40, 48, 0.10, 0), integer_dense(48, 40, 0.1, 1),
               16),
    "max_ragged": (integer_dense(17, 33, 0.15, 3),
                   integer_dense(33, 17, 0.15, 4), 16),
    "empty_blocks": (empty_rows_and_blocks(), integer_dense(32, 24, 0.4, 7),
                     16),
    "block_k_32": (integer_dense(48, 64, 0.08, 5),
                   integer_dense(64, 40, 0.08, 6), 32),
}


@pytest.fixture(autouse=True)
def _fresh_policies():
    reset_policy()
    reset_port_policy()
    yield
    reset_policy()
    reset_port_policy()


def _packed(a, b, bk, b_dtype=jnp.float32):
    """The JAX package's padded-grid operands, and the port's grid and
    tensors made from the same arrays."""
    ra = RF.bcc_from_host(RF.HostCSR.from_dense(a), block_k=bk)
    rt = RF.tiled_csr_from_host(RF.HostCSR.from_dense(b), block_k=bk, bn=16,
                                dtype=b_dtype)
    stream = rops.bcc_compact_stream(ra, cover_all_blocks=True)
    ref = dict(block_ids=stream[0], tile_ids=stream[1], table=rt.table,
               a_values=stream[2], b_tiles=rt.tiles)
    grid = padded_grid(stream[0], stream[1], np.asarray(rt.table),
                       nblocks=ra.nblocks, nnb=rt.nnb, block_r=8, bn=16,
                       device="cpu")
    tiles = convert.packed_from_numpy("TiledCSR", ref_fields(rt),
                                      device="cpu").tiles
    kw = dict(block_r=8, block_k=bk, bn=16, nblocks=ra.nblocks, nnb=rt.nnb)
    return ref, kw, grid, convert.tensor_from_numpy(stream[2],
                                                    device="cpu"), tiles


@pytest.mark.parametrize("name", list(CASES))
def test_padded_plain_matches_both_pallas_padded_kernels(name):
    a, b, bk = CASES[name]
    ref, kw, grid, a_values, tiles = _packed(a, b, bk)
    got = cluster_spgemm_padded(grid, a_values, tiles)
    assert got.dtype == torch.float32
    assert torch.equal(got, cluster_spgemm_padded_plain(grid, a_values,
                                                        tiles))
    for kernel in (RK.cluster_spgemm_tiled, RK.cluster_spgemm_resident):
        want = np.asarray(kernel(*ref.values(), interpret=True, **kw))
        assert got.shape == want.shape
        assert np.array_equal(got.numpy(), want), kernel.__name__
    assert np.array_equal(got.numpy()[: a.shape[0], : b.shape[1]], a @ b)


@pytest.mark.parametrize("name", ["ragged", "empty_blocks"])
def test_padded_bf16_output_within_the_documented_bound(name):
    a, _, bk = CASES[name]
    b = float_dense(a.shape[1], 40, 0.2, 11)
    ref, kw, grid, a_values, tiles = _packed(a, b, bk, b_dtype=jnp.bfloat16)
    got = cluster_spgemm_padded(grid, a_values, tiles)
    assert got.dtype == torch.bfloat16           # B's dtype, as in JAX
    for kernel in (RK.cluster_spgemm_tiled, RK.cluster_spgemm_resident):
        want = np.asarray(kernel(*ref.values(), interpret=True, **kw))
        assert want.dtype.name == "bfloat16"
        want = want.astype(np.float32)
        scale = max(np.abs(want).max(), 1e-9)
        assert np.abs(got.float().numpy() - want).max() / scale < 2e-2
    exact = a @ b
    scale = max(np.abs(exact).max(), 1e-9)
    assert np.abs(got.float().numpy()[: a.shape[0], : b.shape[1]]
                  - exact).max() / scale < 2e-2


# integer values up to 15: per-step products and their running sums pass
# 256, so rounding each step to bf16 and rounding the fp32 sum once differ
WIDE_INTEGERS = {
    "ragged": (integer_dense(40, 48, 0.10, 0) * 5,
               np.random.default_rng(31).integers(1, 16, (48, 40)).astype(
                   np.float32), 16),
    "block_k_32": (np.random.default_rng(32).integers(1, 16, (24, 96)).astype(
        np.float32), np.random.default_rng(33).integers(1, 16, (96, 40))
        .astype(np.float32), 32),
}


@pytest.mark.parametrize("name", list(WIDE_INTEGERS))
def test_padded_bf16_rounds_after_every_step_like_the_reference(name):
    a, b, bk = WIDE_INTEGERS[name]
    ref, kw, grid, a_values, tiles = _packed(a, b, bk, b_dtype=jnp.bfloat16)
    got = cluster_spgemm_padded(grid, a_values, tiles)
    assert got.dtype == torch.bfloat16
    for kernel in (RK.cluster_spgemm_tiled, RK.cluster_spgemm_resident):
        want = np.asarray(kernel(*ref.values(), interpret=True, **kw))
        assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    # the data tells the two roundings apart
    once = torch.from_numpy(a @ b).to(torch.bfloat16).float().numpy()
    assert not np.array_equal(got.float().numpy()[: a.shape[0],
                                                  : b.shape[1]], once)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8-bit significand)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("name", ["ragged", "empty_blocks"])
def test_padded_bf16_float_within_one_ulp_of_the_reference(name):
    a, _, bk = CASES[name]
    b = float_dense(a.shape[1], 40, 0.2, 11)
    ref, kw, grid, a_values, tiles = _packed(a, b, bk, b_dtype=jnp.bfloat16)
    got = cluster_spgemm_padded(grid, a_values, tiles).float().numpy()
    for kernel in (RK.cluster_spgemm_tiled, RK.cluster_spgemm_resident):
        want = np.asarray(kernel(*ref.values(), interpret=True, **kw)
                          ).astype(np.float32)
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_padded_grid_block_offsets_cover_every_block():
    a, b, bk = CASES["empty_blocks"]
    ref, kw, grid, _, _ = _packed(a, b, bk)
    counts = np.bincount(np.asarray(ref["block_ids"]),
                         minlength=kw["nblocks"])
    assert np.array_equal(np.diff(grid.block_ptr.numpy()), counts)
    assert (counts > 0).all()
    assert grid.out_shape == (kw["nblocks"] * 8, kw["nnb"] * 16)


@pytest.mark.parametrize("name", list(CASES))
def test_padded_grid_lists_the_live_tiles_of_the_reference_table(name):
    """The live output tiles the kernel computes (every other tile is the
    zero-fill's) are the (blk, j) with a step s of block blk whose slot
    ``table[tile_ids[s] * nnb + j]`` is live, in the JAX package's stream
    and table; the reference's output is zero on every other tile."""
    a, b, bk = CASES[name]
    ref, kw, grid, _, _ = _packed(a, b, bk)
    nblocks, nnb = kw["nblocks"], kw["nnb"]
    table = np.asarray(ref["table"]).reshape(-1, nnb)
    want = set()
    for blk, tile in zip(np.asarray(ref["block_ids"]),
                         np.asarray(ref["tile_ids"])):
        want.update(int(blk) * nnb + int(j)
                    for j in np.flatnonzero(table[tile] > 0))
    got = grid.live_tiles.numpy()
    assert grid.live_tiles.dtype == torch.int32
    assert got.tolist() == sorted(want)
    out = np.asarray(RK.cluster_spgemm_tiled(*ref.values(), interpret=True,
                                             **kw))
    tiles = out.reshape(nblocks, 8, nnb, 16).transpose(0, 2, 1, 3).reshape(
        nblocks * nnb, -1)
    assert not tiles[np.setdiff1d(np.arange(nblocks * nnb), got)].any()


@pytest.mark.parametrize("resident", [None, True, False])
def test_ops_padded_route_matches_the_reference(resident):
    (ra, pa), (rb, pb) = (host_pair(m) for m in CASES["ragged"][:2])
    r_bcc, r_t = RF.bcc_from_host(ra, block_k=16), \
        RF.tiled_csr_from_host(rb, block_k=16, bn=16)
    p_bcc, p_t = PF.bcc_from_host(pa, block_k=16, device="cpu"), \
        PF.tiled_csr_from_host(pb, block_k=16, bn=16, device="cpu")
    want = np.asarray(rops.bcc_spgemm_tiled(r_bcc, r_t, interpret=True,
                                            compact=False,
                                            resident=resident))
    pack = pops.pack_spgemm(p_bcc, p_t, compact=False)
    assert pack.route == "padded" and pack.pairs is None
    # the JAX package's resident / streamed split is a VMEM placement;
    # the port runs one kernel for both
    got = pops.bcc_spgemm_tiled(None, p_t, pack=pack)
    assert np.array_equal(got.numpy(), want)


def _wide_servers(monkeypatch, h_ref, h_port):
    """Both packages' servers with a seeded pallas plan for the A·B
    request and a strip budget small enough that the 200-column B is
    'wide' (nnb = 2 at bn = 128: an 8 KiB strip over a 4 KiB budget)."""
    import repro_torch.kernels.ops as port_ops
    monkeypatch.setattr(rops, "_COMPACT_C_STRIP_BUDGET", 4096)
    monkeypatch.setattr(port_ops, "_COMPACT_C_STRIP_BUDGET", 4096)
    rc, pc = RefPlanCache(), PlanCache()
    rc.put(RefPlan(fingerprint=ref_fingerprint(h_ref), reorder="original",
                   scheme="pallas", reuse_hint=20))
    pc.put(Plan(fingerprint=fingerprint(h_port), reorder="original",
                scheme="pallas", reuse_hint=20))
    return (RefServer(planner=RefPlanner(cache=rc)),
            SpGEMMServer(Planner(cache=pc, device="cpu")))


def test_wide_request_served_on_the_padded_grid_like_the_reference(
        monkeypatch):
    ra, pa = host_pair(integer_dense(48, 96, 0.06, 21))
    rb, pb = host_pair(integer_dense(96, 200, 0.05, 22))
    ref, port = _wide_servers(monkeypatch, ra, pa)
    assert not pops.compact_grid_ok_ncols(200)
    assert not rops.compact_grid_ok_ncols(200)

    def padded(reg):
        return reg.get_registry().counter("kernel_launches",
                                          variant="padded").value

    before = (padded(ref_metrics), padded(port_metrics))
    for _ in range(2):                           # pack, then exec-cache hit
        r_ref, r_port = ref.submit(ra, rb), port.submit(pa, pb)
        assert r_port.scheme == r_ref.scheme == "pallas"
        assert r_port.plan_cache_hit and r_ref.plan_cache_hit
        assert not r_port.degraded and not r_ref.degraded
        assert np.array_equal(r_port.result, np.asarray(r_ref.result))
        assert np.array_equal(r_port.result, pa.to_dense() @ pb.to_dense())
    assert (padded(ref_metrics), padded(port_metrics)) == (
        before[0] + 2, before[1] + 2)
    ((_, packed),) = port.planner.exec_cache.items()
    assert isinstance(packed, KernelSpGEMM)
    assert packed.pack.route == "padded"


def test_wide_bf16_request_is_served_widened_to_float32(monkeypatch):
    """A served wide A·B under ``pallas_b_dtype=bfloat16``: the padded
    grid's output is bf16 in both packages, and the reference returns it
    as an ``ml_dtypes`` bfloat16 array. The port returns float32 — numpy
    has no bfloat16, and the card's machine has no ``ml_dtypes`` — with
    values bit-equal to the reference's widened (the documented
    divergence); partial sums past bf16's 8-bit significand show that
    both rounded per step alike."""
    rng = np.random.default_rng(23)
    a = ((rng.random((48, 96)) < 0.5)
         * rng.integers(1, 16, (48, 96))).astype(np.float32)
    b = ((rng.random((96, 200)) < 0.5)
         * rng.integers(1, 16, (96, 200))).astype(np.float32)
    (ra, pa), (rb, pb) = host_pair(a), host_pair(b)
    monkeypatch.setattr(rops, "_COMPACT_C_STRIP_BUDGET", 4096)
    import repro_torch.kernels.ops as port_ops
    monkeypatch.setattr(port_ops, "_COMPACT_C_STRIP_BUDGET", 4096)
    rc, pc = RefPlanCache(), PlanCache()
    rc.put(RefPlan(fingerprint=ref_fingerprint(ra), reorder="original",
                   scheme="pallas", reuse_hint=20))
    pc.put(Plan(fingerprint=fingerprint(pa), reorder="original",
                scheme="pallas", reuse_hint=20))
    ref = RefServer(planner=RefPlanner(cache=rc,
                                       pallas_b_dtype=jnp.bfloat16))
    port = SpGEMMServer(Planner(cache=pc, device="cpu",
                                pallas_b_dtype=torch.bfloat16))
    r_ref, r_port = ref.submit(ra, rb), port.submit(pa, pb)
    assert r_port.scheme == r_ref.scheme == "pallas"
    assert not r_port.degraded and not r_ref.degraded
    want = np.asarray(r_ref.result)
    assert want.dtype.name == "bfloat16"
    assert r_port.result.dtype == np.float32
    assert np.array_equal(r_port.result, want.astype(np.float32))
    exact = a @ b
    assert np.abs(exact).max() > 256
    assert not np.array_equal(r_port.result, exact)
