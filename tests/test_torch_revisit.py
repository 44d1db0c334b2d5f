"""The sharded pair stream (K8) and the revisit order (K7) of the port
against the JAX package's.

* ``partition_pair_stream``, ``revisit_window_blocks`` and
  ``revisit_pair_stream`` are the JAX package's numpy code copied into
  the port: their outputs must be array-equal on the same streams.
* The plain versions of ``cluster_spgemm_revisit`` and
  ``cluster_spgemm_sharded`` reproduce the Pallas kernels they replace in
  interpret mode — ``cluster_spgemm_pairs_window`` on a revisit-ordered
  stream and ``cluster_spgemm_pairs_sharded`` on a partition, both
  bit-identical to ``cluster_spgemm_pairs`` — exactly, on integer-valued
  operands.
* ``bcc_spgemm_tiled(shards=…, revisit=…)`` equals the JAX package's on
  the ``tests/test_sharded_pairs.py`` cases (integer-valued here, so the
  comparison is exact) and labels its launches the same way.
* The kernels' launch metadata — segments split by block sub-range where
  a window is wider than the revisit kernel's accumulator, and the
  shard-major, column-strip-major launch order — covers every live
  ``(block, j)`` pair once and keeps each ``(block, j)``'s slot order;
  the plain versions walking it equal the Pallas kernels at ``nnb ≤ 2``
  (256-block windows), at ``block_k = 512`` and at 1, 3 and 8 shards.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import formats as RF
from repro.kernels import cluster_spgemm as RK
from repro.kernels import ops as rops
from repro.obs import metrics as ref_metrics
from repro_torch import convert
from repro_torch.core import formats as PF
from repro_torch.kernels import ops as pops
from repro_torch.kernels.cluster_spgemm import (cluster_spgemm_revisit,
                                                cluster_spgemm_sharded,
                                                cluster_spgemm_sharded_plain,
                                                segment_blocks,
                                                segments_from_shards,
                                                windows_from_shards)
from repro_torch.obs import metrics as port_metrics

from torch_port_helpers import host_pair, integer_dense, ref_fields

pytestmark = pytest.mark.pallas


def _pack(a, b, *, block_k=16, bn=16):
    """The JAX package's BCC/TiledCSR/stream/pairs of ``a @ b`` and the
    port's operands made from the same arrays."""
    ra, pa = host_pair(a)
    rb, pb = host_pair(b)
    bcc = RF.bcc_from_host(ra, block_k=block_k)
    tiled = RF.tiled_csr_from_host(rb, block_k=block_k, bn=bn)
    stream = rops.bcc_compact_stream(bcc, cover_all_blocks=True)
    pairs = rops.build_live_pairs(bcc, tiled, stream)
    port = (PF.bcc_from_host(pa, block_k=block_k, device="cpu"),
            PF.tiled_csr_from_host(pb, block_k=block_k, bn=bn,
                                   device="cpu"))
    return bcc, tiled, stream, pairs, port


def _same_streams(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


# (a dense, b dense) — test_sharded_pairs.py's shapes, integer-valued
CASES = {
    "wrapper": (integer_dense(56, 40, 0.15, 21),
                integer_dense(40, 56, 0.15, 22)),
    "sharded": (integer_dense(64, 48, 0.12, 11),
                integer_dense(48, 64, 0.12, 12)),
    "ragged": (integer_dense(40, 48, 0.10, 0),
               integer_dense(48, 40, 0.10, 31)),
    "max_ragged": (integer_dense(17, 33, 0.15, 3),
                   integer_dense(33, 17, 0.15, 34)),
    "pairless_blocks": (np.pad(integer_dense(8, 32, 0.3, 5), ((0, 40),
                                                             (0, 0))),
                        np.eye(32, dtype=np.float32) * 2),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shards", [1, 2, 3, 5, 8])
def test_partition_and_revisit_streams_equal_the_reference(name, shards):
    bcc, tiled, _, pairs, _ = _pack(*CASES[name])
    nblocks = bcc.nblocks
    r_ranges, r_sp = RF.partition_pair_stream(pairs, nblocks=nblocks,
                                              num_shards=shards)
    p_ranges, p_sp = PF.partition_pair_stream(pairs, nblocks=nblocks,
                                              num_shards=shards)
    assert np.array_equal(p_ranges, r_ranges) and p_ranges.dtype == np.int64
    for got, want in zip(p_sp, r_sp):
        _same_streams(got, want)
    loop = PF.partition_pair_stream_reference(pairs, nblocks=nblocks,
                                              num_shards=shards)
    assert np.array_equal(loop[0], p_ranges)
    assert PF.partition_balance(p_sp) == RF.partition_balance(r_sp)
    wb = PF.revisit_window_blocks(tiled.nnb, block_r=8, bn=16)
    assert wb == RF.revisit_window_blocks(tiled.nnb, block_r=8, bn=16)
    for (s, _), sub in zip(p_ranges, p_sp):
        for w in (1, 2, wb):
            _same_streams(
                PF.revisit_pair_stream(sub, window_blocks=w,
                                       block_base=int(s)),
                RF.revisit_pair_stream(sub, window_blocks=w,
                                       block_base=int(s)))


def test_revisit_window_blocks_keeps_the_reference_budget():
    for nnb in (1, 2, 3, 16, 128, 648, 10 ** 6):
        for bn in (16, 128):
            assert PF.revisit_window_blocks(nnb, bn=bn) \
                == RF.revisit_window_blocks(nnb, bn=bn)
    assert PF.revisit_window_blocks(128) == 4     # kron-14 / caveman-16384
    assert PF.revisit_window_blocks(2) == 256


def _port_tensors(stream, tiled):
    return (convert.tensor_from_numpy(stream[2], device="cpu"),
            convert.packed_from_numpy("TiledCSR", ref_fields(tiled),
                                      device="cpu").tiles)


@pytest.mark.parametrize("name", ["ragged", "max_ragged", "sharded",
                                  "pairless_blocks"])
def test_revisit_plain_matches_pallas_window_kernel(name):
    bcc, tiled, stream, pairs, _ = _pack(*CASES[name])
    nblocks, nnb = bcc.nblocks, tiled.nnb
    wb = min(RF.revisit_window_blocks(nnb, block_r=8, bn=16), nblocks)
    rv = RF.revisit_pair_stream(pairs, window_blocks=wb)
    wins = (np.asarray(rv[0]).astype(np.int64) // wb).astype(np.int32)
    kw = dict(block_r=8, block_k=16, bn=16, nblocks=nblocks, nnb=nnb)
    want = np.asarray(RK.cluster_spgemm_pairs_window(
        wins, *rv, stream[2], tiled.tiles, window_blocks=wb,
        interpret=True, **kw))
    base = np.asarray(RK.cluster_spgemm_pairs(*pairs, stream[2],
                                              tiled.tiles, interpret=True,
                                              **kw))
    a_values, tiles = _port_tensors(stream, tiled)
    seg = segments_from_shards([[0, nblocks]], [rv], window_blocks=wb,
                               nblocks=nblocks, nnb=nnb, block_r=8, bn=16,
                               device="cpu")
    got = cluster_spgemm_revisit(seg, a_values, tiles).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, base)


@pytest.mark.parametrize("revisit", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_sharded_plain_matches_pallas_sharded_dispatch(shards, revisit):
    bcc, tiled, stream, pairs, _ = _pack(*CASES["sharded"])
    nblocks, nnb = bcc.nblocks, tiled.nnb
    ranges, sp = RF.partition_pair_stream(pairs, nblocks=nblocks,
                                          num_shards=shards)
    wb = None
    if revisit:
        wb = RF.revisit_window_blocks(nnb, block_r=8, bn=16)
        sp = [RF.revisit_pair_stream(p, window_blocks=wb, block_base=int(s))
              for p, (s, _) in zip(sp, ranges)]
    want = np.asarray(RK.cluster_spgemm_pairs_sharded(
        sp, ranges, stream[2], tiled.tiles, block_r=8, block_k=16, bn=16,
        nblocks=nblocks, nnb=nnb, window_blocks=wb, interpret=True))
    a_values, tiles = _port_tensors(stream, tiled)
    geo = dict(nblocks=nblocks, nnb=nnb, block_r=8, bn=16, device="cpu")
    work = (windows_from_shards(ranges, sp, **geo) if wb is None
            else segments_from_shards(ranges, sp, window_blocks=wb, **geo))
    assert work.shard_ptr.shape[0] == len(sp) + 1
    got = cluster_spgemm_sharded(work, a_values, tiles)
    assert torch.equal(got, cluster_spgemm_sharded_plain(work, a_values,
                                                         tiles))
    assert np.array_equal(got.numpy(), want)


def test_shard_ptr_splits_windows_at_the_shard_ranges():
    bcc, tiled, _, pairs, _ = _pack(*CASES["sharded"])
    ranges, sp = PF.partition_pair_stream(pairs, nblocks=bcc.nblocks,
                                          num_shards=3)
    w = windows_from_shards(ranges, sp, nblocks=bcc.nblocks, nnb=tiled.nnb,
                            block_r=8, bn=16, device="cpu")
    ptr = w.shard_ptr.numpy()
    win_blk = w.win_out.numpy() // (8 * w.ldc)
    for i, (s, e) in enumerate(ranges):
        blk = win_blk[ptr[i]:ptr[i + 1]]
        assert ((blk >= s) & (blk < e)).all()
    assert ptr[-1] == w.nwin


KNOBS = ({"shards": 2}, {"shards": 3, "revisit": True},
         {"shards": 1, "revisit": True}, {"shards": 2, "resident": True},
         {"shards": 8}, {"shards": 8, "revisit": True})


@pytest.mark.parametrize("name", ["wrapper", "pairless_blocks"])
def test_ops_wrapper_sharded_and_revisit_equal_the_reference(name):
    a, b = CASES[name]
    bcc, tiled, _, _, (p_bcc, p_tiled) = _pack(a, b)

    def count(reg, variant):
        return reg.get_registry().counter("kernel_launches",
                                          variant=variant).value

    for kw in KNOBS:
        variant = "sharded_revisit" if kw.get("revisit") else "sharded"
        before = (count(ref_metrics, variant), count(port_metrics, variant))
        want = np.asarray(rops.bcc_spgemm_tiled(bcc, tiled, interpret=True,
                                                **kw))
        # resident is a VMEM placement of the JAX package only
        got = pops.bcc_spgemm_tiled(
            p_bcc, p_tiled, **{k: v for k, v in kw.items()
                               if k != "resident"}).numpy()
        assert np.array_equal(got, want), kw
        assert np.array_equal(got, a @ b), kw
        assert (count(ref_metrics, variant) - before[0],
                count(port_metrics, variant) - before[1]) == (1, 1), kw


def test_build_shard_pack_equals_the_reference():
    bcc, tiled, _, pairs, (p_bcc, p_tiled) = _pack(*CASES["wrapper"])
    assert pops.pallas_shard_count() == 1
    assert pops.build_shard_pack(p_bcc, p_tiled, pairs) is None
    assert rops.build_shard_pack(bcc, tiled, pairs, shards=1) is None
    for kw in ({"shards": 3}, {"shards": 2, "revisit": True},
               {"shards": 1, "revisit": True}):
        r_ranges, r_sp, r_wb = rops.build_shard_pack(bcc, tiled, pairs, **kw)
        p_ranges, p_sp, p_wb = pops.build_shard_pack(p_bcc, p_tiled, pairs,
                                                     **kw)
        assert np.array_equal(p_ranges, r_ranges) and p_wb == r_wb
        for got, want in zip(p_sp, r_sp):
            _same_streams(got, want)


def test_card_cost_model_shard_term_is_inert_at_one_shard(monkeypatch):
    """The port's counterpart of the JAX package's per-core pallas term:
    the card's traffic prior divides by the shard count for products the
    serving path would shard (A² and chain hops on the live-pair grid) —
    and with one shard, the default, nothing changes. A² and chain hops
    are priced against the card's gather cost (at the features' floor
    fill, so that neither clamp binds), SpMM against the JAX package's
    (at the pattern's own fill)."""
    from repro_torch.planner import cost_model as pcm
    from repro_torch.planner.features import extract_features
    h = PF.HostCSR.from_dense(integer_dense(64, 64, 0.08, 3))
    feats = extract_features(h)
    model = pcm.CostModel(device="cuda")
    cand = pcm.Candidate("original", "pallas")

    def rel(workload, ncols=None):
        f = feats if workload == "spmm" else dataclasses.replace(
            feats, tile128_fill=1e-4)
        if ncols is not None:
            f = dataclasses.replace(f, ncols=ncols)
        return model.score(f, cand, 20, workload=workload).kernel_rel

    assert pcm._pallas_core_count() == 1
    one = rel("a2")
    assert rel("chain") == one == (
        (pcm.PALLAS_B_BYTES_PER_SLOT / 1e-4
         + pcm.PALLAS_A_BYTES_PER_SLOT / (1e-4 * pcm.PALLAS_SLAB_FILL_BOOST))
        / pcm.PALLAS_CARD_SPGEMM_GATHER_BYTES + pcm.PALLAS_DEAD_STEP_REL)
    spmm = rel("spmm")
    fill = feats.tile128_fill
    assert spmm == ((pcm.PALLAS_B_BYTES_PER_SLOT / fill
                     + pcm.PALLAS_A_BYTES_PER_SLOT
                     / min(fill * pcm.PALLAS_SLAB_FILL_BOOST, 1.0))
                    / pcm.PALLAS_GATHER_BYTES + pcm.PALLAS_DEAD_STEP_REL)
    for r in (one, spmm):
        assert 0.15 < r < pcm.PALLAS_INTERPRET_REL    # neither clamp binds
    monkeypatch.setattr(pcm, "_pallas_core_count", lambda: 4)
    assert rel("a2") == rel("chain") == one / 4
    assert rel("spmm") == spmm                         # not sharded
    assert rel("a2", ncols=10 ** 6) == one             # padded
    cpu = pcm.CostModel(device="cpu")
    assert cpu.score(feats, cand, 20, workload="a2").kernel_rel \
        == pcm.PALLAS_INTERPRET_REL


# B of 200 columns: nnb = 2 at bn = 128, so revisit windows of 256 blocks,
# split into segments of 4 (the kernel's 16 KiB accumulator)
WIDE = (integer_dense(300, 300, 0.02, 41), integer_dense(300, 200, 0.03, 42))


def _launch_pairs(work, nblocks):
    """Each launched pair as (block, j, slot, a_idx), in launch order
    (CTA ``x`` runs item ``order[x]``), with the C block range of its CTA
    and the shard whose range of CTAs holds ``x``."""
    ldc, block_r = work.ldc, work.block_r
    ptr = work.shard_ptr.numpy()
    shard = np.repeat(np.arange(ptr.size - 1), np.diff(ptr))
    items = work.order.numpy()
    if hasattr(work, "seg_ptr"):
        iptr, out, nblk = (work.seg_ptr.numpy(), work.seg_out.numpy(),
                           work.seg_nblk.numpy())
        rows = work.rows.numpy()
    else:
        iptr, out = work.win_ptr.numpy(), work.win_out.numpy()
        nblk = np.ones(out.size, np.int64)
        rows = np.zeros(work.npairs, np.int64)
    blk0 = out // (block_r * ldc)
    js = out % (block_r * ldc) // work.bn
    got = []
    for x, it in enumerate(items):
        lo, hi = iptr[it], iptr[it + 1]
        assert hi > lo
        r = rows[lo:hi]
        assert ((r >= 0) & (r < nblk[it])).all()
        assert blk0[it] + nblk[it] <= nblocks
        for p in range(lo, hi):
            got.append((shard[x], int(js[it]), int(blk0[it] + rows[p]),
                        int(work.slots[p]), int(work.a_idx[p])))
    return got, shard, items, blk0, js


@pytest.mark.parametrize("revisit", [False, True])
@pytest.mark.parametrize("shards", [1, 3, 5, 8])
@pytest.mark.parametrize("name", ["sharded", "ragged", "pairless_blocks",
                                  "wide"])
def test_launch_metadata_covers_each_live_pair_once_in_slot_order(
        name, shards, revisit):
    """The CASES at bn = 16 in 4-block windows, and WIDE at bn = 128 in
    256-block windows cut into 4-block segments."""
    bn = 128 if name == "wide" else 16
    bcc, tiled, _, pairs, _ = _pack(*(WIDE if name == "wide"
                                      else CASES[name]), bn=bn)
    nblocks, nnb = bcc.nblocks, tiled.nnb
    ranges, sp = PF.partition_pair_stream(pairs, nblocks=nblocks,
                                          num_shards=shards)
    geo = dict(nblocks=nblocks, nnb=nnb, block_r=8, bn=bn, device="cpu")
    if revisit:
        wb = (PF.revisit_window_blocks(nnb, block_r=8, bn=bn)
              if name == "wide" else 4)
        sp = [PF.revisit_pair_stream(p, window_blocks=wb, block_base=int(s))
              for p, (s, _) in zip(sp, ranges)]
        work = segments_from_shards(ranges, sp, window_blocks=wb, **geo)
        assert work.max_nblk <= min(segment_blocks(8, bn), wb)
        if name == "wide":
            assert wb == 256 and work.max_nblk == 4
    else:
        work = windows_from_shards(ranges, sp, **geo)
    got, shard, items, blk0, js = _launch_pairs(work, nblocks)
    ptr = work.shard_ptr.numpy()
    # each shard's CTAs run a permutation of its items, column strip by
    # column strip, inside the shard's block range
    for s, (start, end) in enumerate(ranges):
        its = items[ptr[s]:ptr[s + 1]]
        assert sorted(its.tolist()) == list(range(ptr[s], ptr[s + 1]))
        keys = list(zip(js[its], blk0[its]))
        assert keys == sorted(keys)
        assert ((blk0[its] >= start) & (blk0[its] < end)).all()
    # every live pair once; per (block, j) the stream's s (= slot) order
    blocks, jj, slots, a_idx = (np.asarray(p) for p in pairs)
    live = slots > 0
    want = sorted(zip(blocks[live].tolist(), jj[live].tolist(),
                      slots[live].tolist(), a_idx[live].tolist()))
    assert sorted((b, j, sl, a) for _, j, b, sl, a in got) == want
    per_tile = {}
    for _, j, b, sl, a in got:
        per_tile.setdefault((b, j), []).append(sl)
    for seq in per_tile.values():
        assert seq == sorted(seq)
    assert len(per_tile) == len({(b, j) for b, j, _, _ in want})
    if revisit:
        assert work.ntiles == len(per_tile)


@pytest.mark.parametrize("block_k", [128, 512])
@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("revisit", [False, True])
def test_plain_on_split_launches_matches_the_pallas_kernels(block_k, shards,
                                                            revisit):
    """At nnb = 2 (256-block revisit windows, split into segments of 4
    blocks) and at block_k = 512, the plain versions walking the kernels'
    launch metadata equal ``cluster_spgemm_pairs_sharded`` (and with one
    shard and the revisit order, ``cluster_spgemm_pairs_window``) in
    interpret mode, and the unsharded pair kernel."""
    bcc, tiled, stream, pairs, _ = _pack(*WIDE, block_k=block_k, bn=128)
    nblocks, nnb = bcc.nblocks, tiled.nnb
    assert nnb == 2
    kw = dict(block_r=8, block_k=block_k, bn=128, nblocks=nblocks, nnb=nnb)
    ranges, sp = RF.partition_pair_stream(pairs, nblocks=nblocks,
                                          num_shards=shards)
    wb = None
    if revisit:
        wb = RF.revisit_window_blocks(nnb, block_r=8, bn=128)
        assert wb == 256
        sp = [RF.revisit_pair_stream(p, window_blocks=wb, block_base=int(s))
              for p, (s, _) in zip(sp, ranges)]
    want = np.asarray(RK.cluster_spgemm_pairs_sharded(
        sp, ranges, stream[2], tiled.tiles, window_blocks=wb,
        interpret=True, **kw))
    base = np.asarray(RK.cluster_spgemm_pairs(*pairs, stream[2], tiled.tiles,
                                              interpret=True, **kw))
    a_values, tiles = _port_tensors(stream, tiled)
    geo = dict(nblocks=nblocks, nnb=nnb, block_r=8, bn=128, device="cpu")
    if revisit:
        work = segments_from_shards(ranges, sp, window_blocks=wb, **geo)
        assert segment_blocks(8, 128) == 4
        # each shard's one window is cut into segments of 4 blocks
        widths = ranges[:, 1] - ranges[:, 0]
        assert work.max_nblk == min(4, int(widths.max()))
        if shards == 1:
            assert nblocks == 38 and work.nseg == 10 * nnb   # 9 x 4 + 2
            rv = sp[0]
            wins = (np.asarray(rv[0]).astype(np.int64) // wb).astype(
                np.int32)
            window = np.asarray(RK.cluster_spgemm_pairs_window(
                wins, *rv, stream[2], tiled.tiles, window_blocks=wb,
                interpret=True, **kw))
            assert np.array_equal(
                cluster_spgemm_revisit(work, a_values, tiles).numpy(),
                window)
    else:
        work = windows_from_shards(ranges, sp, **geo)
    got = cluster_spgemm_sharded(work, a_values, tiles).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, base)
    assert np.array_equal(got[:300, :200], WIDE[0] @ WIDE[1])


@pytest.mark.parametrize("kw", [{"revisit": True}, {"shards": 3},
                                {"shards": 3, "revisit": True}])
def test_pack_spgemm_builds_slab_columns_on_the_shard_routes(kw):
    _, _, _, _, (p_bcc, p_tiled) = _pack(*CASES["wrapper"])
    pack = pops.pack_spgemm(p_bcc, p_tiled, **kw)
    assert pack.route == ("sharded_revisit" if kw.get("revisit")
                          else "sharded")
    want = pops.slab_columns(pack.stream[2])
    for f in ("col_ptr", "col_k", "col_vals"):
        assert torch.equal(getattr(pack.cols, f), getattr(want, f)), f
    assert pack.cols.block_k == want.block_k
