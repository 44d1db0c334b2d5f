"""The port's SparseLinear and its padded-lattice SpMM (K9) against the
JAX package, on the CPU.

Seeded integer-valued weights and activations go through both packages:
``magnitude_prune``, ``SparseLinear.from_dense`` (stats and permutation
equal), ``apply`` on the padded lattice and on the compact stream, and
``ops.bcc_spmm`` against the JAX kernel ``cluster_spmm`` in interpret
mode, on the same packed operands. fp32 sums of small integers are exact
in any order, so every comparison is exact. ``apply`` on bf16, fp16 and
fp64 activations (the kernel paths round each step to a 16-bit dtype, as
the reference does) is held to the reference's dtype and values: equal
on integers, within the tolerances its test states otherwise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as ref_formats
from repro.kernels import ops as ref_ops
from repro.kernels.cluster_spmm import cluster_spmm as ref_cluster_spmm
from repro.models import sparse_linear as ref_sl
from repro_torch.convert import packed_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.cluster_spmm import cluster_spmm, cluster_spmm_plain
from repro_torch.models import sparse_linear as port_sl
from torch_port_helpers import integer_dense, ref_fields


def _structured_weight(rows, cols, seed, *, groups=4, tiles=2, per_tile=20):
    """Rows drawing their support from a few shared 128-wide column tiles
    (as ``examples/sparse_ffn.py`` builds them), shuffled; integer
    values ±1..3."""
    rng = np.random.default_rng(seed)
    ntiles = -(-cols // 128)
    sets = [rng.choice(ntiles, tiles, replace=False) for _ in range(groups)]
    w = np.zeros((rows, cols), np.float32)
    for i in range(rows):
        for t in sets[i % groups]:
            width = min(128, cols - t * 128)
            sel = t * 128 + rng.choice(width, min(per_tile, width),
                                       replace=False)
            w[i, sel] = rng.integers(1, 4, sel.size) * rng.choice(
                [-1, 1], sel.size)
    return w[rng.permutation(rows)]


def _acts(shape, seed):
    return np.random.default_rng(seed).integers(-2, 3, shape).astype(
        np.float32)


@pytest.mark.parametrize("density", [0.01, 0.1, 0.5])
def test_magnitude_prune_matches_reference(density):
    w = np.random.default_rng(0).standard_normal((64, 300)).astype(
        np.float32)
    assert np.array_equal(port_sl.magnitude_prune(w, density),
                          ref_sl.magnitude_prune(w, density))


@pytest.mark.parametrize("reorder", ["hierarchical", "original", "rcm"])
def test_from_dense_stats_and_perm_match_reference(reorder):
    w = _structured_weight(96, 700, 1)
    ref = ref_sl.SparseLinear.from_dense(w, density=0.05, reorder=reorder)
    port = port_sl.SparseLinear.from_dense(w, density=0.05, reorder=reorder,
                                           device="cpu")
    assert port.stats == ref.stats
    assert np.array_equal(port.perm, ref.perm)
    assert (port.out_features, port.in_features) == (96, 700)
    for f in dataclasses.fields(ref.bcc):
        want = np.asarray(getattr(ref.bcc, f.name))
        got = getattr(port.bcc, f.name)
        got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
        assert np.array_equal(got, want), f.name


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("reorder", ["hierarchical", "original"])
def test_apply_matches_reference_exactly(reorder, compact):
    w = _structured_weight(96, 700, 2)
    ref = ref_sl.SparseLinear.from_dense(w, density=0.05, reorder=reorder)
    port = port_sl.SparseLinear.from_dense(w, density=0.05, reorder=reorder,
                                           device="cpu")
    x = _acts((3, 5, 700), 3)
    want = np.asarray(ref.apply(jnp.asarray(x), compact=compact,
                                interpret=True))
    got = port.apply(torch.from_numpy(x), compact=compact).numpy()
    assert got.shape == (3, 5, 96)
    assert np.array_equal(got, want)
    dense = port.apply(torch.from_numpy(x), use_kernel=False).numpy()
    assert np.array_equal(dense, x @ port_sl.magnitude_prune(w, 0.05).T)


@pytest.mark.parametrize("n_cols", [5, 40, 200])
def test_bcc_spmm_matches_the_jax_padded_kernel(n_cols):
    """The padded lattice with pad slabs (ragged tile counts per block),
    ragged K (260 rows) and N below, inside and past one strip."""
    a = integer_dense(300, 260, 0.05, 4)
    ref_bcc = ref_formats.bcc_from_host(ref_formats.HostCSR.from_dense(a))
    assert int(np.asarray(ref_bcc.ntiles).min()) < ref_bcc.tiles_per_block
    bcc = packed_from_numpy("BCC", ref_fields(ref_bcc), device="cpu")
    b = _acts((260, n_cols), n_cols)
    want = np.asarray(ref_ops.bcc_spmm(ref_bcc, jnp.asarray(b),
                                       interpret=True))
    got = ops.bcc_spmm(bcc, torch.from_numpy(b)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, a @ b)


def test_pad_slabs_are_summed_like_the_tpu_kernel():
    """The padded lattice sums every slab, pads included: a nonzero pad
    slab (never built by bcc_from_host) shows up in both packages'
    results alike."""
    a = np.zeros((16, 384), np.float32)
    a[0, [1, 130, 260]] = [1.0, 2.0, 3.0]       # block 0: three tiles
    a[9, 300] = 2.0                             # block 1: one, two pads
    ref_bcc = ref_formats.bcc_from_host(ref_formats.HostCSR.from_dense(a))
    tpb = ref_bcc.tiles_per_block
    ntiles = np.asarray(ref_bcc.ntiles)
    blk = int(np.flatnonzero(ntiles < tpb)[0])
    values = np.array(ref_bcc.values)
    values[blk * tpb + tpb - 1] = 1.0           # a pad slab, tile id 0
    tile_ids = np.array(ref_bcc.tile_ids)
    assert tile_ids[blk * tpb + tpb - 1] == 0
    b = _acts((384, 16), 6)
    want = np.asarray(ref_cluster_spmm(
        jnp.asarray(tile_ids), jnp.asarray(values), jnp.asarray(b),
        block_r=8, block_k=128, tiles_per_block=tpb, bn=16,
        interpret=True))
    got = cluster_spmm(torch.from_numpy(tile_ids), torch.from_numpy(values),
                       torch.from_numpy(b), block_r=8, block_k=128,
                       tiles_per_block=tpb)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, a @ b)      # the pad slab counted
    assert torch.equal(got, cluster_spmm_plain(
        torch.from_numpy(tile_ids), torch.from_numpy(values),
        torch.from_numpy(b), block_r=8, block_k=128, tiles_per_block=tpb))


def test_cluster_spmm_refuses_mismatched_operands():
    with pytest.raises(ValueError, match="tiles_per_block"):
        cluster_spmm(torch.zeros(3, dtype=torch.int32),
                     torch.zeros((3, 8, 16)), torch.zeros((16, 4)),
                     block_r=8, block_k=16, tiles_per_block=2)
    with pytest.raises(ValueError, match="float32"):
        cluster_spmm(torch.zeros(2, dtype=torch.int32),
                     torch.zeros((2, 8, 16)),
                     torch.zeros((16, 4), dtype=torch.float64),
                     block_r=8, block_k=16, tiles_per_block=1)


def test_from_dense_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sl.SparseLinear.from_dense(_structured_weight(16, 256, 7))


# -- activations in other dtypes ------------------------------------------

# port dtype, JAX dtype, significand bits and least normal exponent of the
# output (fp64 activations run as fp32 in the JAX package, which has no
# 64-bit types)
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16),
          "float64": (torch.float64, jnp.float64)}
SIGNIFICANDS = {"bfloat16": (8, -126), "float16": (11, -14)}


def _ulp(x: np.ndarray, name: str) -> np.ndarray:
    """The spacing of ``name``'s values at |x|."""
    bits, emin = SIGNIFICANDS[name]
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** emin)))
    return 2.0 ** (e - (bits - 1))


_DTYPE_LAYER = {}


def _dtype_layer():
    """A 64 x 256 weight of integers in -3..3 at density 0.3
    (``default_rng(0)``), packed by both packages, and 5 tokens of
    integers in -2..2 and of standard normals."""
    if not _DTYPE_LAYER:
        rng = np.random.default_rng(0)
        w = (rng.integers(-3, 4, (64, 256))
             * (rng.random((64, 256)) < 0.3)).astype(np.float32)
        _DTYPE_LAYER.update(
            ref=ref_sl.SparseLinear.from_dense(w, density=0.3),
            port=port_sl.SparseLinear.from_dense(w, density=0.3,
                                                 device="cpu"),
            w=port_sl.magnitude_prune(w, 0.3),
            x_int=rng.integers(-2, 3, (5, 256)).astype(np.float32),
            x_real=rng.standard_normal((5, 256)).astype(np.float32))
    return _DTYPE_LAYER


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_takes_the_reference_dtypes(dtype, compact, use_kernel):
    """bf16 and fp16 activations come back in their own dtype on the
    kernel paths, each step's fp32 product rounded to it before it is
    added, as in the JAX package; the dense path returns fp32; fp64 runs
    as fp32. Equal on integer activations; on normal ones within one ulp
    of a 16-bit output (the fp32 sums inside a step may round the other
    way), within fp32's dot-product bound (256 · 2^-24 · Σ|w||x|) of an
    fp32 one."""
    lay = _dtype_layer()
    tdt, jdt = DTYPES[dtype]
    for x in (lay["x_int"], lay["x_real"]):
        want = np.asarray(lay["ref"].apply(
            jnp.asarray(x, dtype=jdt), use_kernel=use_kernel,
            compact=compact, interpret=True))
        got = lay["port"].apply(torch.from_numpy(x).to(tdt),
                                use_kernel=use_kernel, compact=compact)
        name = want.dtype.name
        assert str(got.dtype).split(".")[-1] == name
        assert got.shape == want.shape == (5, 64)
        got, want = got.float().numpy(), want.astype(np.float32)
        if x is lay["x_int"]:
            assert np.array_equal(got, want)
        elif name in SIGNIFICANDS:
            assert (np.abs(got - want) <= _ulp(want, name)).all()
        else:
            xr = np.asarray(jnp.asarray(x, dtype=jdt)).astype(np.float32)
            bound = 256 * 2.0 ** -24 * (np.abs(xr) @ np.abs(lay["w"]).T)
            assert (np.abs(got - want) <= bound).all()
    if use_kernel and dtype in SIGNIFICANDS:
        # rounded after every step, not once: the fp32 product rounded
        # to the dtype differs somewhere
        x = torch.from_numpy(lay["x_real"]).to(tdt)
        got = lay["port"].apply(x, compact=compact)
        once = lay["port"].apply(x.float(), compact=compact).to(tdt)
        assert not torch.equal(got, once)
