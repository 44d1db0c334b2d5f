"""The live-column form of A's slabs (``ops.slab_columns``) and the paths
that walk it, against the JAX package on the CPU.

Suite families (``gen_kron``, ``gen_caveman``, ``gen_powerlaw``) with
seeded integer values, a matrix with empty rows and empty blocks, and a
fully dense one are packed into BCC's compact stream (tail-pad slabs and
the zero slabs of empty blocks included) at ``block_k`` 128 and 512. The
form must scatter back to the padded slabs exactly, keep each slab's
columns ascending, and hold exactly the nonzero slab columns. The compact
SpMM (K4), the dense-strip A² (K1) and the CompactedC A² (K5) given the
form must equal the JAX package's kernels in interpret mode exactly (fp32
sums of small integers are exact in any order). ``SparseLinear`` with
inf and NaN activations equals the JAX package's result elementwise on
its compact, padded and dense paths: a non-finite value in a slab's dead
column still reaches the block, as in the whole-slab product.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as RF
from repro.core import suite as RS
from repro.kernels import ops as rops
from repro.models import sparse_linear as ref_sl
from repro_torch.core import formats as PF
from repro_torch.kernels import ops as pops
from repro_torch.kernels.columns import SlabColumns
from repro_torch.models import sparse_linear as port_sl

from torch_port_helpers import empty_rows_and_blocks

pytestmark = pytest.mark.pallas


def _dense_matrix():
    """Every column of every slab live: the form's worst case."""
    rng = np.random.default_rng(5)
    return RF.HostCSR.from_dense(rng.integers(1, 4, (20, 300)).astype(
        np.float32))


def _square_empty_blocks():
    """Rows 8..15 an empty 8-row block, square for A²."""
    dense = np.zeros((40, 40), np.float32)
    dense[:, :32] = empty_rows_and_blocks()
    dense[[2, 30, 33], [35, 39, 0]] = [1.0, 2.0, 3.0]
    return RF.HostCSR.from_dense(dense)


MATRICES = {
    "kron": lambda: RS.gen_kron(8, 8, seed=1),
    "caveman": lambda: RS.gen_caveman(256, 16, seed=2),
    "powerlaw": lambda: RS.gen_powerlaw(600, 6, seed=3),
    "empty_blocks": lambda: RF.HostCSR.from_dense(empty_rows_and_blocks()),
    "dense": _dense_matrix,
    "empty_blocks_square": _square_empty_blocks,
}


def _pair(name):
    """The matrix, values replaced by seeded integers, as a JAX-package
    and a port HostCSR."""
    h = MATRICES[name]()
    data = np.random.default_rng(len(name)).integers(1, 4, h.nnz).astype(
        np.float32)
    return (RF.HostCSR(h.indptr, h.indices, data, h.shape),
            PF.HostCSR(h.indptr, h.indices, data, h.shape))


def _to_slabs(cols: SlabColumns) -> torch.Tensor:
    """Scatter the live columns back into ``(S, 8, block_k)`` slabs."""
    out = torch.zeros((cols.nslabs, 8, cols.block_k))
    slab = torch.repeat_interleave(torch.arange(cols.nslabs),
                                   torch.diff(cols.col_ptr).long())
    out[slab, :, cols.col_k.long()] = cols.col_vals
    return out


def _stream(ph, block_k):
    bcc = PF.bcc_from_host(ph, block_k=block_k, device="cpu")
    return bcc, pops.bcc_compact_stream(bcc, cover_all_blocks=True)


@pytest.mark.parametrize("block_k", [128, 512])
@pytest.mark.parametrize("name", list(MATRICES))
def test_slab_columns_scatter_back_to_the_slabs(name, block_k):
    rh, ph = _pair(name)
    _, (_, _, vals) = _stream(ph, block_k)
    cols = pops.slab_columns(vals)
    assert isinstance(cols, SlabColumns)
    assert cols.col_ptr.dtype == cols.col_k.dtype == torch.int32
    assert cols.col_vals.shape == (cols.ncols, 8)
    assert torch.equal(_to_slabs(cols), vals)
    # the JAX package's slabs, counted with numpy: L is the number of
    # slab columns with a nonzero in any row
    ref_vals = np.asarray(rops.bcc_compact_stream(
        RF.bcc_from_host(rh, block_k=block_k), cover_all_blocks=True)[2])
    live = (ref_vals != 0).any(axis=1)
    assert cols.ncols == int(live.sum())
    assert np.array_equal(np.diff(cols.col_ptr.numpy()), live.sum(axis=1))


@pytest.mark.parametrize("block_k", [128, 512])
@pytest.mark.parametrize("name", list(MATRICES))
def test_slab_columns_ascend_within_each_slab(name, block_k):
    _, ph = _pair(name)
    _, (_, _, vals) = _stream(ph, block_k)
    cols = pops.slab_columns(vals)
    ptr, k = cols.col_ptr.numpy(), cols.col_k.numpy()
    for s in range(cols.nslabs):
        seg = k[ptr[s]: ptr[s + 1]]
        assert (np.diff(seg) > 0).all()
        assert seg.size == 0 or (0 <= seg[0] and seg[-1] < block_k)


def test_pad_and_empty_block_slabs_have_no_column_and_dense_have_all():
    _, ph = _pair("empty_blocks")
    bcc, (block_ids, _, vals) = _stream(ph, 16)
    cols = pops.slab_columns(vals)
    counts = np.diff(cols.col_ptr.numpy())
    zero = ~vals.numpy().any(axis=(1, 2))
    assert zero.any() and (counts[zero] == 0).all()
    # block 1 (rows 8..15) is empty: its one cover slab has no column
    assert (counts[np.asarray(block_ids) == 1] == 0).all()
    assert vals.shape[0] % 8 == 0                     # tail-padded
    _, ph = _pair("dense")
    _, (_, _, vals) = _stream(ph, 128)
    cols = pops.slab_columns(vals)
    full = vals.numpy().any(axis=1).all(axis=1)       # slabs with no pad
    assert full.any()
    assert (np.diff(cols.col_ptr.numpy())[full] == 128).all()


@pytest.mark.parametrize("block_k", [128, 512])
@pytest.mark.parametrize("name", list(MATRICES))
def test_spmm_over_live_columns_matches_pallas(name, block_k):
    rh, ph = _pair(name)
    bcc, stream = _stream(ph, block_k)
    cols = pops.slab_columns(stream[2])
    bd = np.random.default_rng(7).integers(-2, 3, (rh.ncols, 24)).astype(
        np.float32)
    want = np.asarray(rops.bcc_spmm_compact(
        RF.bcc_from_host(rh, block_k=block_k), jnp.asarray(bd),
        interpret=True))
    got = pops.bcc_spmm_compact(bcc, torch.from_numpy(bd), stream=stream,
                                cols=cols).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, rh.to_dense() @ bd)


@pytest.mark.parametrize("sparse_c", [False, True])
@pytest.mark.parametrize("name", ["kron", "caveman", "powerlaw",
                                  "empty_blocks_square"])
def test_a2_over_live_columns_matches_pallas(name, sparse_c):
    rh, ph = _pair(name)
    bk = 128
    rb = RF.bcc_from_host(rh, block_k=bk)
    rt = RF.tiled_csr_from_host(rh, block_k=bk)
    pb = PF.bcc_from_host(ph, block_k=bk, device="cpu")
    pt = PF.tiled_csr_from_host(ph, block_k=bk, device="cpu")
    pack = pops.pack_spgemm(pb, pt, sparse_c=sparse_c)
    assert pack.route == ("sparse_c" if sparse_c else "dense")
    assert torch.equal(_to_slabs(pack.cols), pack.stream[2])
    if sparse_c:
        want = rops.bcc_spgemm_sparse_c(rb, rt, interpret=True,
                                        epilogue="kernel")
        got = pops.bcc_spgemm_sparse_c(None, pt, pack=pack)
        assert np.array_equal(got.table.numpy(), np.asarray(want.table))
        assert np.array_equal(got.slabs.numpy(), np.asarray(want.slabs))
    else:
        want = np.asarray(rops.bcc_spgemm_tiled(rb, rt, interpret=True,
                                                sparse_c=False))
        got = pops.bcc_spgemm_tiled(None, pt, pack=pack).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got, rh.to_dense() @ rh.to_dense())


def _non_finite_layer(block_k):
    """A weight with live columns, dead slab columns and an empty block,
    and seeded integer activations holding an inf and a NaN: at feature 3
    (live in blocks 0 and 2; dead in block 1's slab, which covers the same
    k-tile) and at feature 40 (live in block 0 only)."""
    rng = np.random.default_rng(11)
    feats = 256 if block_k == 128 else 1100
    w = np.zeros((32, feats), np.float32)
    w[:8, [3, 40, 200]] = rng.integers(1, 4, (8, 3))       # block 0
    w[8:16, [5, 41, 130]] = rng.integers(1, 4, (8, 3))     # block 1
    w[16:20, [3, 77]] = rng.integers(1, 4, (4, 2))         # block 2
    w[24, 250] = 2.0                                       # block 3
    if block_k == 512:
        w[8:12, [600, 1090]] = rng.integers(1, 4, (4, 2))  # 3rd, ragged tile
    x = rng.integers(-2, 3, (6, feats)).astype(np.float32)
    x[1, 3] = np.inf
    x[4, 40] = np.nan
    x[2, 3] = -np.inf
    if block_k == 512:
        x[3, 1095] = np.inf                                # dead, ragged tile
    return w, x


@pytest.mark.parametrize("block_k,path", [
    (128, "compact"), (128, "padded"), (128, "dense"), (512, "compact")])
def test_sparse_linear_non_finite_activation_equals_the_reference(block_k,
                                                                  path):
    """The JAX package's kernels multiply whole (8, block_k) slabs, so an
    inf or NaN activation in a slab's dead column (all 8 weights zero)
    gives 0 * inf = NaN in the 8 outputs of the block. The port's compact
    path walks live columns only and must still find it: every path
    equals the reference elementwise — the same NaN positions, inf with
    the same sign, equal finite values."""
    w, x = _non_finite_layer(block_k)
    kw = dict(density=1.0, reorder="original", block_k=block_k)
    ref = ref_sl.SparseLinear.from_dense(w, **kw)
    port = port_sl.SparseLinear.from_dense(w, device="cpu", **kw)
    use_kernel, compact = path != "dense", path == "compact"
    want = np.asarray(ref.apply(jnp.asarray(x), use_kernel=use_kernel,
                                compact=compact, interpret=True))
    got = port.apply(torch.from_numpy(x), use_kernel=use_kernel,
                     compact=compact).numpy()
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isposinf(got), np.isposinf(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    ok = np.isfinite(want)
    assert np.array_equal(got[ok], want[ok])
    assert np.isinf(want).any() and np.isnan(want).any()
    # the data reaches outputs through dead columns: more of them are not
    # finite than the blocks with a live column at a non-finite feature
    nblk = w.shape[0] // 8
    live = np.stack([(w[b * 8: b * 8 + 8] != 0).any(axis=0)
                     for b in range(nblk)])
    live_rule = np.stack([live[:, ~np.isfinite(x[t])].any(axis=1)[
        np.arange(w.shape[0]) // 8] for t in range(x.shape[0])])
    assert (~np.isfinite(want)).sum() > live_rule.sum()
