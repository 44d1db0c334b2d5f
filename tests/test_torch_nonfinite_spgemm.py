"""The port's Sp×Sp routes on a B with inf and NaN values, against the JAX
package on the CPU.

The JAX package's kernels multiply whole ``(8, block_k)`` slabs, so a dead
column ``k`` of a slab (all 8 values zero) still meets row ``k`` of the B
tile it is paired with, and ``0 * inf`` is NaN: the slab's output rows are
NaN in that column. The port's live-column paths skip dead columns and
find those NaNs by counting (``csrc/nonfinite.cuh``; the plain versions
in ``kernels/cluster_spgemm.py``). Here ``ops.bcc_spgemm_tiled`` on the
CPU (the plain versions) must give the JAX package's
``bcc_spgemm_tiled(interpret=True)`` exactly — the same NaN positions,
the same inf signs, the same finite values — on every route (dense strips,
CompactedC slabs, 2 shards, the revisit order, the padded grid, 2 shards
in the revisit order), with fp32 and bf16 B tiles.

The inputs: a 16 × 32 A whose block 0 has one nonzero, in column 1 of
k-tile 0, times a 32 × 16 B with inf at row 3 (a dead column of that slab;
``block_k = bn = 16``); the same with -inf and NaN, each at a dead and at
a live column; and the ``plaw_1024_10`` family squared, integer-valued,
with seeded non-finite values in B. The kernels themselves run only on a
card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as RF
from repro.kernels import ops as rops
from repro_torch.core import formats as PF
from repro_torch.kernels import ops as pops

from torch_port_helpers import family_pair, host_pair

pytestmark = pytest.mark.pallas

ROUTES = {
    "dense_strips": dict(sparse_c=False),
    "sparse_c": dict(sparse_c=True),
    "shards_2": dict(shards=2),
    "revisit": dict(revisit=True),
    "padded_grid": dict(compact=False),
    "shards_2_revisit": dict(shards=2, revisit=True),
}

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _small(value, row):
    """The 16 × 32 A and 32 × 16 B: A's block 0 holds one nonzero, at
    column 1 (row 3 of B meets a dead column of its slab, row 1 a live
    one); block 1 has a column of its own in the second k-tile."""
    a = np.zeros((16, 32), np.float32)
    a[0, 1] = 2.0
    a[8, 20] = 1.0
    a[11, 17] = -3.0
    b = np.zeros((32, 16), np.float32)
    b[1, 2] = 3.0
    b[3, 5] = 2.0
    b[20, 5] = 1.0
    b[17, 9] = 4.0
    b[row, 2] = value
    return a, b


SMALL = {
    "inf_dead": lambda: _small(np.inf, 3),
    "neg_inf_dead": lambda: _small(-np.inf, 3),
    "nan_dead": lambda: _small(np.nan, 3),
    "inf_live": lambda: _small(np.inf, 1),
    "neg_inf_live": lambda: _small(-np.inf, 1),
    "nan_live": lambda: _small(np.nan, 1),
}


def _operands(ra, pa, rb, pb, *, block_k, bn, dtype):
    tdt, jdt = DTYPES[dtype]
    return ((RF.bcc_from_host(ra, block_k=block_k),
             RF.tiled_csr_from_host(rb, block_k=block_k, bn=bn, dtype=jdt)),
            (PF.bcc_from_host(pa, block_k=block_k, device="cpu"),
             PF.tiled_csr_from_host(pb, block_k=block_k, bn=bn, dtype=tdt,
                                    device="cpu")))


def _same(got: torch.Tensor, want) -> None:
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isposinf(got), np.isposinf(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.array_equal(got, want, equal_nan=True)


def _check(ref, port, route):
    want = rops.bcc_spgemm_tiled(*ref, interpret=True, **ROUTES[route])
    got = pops.bcc_spgemm_tiled(*port, **ROUTES[route])
    _same(got, want)
    return got


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", list(SMALL))
def test_small_non_finite_b_equals_the_reference(case, route, dtype):
    a, b = SMALL[case]()
    (ra, pa), (rb, pb) = host_pair(a), host_pair(b)
    ref, port = _operands(ra, pa, rb, pb, block_k=16, bn=16, dtype=dtype)
    got = _check(ref, port, route).float().numpy()
    # the value reaches column 2 of block 0's 8 rows through the slab:
    # a dead column makes all 8 NaN; a live one makes row 0 inf (2 * v)
    # and the 7 zero rows NaN (0 * v)
    col = got[:8, 2]
    if case.startswith("nan") or case.endswith("dead"):
        assert np.isnan(col).all()
    else:
        assert np.isinf(col[0]) and np.isnan(col[1:]).all()
        assert (col[0] > 0) == (case == "inf_live")
    assert np.isfinite(got[8:]).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_the_motivating_case_gives_eight_nans(route, dtype):
    """A dead column meets B's inf: rows 0–7 of column 2 are NaN, and
    nothing else is."""
    a, b = _small(np.inf, 3)
    (ra, pa), (rb, pb) = host_pair(a), host_pair(b)
    ref, port = _operands(ra, pa, rb, pb, block_k=16, bn=16, dtype=dtype)
    got = _check(ref, port, route).float().numpy()
    assert np.isnan(got).sum() == 8 and np.isnan(got[:8, 2]).all()


def _plaw_with_non_finite_b(seed):
    """plaw_1024_10, integer-valued, as A and as B, with 6 of B's values
    (seeded positions) set to inf, -inf and NaN."""
    (ra, pa) = family_pair("plaw_1024_10")
    data = ra.data.copy()
    rng = np.random.default_rng(seed)
    pos = rng.choice(data.size, 6, replace=False)
    data[pos] = [np.inf, -np.inf, np.nan, np.inf, -np.inf, np.nan]
    rb = RF.HostCSR(ra.indptr, ra.indices, data, ra.shape)
    pb = PF.HostCSR(ra.indptr, ra.indices, data, ra.shape)
    return ra, pa, rb, pb


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_family_with_non_finite_b_equals_the_reference(route, dtype):
    ra, pa, rb, pb = _plaw_with_non_finite_b(11)
    ref, port = _operands(ra, pa, rb, pb, block_k=128, bn=128, dtype=dtype)
    got = _check(ref, port, route).float()
    assert bool(got.isnan().any()) and bool(got.isfinite().any())
