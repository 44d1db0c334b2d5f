"""The frozen generators against the port's suite, and the benchmark's
own relabelling against the program's symmetric permutation."""
import numpy as np
import pytest

from cardbench import graphs
from repro_torch.core import suite
from repro_torch.core.formats import HostCSR

CASES = [
    ("kron", dict(scale=8, edge_factor=16)),
    ("kron", dict(scale=6, edge_factor=4)),
    ("caveman", dict(n=256, cave=24)),
    ("caveman", dict(n=100, cave=7, rewire=0.1)),
    ("powerlaw", dict(n=256, avg_deg=12)),
    ("powerlaw", dict(n=64, avg_deg=5)),
    ("mesh2d", dict(side=16, stencil=5)),
    ("mesh2d", dict(side=9, stencil=9)),
]


def rows(a):
    return np.repeat(np.arange(a.n), np.diff(a.indptr))


@pytest.mark.parametrize("name,kwargs", CASES)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_frozen_generator_equals_suite(name, kwargs, seed):
    got = graphs.GENERATORS[name](**kwargs, seed=seed)
    want = getattr(suite, f"gen_{name}")(**kwargs, seed=seed)
    assert got.n == want.nrows == want.ncols
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def test_kron_scale14_size():
    # the configuration's stated size: 16,384 vertices, 442,528 entries
    a = graphs.gen_kron(14, 16, seed=0)
    assert (a.n, a.nnz) == (16384, 442528)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_relabel_equals_program_permutation(seed):
    rng = np.random.default_rng(seed)
    a = graphs.integer_values(graphs.gen_powerlaw(96, 6, seed=seed), rng)
    perm = rng.permutation(a.n)
    got = graphs.relabel(a, perm)
    want = HostCSR(a.indptr, a.indices, a.data,
                   (a.n, a.n)).permute_symmetric(perm)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def test_relabel_is_similarity():
    rng = np.random.default_rng(4)
    a = graphs.integer_values(graphs.gen_kron(6, 4, seed=4), rng)
    perm = rng.permutation(a.n)
    dense = np.zeros((a.n, a.n))
    dense[rows(a), a.indices] = a.data
    r = graphs.relabel(a, perm)
    got = np.zeros_like(dense)
    got[rows(r), r.indices] = r.data
    np.testing.assert_array_equal(got, dense[np.ix_(perm, perm)])


def test_integer_values():
    a = graphs.gen_mesh2d(8, seed=0)
    b = graphs.integer_values(a, np.random.default_rng(0))
    assert set(np.unique(b.data)) == {1.0, 2.0, 3.0}
    assert b.data.dtype == np.float32
    np.testing.assert_array_equal(b.indices, a.indices)


def test_from_coo_sums_duplicates():
    a = graphs.from_coo([0, 0, 1, 0], [1, 1, 0, 0], [1.0, 2.0, 4.0, 5.0], 2)
    np.testing.assert_array_equal(a.indptr, [0, 2, 3])
    np.testing.assert_array_equal(a.indices, [0, 1, 0])
    np.testing.assert_array_equal(a.data, [5.0, 3.0, 4.0])
