"""Work counts checked by hand on tiny matrices, the least time, and the
power limit's reading."""
import numpy as np
import pytest

from cardbench import graphs, roofline


def rows(a):
    return np.repeat(np.arange(a.n), np.diff(a.indptr))


def test_spmm_work_by_hand():
    # 3 x 3, 4 entries, B 3 x 2: 2 * 4 * 2 flops; A: 4 * 4 row pointers +
    # 4 * (4 + 4) entries; B and C 3 * 2 * 4 bytes each
    flops, nbytes = roofline.spmm_work(3, 4, 2)
    assert flops == 16
    assert nbytes == 16 + 32 + 24 + 24


def test_a2_work_by_hand():
    # rows: 0 -> {0, 1}, 1 -> {1}, 2 -> {0, 2}: entry (i, j) meets row j
    a = graphs.from_coo([0, 0, 1, 2, 2], [0, 1, 1, 0, 2], np.ones(5), 3)
    flops, nbytes = roofline.a2_work(a.indptr, a.indices)
    # products: (0,0):2 (0,1):1 (1,1):1 (2,0):2 (2,2):2 = 8
    assert flops == 16
    assert nbytes == 2 * (4 * 4 + 8 * 5) + 4 * 9


def test_a2_work_counts_products_of_dense_product():
    a = graphs.gen_powerlaw(64, 6, seed=1)
    dense = np.zeros((a.n, a.n))
    dense[rows(a), a.indices] = 1.0
    flops, _ = roofline.a2_work(a.indptr, a.indices)
    # every nonzero product a_ik * a_kj, counted from the dense pattern
    assert flops == 2 * int((dense @ dense).sum())


def test_least_s_takes_the_binding_roof():
    peaks = roofline.H100_SXM
    assert roofline.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_s(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(67e12, 6.7e12, peaks) == pytest.approx(2.0)


def test_kron14_b64_bound():
    # kron-14 times 64 columns: 11.99 MB and 56.6 MFLOP, bytes-bound at
    # 3.58 us
    flops, nbytes = roofline.spmm_work(16384, 442528, 64)
    assert nbytes == 11_994_372
    assert flops == 56_643_584
    assert roofline.least_s(flops, nbytes) == pytest.approx(3.5804e-6,
                                                            rel=1e-4)


def test_power_limit_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(roofline.shutil, "which", lambda _: None)
    assert roofline.power_limit_w() is None


def test_power_limit_parses(monkeypatch):
    monkeypatch.setattr(roofline, "_smi", lambda q: "700.00")
    assert roofline.power_limit_w() == 700.0
