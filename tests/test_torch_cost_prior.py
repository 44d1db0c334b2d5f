"""The kernel tier's traffic prior and the card's calibration source.

* ``CostModel(device="cuda")`` prices an unmeasured ``pallas`` candidate
  as the JAX package prices it on its accelerator (``_pallas_on_tpu``
  patched to ``True``, one core in both packages): the same
  ``kernel_rel`` within 1e-12 on every quick-tier spec (and on three
  denser patterns, where the prior sits between its floor and its
  ceiling), for ``original`` and ``rcm``, under ``a2``, ``spmm`` and
  ``batch`` — and so the same ranking and choice at every reuse count.
* On the CPU every candidate's score is the JAX package's off-TPU score,
  unchanged.
* ``fit_calibration()`` without ``samples=`` reads the port's sweep cache
  for the card's generation tag only: ``None`` without a cache or with
  only CPU or JAX-package rows, the same fit as ``samples=`` (and as the
  JAX package's) on the card's rows.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro import benchlib as ref_bench
from repro.core import suite as ref_suite
from repro.core.formats import HostCSR as RefHostCSR
from repro.planner import calibration as ref_calibration
from repro.planner import cost_model as ref_cost
from repro.planner.features import extract_features as ref_features
from repro_torch import benchlib
from repro_torch.core.formats import HostCSR
from repro_torch.planner import calibration as port_calibration
from repro_torch.planner import cost_model as port_cost
from repro_torch.planner.features import extract_features

QUICK = [s.name for s in ref_bench.representative_subset(8)]
# denser patterns than the 1,024-row suite's: 256-row kron and caveman
# (the front-end's burst members) and a half-full 128 × 128 block
DENSER = {"kron_8_16": lambda: ref_suite.gen_kron(8, 16, seed=0),
          "cave_256_24": lambda: ref_suite.gen_caveman(256, 24, seed=0),
          "half_dense_128": lambda: RefHostCSR.from_dense(
              (np.random.default_rng(0).random((128, 128)) < 0.5)
              .astype(np.float32))}
WORKLOADS = ("a2", "spmm", "batch")
_FEATS: dict = {}


def _features(name):
    """(reference, port) features of a suite spec or a denser pattern,
    computed once; both packages read the same numpy arrays."""
    if name not in _FEATS:
        if name in DENSER:
            ref_h = DENSER[name]()
        else:
            ref_h = ref_suite.generate(next(s for s in ref_suite.SUITE
                                            if s.name == name))
        port_h = HostCSR(ref_h.indptr, ref_h.indices, ref_h.data,
                         ref_h.shape)
        _FEATS[name] = (ref_features(ref_h), extract_features(port_h))
    return _FEATS[name]


@pytest.fixture
def one_core_accelerator(monkeypatch):
    """The JAX package's on-accelerator branch, both packages at one
    core (every card run: ``pallas_shard_count() == 1``)."""
    monkeypatch.setattr(ref_cost, "_pallas_on_tpu", lambda: True)
    monkeypatch.setattr(ref_cost, "_pallas_core_count", lambda: 1)
    monkeypatch.setattr(port_cost, "_pallas_core_count", lambda: 1)


@pytest.mark.parametrize("spec", QUICK + list(DENSER))
def test_card_prior_matches_the_jax_accelerator_branch(one_core_accelerator,
                                                       spec):
    f_ref, f_port = _features(spec)
    ref, port = ref_cost.CostModel(), port_cost.CostModel(device="cuda")
    for reorder in ("original", "rcm"):
        for workload in WORKLOADS:
            want = ref.score(f_ref, ref_cost.Candidate(reorder, "pallas"), 20,
                             workload=workload)
            got = port.score(f_port, port_cost.Candidate(reorder, "pallas"),
                             20, workload=workload)
            assert abs(got.kernel_rel - want.kernel_rel) <= 1e-12
            assert got.preprocess_rel == want.preprocess_rel
            assert got.amortizes == want.amortizes
            assert 0.15 <= got.kernel_rel <= port_cost.PALLAS_INTERPRET_REL
    for reuse in (1, 20, 10000):
        for workload in WORKLOADS:
            want = [(s.candidate.key, s.amortizes) for s in
                    ref.rank(f_ref, reuse, workload=workload)]
            got = [(s.candidate.key, s.amortizes) for s in
                   port.rank(f_port, reuse, workload=workload)]
            assert got == want


@pytest.mark.parametrize("spec", QUICK)
def test_cpu_scores_are_unchanged(spec):
    f_ref, f_port = _features(spec)
    ref, port = ref_cost.CostModel(), port_cost.CostModel(device="cpu")
    for c in port_cost.DEFAULT_CANDIDATES:
        for workload in WORKLOADS:
            for reuse in (1, 20):
                want = ref.score(f_ref, ref_cost.Candidate(c.reorder,
                                                           c.scheme),
                                 reuse, workload=workload)
                got = port.score(f_port, c, reuse, workload=workload)
                assert (got.kernel_rel, got.preprocess_rel, got.amortizes) \
                    == (want.kernel_rel, want.preprocess_rel,
                        want.amortizes), (c.key, workload, reuse)


def test_prior_terms_and_the_shard_divisor(monkeypatch):
    """The prior by hand on a dense 128 × 128 tile (fill 1: every term
    at its floor) and the per-shard divisor for the live-pair grid's
    workloads only."""
    f = _features("half_dense_128")[1]
    dense = dataclasses.replace(f, tile128_fill=1.0)
    model = port_cost.CostModel(device="cuda")
    cand = port_cost.Candidate("original", "pallas")
    want = ((port_cost.PALLAS_B_BYTES_PER_SLOT
             + port_cost.PALLAS_A_BYTES_PER_SLOT)
            / port_cost.PALLAS_GATHER_BYTES + port_cost.PALLAS_DEAD_STEP_REL)
    assert model.score(dense, cand, 20).kernel_rel == want
    monkeypatch.setattr(port_cost, "_pallas_core_count", lambda: 4)
    assert model.score(dense, cand, 20, workload="batch").kernel_rel \
        == want / 4
    assert model.score(dense, cand, 20, workload="spmm").kernel_rel == want


# ---------------------------------------------------------------------------
# the calibration's default source
# ---------------------------------------------------------------------------


def _cache_rows(gen):
    """A benchlib cache of seeded timings over three suite specs."""
    rng = np.random.default_rng(3)
    raw = {}
    for spec in ("mesh2d_24", "blkdiag_1024_8", "road_32"):
        for algo, scheme in (("original", "rowwise"), ("rcm", "rowwise"),
                             ("rcm", "fixed"), ("original", "fixed"),
                             ("gray", "variable"),
                             ("original", "hierarchical"),
                             ("original", "pallas")):
            raw[f"{spec}|{algo}|{scheme}|a2|{gen}"] = {
                "kernel_s": float(rng.uniform(0.5, 2.0)) * 1e-3,
                "preprocess_s": float(rng.uniform(0.0, 3.0)) * 1e-3,
                "nnz": 1, "flops": 2, "mem_bytes": 3, "nclusters": 0}
        raw[f"{spec}|original|rowwise|ts64_0|{gen}"] = {
            "kernel_s": 1.0, "preprocess_s": 0.0, "nnz": 1, "flops": 2,
            "mem_bytes": 3, "nclusters": 0}
    return raw


@pytest.fixture
def cache_file(monkeypatch, tmp_path):
    path = tmp_path / "bench_cache_torch.json"
    monkeypatch.setattr(benchlib, "CACHE_PATH", str(path))

    def write(raw):
        path.write_text(json.dumps(raw))
        return str(path)
    return write


def test_default_source_without_a_cache_returns_none(cache_file):
    assert port_calibration.fit_calibration() is None


def test_default_source_reads_the_cards_rows(cache_file):
    raw = _cache_rows(benchlib.kernel_gen("cuda"))
    path = cache_file(raw)
    rows = port_calibration._load_cache_samples(path, "torch1-cuda")
    # every A² row but the identity baselines, normalized by them
    assert len(rows) == 3 * 6
    base = raw["road_32|original|rowwise|a2|torch1-cuda"]["kernel_s"]
    r = next(x for x in rows if x["spec"] == "road_32"
             and x["scheme"] == "fixed" and x["reorder"] == "rcm")
    assert r["kernel_rel"] == \
        raw["road_32|rcm|fixed|a2|torch1-cuda"]["kernel_s"] / base
    got = port_calibration.fit_calibration()
    assert got is not None
    assert got.describe() == port_calibration.fit_calibration(
        samples=rows).describe()
    assert got.describe() == ref_calibration.fit_calibration(
        samples=rows).describe()
    # the kernel tier's rows stay out of the slope fit
    assert "pallas" not in got.kernel_scale
    assert got.describe() == port_calibration.fit_calibration(
        cache_path=path, artifacts_dir="experiments").describe()
    assert port_calibration.fit_calibration(min_samples=19) is None


def test_other_generations_never_reach_the_cards_fit(cache_file):
    """CPU rows of the port's cache and the JAX package's rows (its
    ``v4`` tag) give the card's read nothing to fit."""
    raw = _cache_rows(benchlib.kernel_gen("cpu"))
    raw.update(_cache_rows(ref_bench._KERNEL_GEN))
    path = cache_file(raw)
    assert port_calibration._load_cache_samples(path, "torch1-cuda") == []
    assert port_calibration.fit_calibration() is None
    assert len(port_calibration._load_cache_samples(path, "torch1-cpu")) \
        == 18
