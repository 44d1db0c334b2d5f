"""The planner-driven sparse pipeline against the JAX package's.

The JAX package's ``tests/test_planner.py`` scenario — two block-diagonal
stages of 48 features, 3 microbatches of 2 rows, 2 passes — runs through
``repro.distributed.pipeline`` and ``repro_torch.distributed.pipeline``
(``Planner(device="cpu")``): both plan every stage at ``reuse_hint`` 6
on the SpMM menu with the same scheme, and their outputs agree within
1e-5 (exactly on integer values), as does ``bubble_fraction``. The
stages' tracer spans and the ``pipeline_stage_s`` histogram are read
too.
"""
import numpy as np
import pytest

from repro.core.suite import gen_block_diag as ref_gen_block_diag
from repro.distributed import pipeline as ref_pipeline
from repro.planner.service import Planner as RefPlanner
from repro_torch.core.formats import HostCSR
from repro_torch.distributed import pipeline
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.planner.service import Planner

from torch_port_helpers import integer_dense


def _stages(integer):
    ref = [ref_gen_block_diag(48, block=8, seed=s) for s in range(2)]
    if integer:
        ref = [type(m)(m.indptr, m.indices, np.random.default_rng(s)
                       .integers(1, 4, m.nnz).astype(np.float32), m.shape)
               for s, m in enumerate(ref)]
    port = [HostCSR(m.indptr, m.indices, m.data, m.shape) for m in ref]
    return ref, port


def _x(integer):
    rng = np.random.default_rng(1)
    if integer:
        return rng.integers(-2, 3, (3, 2, 48)).astype(np.float32)
    return rng.standard_normal((3, 2, 48)).astype(np.float32)


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
def test_pipeline_planned_stages_match_the_jax_package(integer):
    ref_mats, mats = _stages(integer)
    ref_planner, planner = RefPlanner(), Planner(device="cpu")
    ref_plans = ref_pipeline.plan_pipeline_stages(
        ref_mats, num_microbatches=3, passes=2, planner=ref_planner)
    plans = pipeline.plan_pipeline_stages(mats, num_microbatches=3,
                                          passes=2, planner=planner)
    assert all(p.reuse_hint == 6 for p in plans + ref_plans)
    assert [(p.reorder, p.scheme, p.workload) for p in plans] \
        == [(p.reorder, p.scheme, p.workload) for p in ref_plans]
    assert {p.workload for p in plans} == {"spmm"}
    x = _x(integer)
    want = np.asarray(ref_pipeline.pipeline_spmm_apply(
        ref_plans, ref_mats, x, planner=ref_planner))
    got = pipeline.pipeline_spmm_apply(plans, mats, x, planner=planner)
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    oracle = x.astype(np.float64)
    for m in mats:
        oracle = np.einsum("fk,mbk->mbf", m.to_dense(), oracle)
    if integer:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle.astype(np.float32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


def test_pipeline_records_stage_spans_and_times():
    _, mats = _stages(True)
    planner = Planner(device="cpu")
    hist = obs_metrics.get_registry().histogram("pipeline_stage_s")
    before = hist.count
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        plans = pipeline.plan_pipeline_stages(mats, 3, planner=planner)
        pipeline.pipeline_spmm_apply(plans, mats, _x(True), planner=planner)
        spans = [(s.name, s.attrs.get("stage"), s.attrs.get("phase"))
                 for s in tracer.spans()]
    finally:
        tracer.disable()
        tracer.clear()
    assert hist.count - before == 2
    for i in range(2):
        assert ("stage", i, "plan") in spans
        assert ("stage", i, "execute") in spans


def test_pipeline_rejects_malformed_stages():
    _, mats = _stages(True)
    planner = Planner(device="cpu")
    plans = pipeline.plan_pipeline_stages(mats, 3, planner=planner)
    with pytest.raises(ValueError, match="one plan per stage"):
        pipeline.pipeline_spmm_apply(plans[:1], mats, _x(True),
                                     planner=planner)
    wide = HostCSR.from_dense(integer_dense(48, 40, 0.1, 0))
    with pytest.raises(ValueError, match=r"\(F, F\)"):
        pipeline.pipeline_spmm_apply(plans, [mats[0], wide], _x(True),
                                     planner=planner)


@pytest.mark.parametrize("stages,microbatches",
                         [(1, 1), (2, 8), (4, 6), (8, 3)])
def test_bubble_fraction_matches_the_jax_package(stages, microbatches):
    got = pipeline.bubble_fraction(stages, microbatches)
    assert got == ref_pipeline.bubble_fraction(stages, microbatches)
    assert 0.0 <= got < 1.0
