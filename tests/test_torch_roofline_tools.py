"""The port's analysis tools — trip-exact FLOP/byte counting
(``repro_torch.launch.flop_cost``) and collective accounting
(``repro_torch.launch.comm_stats``) — the counterpart of
``tests/test_roofline_tools.py``, and held against the JAX package's
jaxpr walker on every family's smoke model.

FLOPs equal the reference's on every prefill and train step but for one
named term: the reference's SSD scan writes its decay products (the
segment-sum mask L, the chunk-state and state-output decays) into
multi-operand einsums, which XLA lowers to batched dot_generals, where
the port multiplies them elementwise. The test derives that term from
the scan alone, traced in both packages (forward, and forward + vjp):
per SSM layer, d_fwd for a prefill; (recomputes) × d_fwd + d_vjp for a
remat train step, where the ssm family's layer is recomputed once and
the hybrid family's twice (its group and its layer). Bytes are
fusion-modelled differently by construction; they must agree within a
factor of 2 (each family's ratio is in PERF.md).
"""
import copy

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.comm_stats import CollectiveLog, collective_stats
from repro_torch.launch.flop_cost import abstract, trace, trace_cost

from torch_port_helpers import lm_params_pair, one_torch_thread  # noqa: F401

FAMILY_ARCHS = {"dense": "qwen3-14b", "moe": "granite-moe-3b-a800m",
                "ssm": "mamba2-370m", "hybrid": "zamba2-2.7b",
                "audio": "musicgen-large", "vlm": "qwen2-vl-72b"}
SEQ, BATCH = 32, 4


def test_dot_flops_exact():
    c = trace_cost(lambda a, b: a @ b, abstract((8, 16)), abstract((16, 32)))
    assert c["flops"] == 2 * 8 * 16 * 32


def test_batched_dot_flops():
    c = trace_cost(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                   abstract((4, 8, 16)), abstract((4, 16, 32)))
    assert c["flops"] == 4 * 2 * 8 * 16 * 32


def test_loop_multiplies_by_its_trips():
    def f(x, w):
        for _ in range(13):
            x = torch.tanh(x @ w)
        return x
    c = trace_cost(f, abstract((8, 8)), abstract((8, 8)))
    assert c["flops"] == 13 * 2 * 8 * 8 * 8


def _grad_of(f):
    def g(w, x):
        w = w.detach().requires_grad_(True)
        f(w, x).backward()
    return g


def test_grad_includes_backward_flops():
    def f(w, x):
        return torch.sum(torch.tanh(x @ w))
    fwd = trace_cost(f, abstract((8, 8)), abstract((4, 8)))
    bwd = trace_cost(_grad_of(f), abstract((8, 8)), abstract((4, 8)))
    assert bwd["flops"] >= 2 * fwd["flops"]      # dgrad + wgrad ≈ 2× fwd


def test_remat_recompute_counted():
    def plain(w, x):
        return torch.sum(torch.tanh(x @ w))

    def remat(w, x):
        return torch.sum(checkpoint(lambda h: torch.tanh(h @ w), x,
                                    use_reentrant=False))
    a = trace_cost(_grad_of(plain), abstract((8, 8)), abstract((4, 8)))
    b = trace_cost(_grad_of(remat), abstract((8, 8)), abstract((4, 8)))
    fwd = trace_cost(plain, abstract((8, 8)), abstract((4, 8)))
    assert b["flops"] == a["flops"] + fwd["flops"]   # one more forward
    assert b["bytes"] > a["bytes"] > 0


def test_gather_counts_result_not_operand():
    c = trace_cost(lambda t, i: t[i], abstract((100000, 8)),
                   abstract((4,), torch.int64))
    # gathers count 2×result, never the full 3.2MB table
    assert c["bytes"] < 100000 * 8 * 4 / 10
    assert c["bytes"] == 2 * 4 * 8 * 4


def test_flop_count_equals_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    w, x = torch.randn(16, 16), torch.randn(4, 16)

    def f(w, x):
        w = w.detach().requires_grad_(True)
        y = checkpoint(lambda h: torch.tanh(h @ w) @ w, x,
                       use_reentrant=False)
        torch.einsum("bi,bj->ij", y, y).sum().backward()
    with FlopCounterMode(display=False) as fc:
        f(w, x)
    assert trace_cost(f, w, x)["flops"] == fc.get_total_flops()


def test_collective_stats_counts_a_fake_world_of_four():
    """One all-gather, then five all-reduces in a loop, on 4 fake ranks
    (the reference's HLO test's program)."""
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.launch.mesh import ensure_fake_world
    ensure_fake_world(4)
    try:
        group = dist.group.WORLD
        with CollectiveLog() as log:
            a = torch.zeros(4)
            g = funcol.all_gather_tensor(torch.zeros(2), 0, group)
            g = funcol.wait_tensor(g)
            for _ in range(5):
                a = funcol.wait_tensor(funcol.all_reduce(a, "sum", group))
        stats = collective_stats(log.records)
    finally:
        dist.destroy_process_group()
    assert stats["all-gather"]["count"] == 1
    assert stats["all-gather"]["bytes"] == 8 * 4
    assert stats["all-reduce"]["count"] == 5
    assert stats["all-reduce"]["bytes"] == 5 * 4 * 4
    assert stats["all-reduce"]["wire_bytes"] == 2 * 5 * 4 * 4
    assert stats["_total"]["count"] == 6


def test_model_flops_sanity():
    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.roofline import model_flops_for_cell
    cfg = get_config("llama3-405b")
    mf = model_flops_for_cell(cfg, SHAPES["train_4k"])
    n = cfg.param_count()
    assert 3.8e11 < n < 4.3e11                        # ≈405B params
    assert mf == 6.0 * n * 4096 * 256


# ---------------------------------------------------------------------------
# against the reference's jaxpr walker
# ---------------------------------------------------------------------------


def _ssd_term(cfg, micro_batch, micro):
    """(d_fwd, d_vjp): the reference's SSD-scan FLOPs minus the port's, at
    one microbatch's shapes, forward and forward + vjp."""
    from repro.launch.jaxpr_cost import trace_cost as ref_cost
    from repro.models.mamba2 import ssd_chunked as ref_ssd
    from repro_torch.models.mamba2 import ssd_chunked as port_ssd
    h, p, n, g = (cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_groups)
    q = min(cfg.ssm_chunk, SEQ)
    shapes = [(micro_batch, SEQ, h, p), (micro_batch, SEQ, h), (h,),
              (micro_batch, SEQ, g, n), (micro_batch, SEQ, g, n)]
    ref_args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    port_args = [abstract(s) for s in shapes]

    def ref_vjp(*a):
        y, vjp = jax.vjp(lambda *a: ref_ssd(*a, q)[0], *a)
        return vjp(y)

    def port_vjp(*a):
        a = [t.detach().requires_grad_(True) for t in a]
        y = port_ssd(*a, q)[0]
        y.backward(y.detach())

    d_fwd = (ref_cost(lambda *a: ref_ssd(*a, q), *ref_args)["flops"]
             - trace_cost(lambda *a: port_ssd(*a, q), *port_args)["flops"])
    d_vjp = (ref_cost(ref_vjp, *ref_args)["flops"]
             - trace_cost(port_vjp, *port_args)["flops"])
    return micro * d_fwd, micro * d_vjp


def _batches(cfg):
    from repro.data.pipeline import DataConfig as RD, make_batch as rbatch
    from repro_torch.data.pipeline import DataConfig, make_batch
    kw = dict(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
              frontend=cfg.frontend, d_model=cfg.d_model, m_rope=cfg.m_rope)
    return rbatch(RD(**kw), 0), make_batch(DataConfig(**kw), 0,
                                           device="cpu")


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_prefill_flops_match_the_reference(family, one_torch_thread):
    from repro.launch.jaxpr_cost import trace_cost as ref_cost
    from repro.models import transformer as ref_tfm
    from repro_torch.models import transformer as tfm
    rcfg, rparams, cfg, params = lm_params_pair(FAMILY_ARCHS[family])
    rb, pb = _batches(cfg)
    rb.pop("labels")
    pb.pop("labels")
    want = ref_cost(lambda p, b: ref_tfm.prefill(rcfg, p, b, SEQ), rparams,
                    rb)
    got = trace_cost(lambda p, b: tfm.prefill(cfg, p, b, SEQ), params, pb)
    term = 0
    if cfg.family in ("ssm", "hybrid"):
        term = cfg.num_layers * _ssd_term(cfg, BATCH, 1)[0]
        assert term > 0
    assert want["flops"] - got["flops"] == term
    print(f"bytes port / reference, {family} prefill: "
          f"{got['bytes'] / want['bytes']:.3f}")
    assert 0.5 <= got["bytes"] / want["bytes"] <= 2.0, (got, want)


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_train_step_flops_match_the_reference(family, micro,
                                              one_torch_thread):
    from repro.launch.jaxpr_cost import trace_cost as ref_cost
    from repro.optim.adamw import AdamWConfig as RA, init_opt_state as rinit
    from repro.train.step import TrainConfig as RT, make_train_step as rmake
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    rcfg, rparams, cfg, params = lm_params_pair(FAMILY_ARCHS[family])
    params = copy.deepcopy(params)
    rb, pb = _batches(cfg)
    want = ref_cost(rmake(rcfg, RT(microbatches=micro, optimizer=RA())),
                    rparams, rinit(rparams, RA()), rb)
    step = make_train_step(cfg, TrainConfig(
        microbatches=micro, skip_nonfinite=False, optimizer=AdamWConfig()))
    got = trace_cost(step, params, init_opt_state(params, AdamWConfig(),
                                                  device="cpu"), pb)
    term = 0
    if cfg.family in ("ssm", "hybrid"):
        d_fwd, d_vjp = _ssd_term(cfg, BATCH // micro, micro)
        recomputes = 2 if cfg.family == "hybrid" else 1
        term = cfg.num_layers * (recomputes * d_fwd + d_vjp)
        assert term > 0
    assert want["flops"] - got["flops"] == term
    print(f"bytes port / reference, {family} train ({micro} microbatches): "
          f"{got['bytes'] / want['bytes']:.3f}")
    assert 0.5 <= got["bytes"] / want["bytes"] <= 2.0, (got, want)


# ---------------------------------------------------------------------------
# the dry-run's period extrapolation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fake_2x2():
    from repro_torch.launch.mesh import ensure_fake_world, make_test_mesh
    ensure_fake_world(4)
    yield make_test_mesh(data=2, model=2)
    dist.destroy_process_group()


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_period_extrapolation_equals_a_full_depth_trace(family, fake_2x2):
    """Counts and collectives of a 3-period sharded train step (two
    microbatches) equal the extrapolation from its 1- and 2-period cuts,
    as the dry-run extrapolates."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch.comm_stats import scale_stats
    from repro_torch.launch.specs import build_cell
    arch = FAMILY_ARCHS[family]
    shape = ShapeSpec("smoke_train", "train", SEQ, BATCH)
    runs = []
    for periods in (1, 2, 3):
        cell = build_cell(arch, "smoke_train", fake_2x2, microbatches=2,
                          periods=periods, cfg=smoke_config(arch),
                          shape=shape)
        runs.append(trace(cell.fn, *cell.args))
    one, two, three = runs
    for key in ("flops", "bytes", "bytes_ub"):
        a, b = getattr(one, key), getattr(two, key)
        assert getattr(three, key) == a + 2 * (b - a), key
    assert three.flops > 0
    want = collective_stats(three.collectives)
    got = scale_stats(collective_stats(one.collectives),
                      collective_stats(two.collectives), 3)
    assert want["_total"]["count"] > 0
    for op, ent in want.items():
        assert got[op]["count"] == ent["count"], op
        assert got[op]["bytes"] == ent["bytes"], op
