"""The cost count of a sharded program is the count of its global work.

Under DTensor the counting mode sees most ops whole, at their global
shapes; inside a ``local_apply`` region (attention, the SSD scan and its
conv, the MoE dispatch and combine, the vocab-parallel lookup, the gold
gather) the ops run on each rank's shards, and the count takes each of
them times the ranks that split the region's work. So every family's
smoke train, prefill and decode cell on a fake (2, 2) mesh counts the
FLOPs of the same cell traced unsharded, exactly; the unsharded prefill
and train counts are held against the JAX package's jaxpr walker in
``test_torch_roofline_tools.py``, and the decode count here (equal but
for one named term, derived from the SSD step in both packages). Bytes
differ by what sharding adds (a weight replicated over the data axis is
read by each of its ranks' regions, a redistribution's layout ops):
within a factor of 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.flop_cost import trace, trace_cost

from torch_port_helpers import lm_params_pair, one_torch_thread  # noqa: F401

FAMILY_ARCHS = {"dense": "qwen3-14b", "moe": "granite-moe-3b-a800m",
                "ssm": "mamba2-370m", "hybrid": "zamba2-2.7b",
                "audio": "musicgen-large", "vlm": "qwen2-vl-72b"}
SEQ, BATCH = 32, 4


@pytest.fixture(scope="module")
def fake_2x2():
    from repro_torch.launch.mesh import ensure_fake_world, make_test_mesh
    ensure_fake_world(4)
    yield make_test_mesh(data=2, model=2)
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_sharded_cell_counts_the_global_work(family, kind, fake_2x2,
                                             one_torch_thread):
    from repro_torch.launch.specs import build_cell
    arch = FAMILY_ARCHS[family]
    shape = ShapeSpec("smoke_" + kind, kind, SEQ, BATCH)
    runs = {}
    for name, mesh in (("sharded", fake_2x2), ("plain", None)):
        cell = build_cell(arch, shape.name, mesh, microbatches=2,
                          cfg=smoke_config(arch), shape=shape)
        runs[name] = trace(cell.fn, *cell.args)
    sharded, plain = runs["sharded"], runs["plain"]
    assert plain.flops > 0
    assert sharded.flops == plain.flops
    assert plain.collectives == []
    ratio = sharded.bytes / plain.bytes
    print(f"bytes sharded / plain, {family} {kind}: {ratio:.3f}")
    assert 0.5 <= ratio <= 2.0, (sharded, plain)


def _decode_batches(cfg, rng):
    if cfg.frontend == "tokens":
        tok = rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
        ref, port = {"tokens": tok}, {"tokens": tok}
    else:
        emb = rng.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
        ref, port = {"embeddings": emb}, {"embeddings": emb}
        if cfg.m_rope:
            pos3 = np.zeros((3, BATCH, 1), np.int32)
            ref["positions3"] = port["positions3"] = pos3
    return ({k: jnp.asarray(v) for k, v in ref.items()},
            {k: torch.from_numpy(v) for k, v in port.items()})


def _step_term(cfg):
    """The reference's SSD recurrence-step FLOPs minus the port's: its
    state update, an outer product, is a dot_general in the reference's
    jaxpr (2·B·H·P·N) and a broadcast multiply in the port."""
    from repro.launch.jaxpr_cost import trace_cost as ref_cost
    from repro.models.mamba2 import ssd_decode_step as ref_step
    from repro_torch.launch.flop_cost import abstract
    from repro_torch.models.mamba2 import ssd_decode_step as port_step
    h, p, n, g = (cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_groups)
    shapes = [(BATCH, h, p, n), (BATCH, h, p), (BATCH, h), (h,),
              (BATCH, g, n), (BATCH, g, n)]
    return (ref_cost(ref_step, *[jax.ShapeDtypeStruct(s, jnp.float32)
                                 for s in shapes])["flops"]
            - trace_cost(port_step, *[abstract(s) for s in shapes])["flops"])


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_decode_flops_match_the_reference(family, one_torch_thread):
    """One decode step against a SEQ-slot cache: the port's count equals
    the reference's jaxpr count, but for the SSD step's outer product in
    each Mamba2 layer."""
    from repro.launch.jaxpr_cost import trace_cost as ref_cost
    from repro.models import transformer as ref_tfm
    from repro_torch.models import transformer as tfm
    rcfg, rparams, cfg, params = lm_params_pair(FAMILY_ARCHS[family])
    rb, pb = _decode_batches(cfg, np.random.default_rng(0))
    want = ref_cost(lambda p, b, c: ref_tfm.decode_step(rcfg, p, b, c),
                    rparams, rb, ref_tfm.init_cache(rcfg, BATCH, SEQ))
    cache = tfm.init_cache(cfg, BATCH, SEQ, device="cpu")
    got = trace_cost(lambda p, b, c: tfm.decode_step(cfg, p, b, c), params,
                     pb, cache)
    term = 0
    if cfg.family in ("ssm", "hybrid"):
        term = cfg.num_layers * _step_term(cfg)
        assert term == cfg.num_layers * 2 * BATCH * cfg.ssm_num_heads \
            * cfg.ssm_head_dim * cfg.ssm_state
    assert got["flops"] > 0
    assert want["flops"] - got["flops"] == term
    print(f"bytes port / reference, {family} decode: "
          f"{got['bytes'] / want['bytes']:.3f}")
    assert 0.5 <= got["bytes"] / want["bytes"] <= 2.0, (got, want)
