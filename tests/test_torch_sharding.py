"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, entry for entry: parameter, batch and cache specs and
the MoE/FSDP policies for all ten architectures on the (16, 16),
(2, 16, 16) and (2, 2, 2) meshes. The port's meshes are DeviceMeshes over
the ``fake`` process-group backend; the reference's rules take a JAX
``AbstractMesh`` of the same axes.

The port keeps one parameter group per layer, so its layer specs are the
reference's stacked specs without their leading (layer) entry, and a
Mamba2 layer's group is the block itself (the reference's
``layers["ssm"]``). Also: ``constrain`` drops non-dividing axes, specs and
DTensor placements round-trip, and each model site that DTensor could not
run as written (the padded-vocab fill, the SSD scan's einsums, the MoE
dispatch's scatter) runs on sharded operands.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import base as ref_configs
from repro.distributed import sharding as ref_shd
from repro_torch.configs import base as port_configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import ensure_fake_world, make_test_mesh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


class _Meshes:
    """A port DeviceMesh per shape, made over a fake world of its size
    when asked for (a mesh of another world is stale)."""

    def __getitem__(self, name):
        from torch.distributed.device_mesh import init_device_mesh
        shape, axes = MESHES[name]
        ensure_fake_world(int(np.prod(shape)))
        return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@pytest.fixture(scope="module")
def fake_meshes():
    yield _Meshes()
    if dist.is_initialized():
        dist.destroy_process_group()


def _rules(mesh_name, meshes):
    shape, axes = MESHES[mesh_name]
    data_axes = tuple(a for a in axes if a != "model")
    ref = ref_shd.Rules(mesh=AbstractMesh(shape, axes), data_axes=data_axes)
    port = shd.Rules(mesh=meshes[mesh_name], data_axes=data_axes)
    return ref, port


def _entries(p):
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _ref_as_port(cfg, ref_specs):
    """The reference's spec tree laid out as the port's (per-layer specs
    without their layer entry; the Mamba2 block un-nested)."""
    layers = ref_specs["layers"]
    if cfg.family in ("ssm", "hybrid"):
        layers = layers["ssm"]
    out = {k: v for k, v in ref_specs.items() if k != "layers"}
    out["layers"] = {path: _entries(p)[1:] for path, p in _flat(layers)}
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", port_configs.ARCH_IDS)
@pytest.mark.parametrize("fsdp", [None, False, True])
def test_param_specs_match_the_reference(fake_meshes, arch, mesh_name, fsdp):
    ref_r, port_r = _rules(mesh_name, fake_meshes)
    rcfg = ref_configs.get_config(arch)
    cfg = port_configs.get_config(arch)
    want = _ref_as_port(rcfg, ref_shd.param_specs(rcfg, ref_r, fsdp=fsdp))
    got = shd.param_specs(cfg, port_r, fsdp=fsdp)
    assert set(got) == set(want)
    assert dict(_flat(got["layers"])) == want["layers"]
    for key in set(got) - {"layers"}:
        assert dict(_flat(got[key])) == {
            path: _entries(p) for path, p in _flat(want[key])}, key


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", port_configs.ARCH_IDS)
def test_batch_and_cache_specs_match_the_reference(fake_meshes, arch,
                                                   mesh_name):
    ref_r, port_r = _rules(mesh_name, fake_meshes)
    rcfg = ref_configs.get_config(arch)
    cfg = port_configs.get_config(arch)
    for kind in ("train", "prefill", "decode"):
        want = {k: _entries(p) for k, p in
                ref_shd.batch_specs(rcfg, ref_r, kind).items()}
        assert shd.batch_specs(cfg, port_r, kind) == want, kind
    for sp in (False, True):
        want = {k: _entries(p) for k, p in
                ref_shd.cache_specs(rcfg, ref_r, seq_parallel=sp).items()}
        assert shd.cache_specs(cfg, port_r, seq_parallel=sp) == want, sp


@pytest.mark.parametrize("arch", port_configs.ARCH_IDS)
def test_moe_and_fsdp_policies_match_the_reference(arch):
    rcfg = ref_configs.get_config(arch)
    cfg = port_configs.get_config(arch)
    for ms in (1, 2, 8, 16, 32):
        assert shd.moe_policy(cfg, ms) == ref_shd.moe_policy(rcfg, ms)
        assert shd.fsdp_policy(cfg, ms) == ref_shd.fsdp_policy(rcfg, ms)
    assert shd.FSDP_THRESHOLD_BYTES == ref_shd.FSDP_THRESHOLD_BYTES


def test_spec_placement_round_trip(fake_meshes):
    mesh = fake_meshes["2x2x2"]
    for spec in [(("pod", "data"), None, "model"), (None, "model"),
                 ("data", None), (None, None, None), ("pod", "model")]:
        pl = shd.placements(mesh, spec)
        assert shd.spec_from_placements(mesh, pl, len(spec)) == spec
    with pytest.raises(ValueError):
        shd.placements(mesh, (("data", "pod"),))      # not in mesh order
    with pytest.raises(ValueError):
        shd.placements(mesh, ("model", "model"))      # one axis, two dims


def test_constrain_drops_non_dividing_axes(fake_meshes):
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake_meshes["2x2x2"]
    rules = shd.Rules(mesh=mesh, data_axes=("pod", "data"))
    x = shd.shard_tensor(torch.zeros(3, 4, 6), mesh, (None, None, None))
    plain = torch.zeros(3, 4)
    assert shd.constrain(x, "data", "model", None) is x     # no rules
    with shd.use_rules(rules):
        assert shd.constrain(plain, "data", "model") is plain
        y = shd.constrain(x, "data", "model", None)
        # batch 3 does not divide over (pod, data) = 4: dropped
        assert tuple(y.placements) == (Replicate(), Replicate(), Shard(1))
        z = shd.constrain(shd.shard_tensor(torch.zeros(4, 5), mesh,
                                           (None, None)), "data", "model")
        assert tuple(z.placements) == (Shard(0), Shard(0), Replicate())
        assert tuple(shd.sanitize(mesh, ("model",), (1,))) == (None,)


def _sharded_smoke(fake_meshes, arch):
    from repro_torch.models import transformer as tfm
    mesh = fake_meshes["2x2x2"]
    rules = shd.Rules(mesh=mesh, data_axes=("pod", "data"))
    cfg = port_configs.smoke_config(arch)
    params = tfm.init_params(cfg, 0, device="cpu")
    shd.shard_params(params, mesh, shd.param_specs(cfg, rules))
    return cfg, rules, params, mesh


def test_padded_vocab_fill_runs_on_a_vocab_sharded_head(fake_meshes):
    """transformer.py's padded-vocab mask is out of place (a sharded
    tensor takes no in-place slice fill); plain outputs keep the
    reference's -1e30."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import transformer as tfm
    cfg, rules, params, mesh = _sharded_smoke(fake_meshes, "qwen3-14b")
    assert cfg.padded_vocab != cfg.vocab_size
    x = shd.shard_tensor(torch.zeros(4, 8, cfg.d_model), mesh,
                         (("pod", "data"), None, None))
    with shd.use_rules(rules), implicit_replication():
        lg = tfm._head_out(cfg, params, x)
    assert lg.shape == (4, 8, cfg.padded_vocab)
    assert lg.placements[2].is_shard(2)
    plain = tfm.init_params(cfg, 0, device="cpu")
    out = tfm._head_out(cfg, plain, torch.randn(2, 3, cfg.d_model))
    assert (out[..., cfg.vocab_size:] == -1e30).all()


def test_ssd_scan_and_moe_dispatch_run_on_sharded_operands(fake_meshes):
    """The SSD scan (mamba2.py's chunk einsums) and the MoE dispatch's
    scatter run on each rank's shards (plain tensors), with the layouts
    their specs state."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import mamba2, moe
    cfg, rules, params, mesh = _sharded_smoke(fake_meshes, "mamba2-370m")
    u = shd.shard_tensor(torch.randn(4, 32, cfg.d_model), mesh,
                         (("pod", "data"), None, None))
    with shd.use_rules(rules), implicit_replication():
        y = mamba2.mamba2_block(cfg, params["layers"][0], u)
    assert y.shape == u.shape
    cfg, rules, params, mesh = _sharded_smoke(fake_meshes,
                                              "moonshot-v1-16b-a3b")
    x = shd.shard_tensor(torch.randn(4, 16, cfg.d_model), mesh,
                         (("pod", "data"), None, None))
    with shd.use_rules(rules), implicit_replication():
        out = moe.moe_ffn(cfg, params["layers"][0]["moe"], x)
    assert out.shape == x.shape
    assert out.placements[0].is_shard(0)


def test_test_mesh_runs_over_the_running_group(fake_meshes):
    ensure_fake_world(8)
    mesh = make_test_mesh(data=2, model=2, pod=2)
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert tuple(mesh.shape) == (2, 2, 2)
