"""The port's sharding rules executed for real: eight ``gloo`` rank
processes on a (2, 2, 2) ``("pod", "data", "model")`` mesh run the DTensor
train step (two microbatches, remat, AdamW) and two decode steps from the
JAX package's smoke-config parameters (carried across by
``lm_params_from_numpy``), and each result is held against the same step
on plain tensors and against the JAX package's ``make_train_step`` and
``decode_step`` on the same parameters and data — the counterpart of
``tests/test_distributed.py`` (8 forced host devices), for its four
architectures.

Bounds: the loss within 1e-5 relative; parameters within 1e-5 absolute,
but for the elements whose gradient is near Adam's ε (the first update
of an element is lr · g / (|g| + ε), so where |g| is itself near ε the
sharded sums' 1e-7 difference moves it by up to lr): those may be at
most 1e-3 of all, each within 2 × lr (the bound of
``tests/test_torch_train_step.py``); decode logits within 1e-5, finite.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("qwen3-14b", "mamba2-370m", "moonshot-v1-16b-a3b", "zamba2-2.7b")
WORLD = 8
TIMEOUT_S = 600
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
LOGIT_ATOL = 1e-5

_RANK_SCRIPT = textwrap.dedent("""
    import copy, datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    torch.set_num_threads(1)
    d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    dist.init_process_group(
        "gloo", store=dist.FileStore(d + "/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = make_test_mesh(data=2, model=2, pod=2)
    rules = shd.Rules(mesh=mesh, data_axes=("pod", "data"))
    out = {}

    def place(batch, kind):
        sp = shd.batch_specs(cfg, rules, kind)
        return {k: shd.shard_tensor(v, mesh, sp[k]) for k, v in batch.items()}

    for arch in sys.argv[4:]:
        cfg = smoke_config(arch)
        ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=5)
        tcfg = TrainConfig(microbatches=2, optimizer=ocfg)
        step = make_train_step(cfg, tcfg)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=8, frontend=cfg.frontend,
                          d_model=cfg.d_model, m_rope=cfg.m_rope)
        batch = make_batch(dcfg, 0, device="cpu")
        params = tfm.init_params(cfg, 0, device="cpu")
        params.load_state_dict(torch.load(f"{d}/{arch}.params.pt"))
        fresh = copy.deepcopy(params)
        ref_p = copy.deepcopy(params)
        ref_o = init_opt_state(ref_p, ocfg, device="cpu")
        ref_p, ref_o, ref_m = step(ref_p, ref_o, batch)

        opt = init_opt_state(params, ocfg, device="cpu")
        shd.shard_params(params, mesh, shd.param_specs(cfg, rules))
        opt = shd.shard_opt_state(opt, mesh,
                                  shd.param_specs(cfg, rules, fsdp=True))
        with shd.use_rules(rules), implicit_replication():
            params, opt, m = step(params, opt, place(batch, "train"))
        got = {n: p.full_tensor().detach() for n, p in params.named_parameters()}
        loss = float(m["loss"].full_tensor())
        lr = float(m["lr"])

        # decode: two steps from the same fresh weights
        if cfg.frontend == "tokens":
            sb = {"tokens": batch["tokens"][:, :1]}
        else:
            sb = {"embeddings": batch["embeddings"][:, :1]}
            if cfg.m_rope:
                sb["positions3"] = batch["positions3"][:, :, :1]
        cache = tfm.init_cache(cfg, 8, 16, device="cpu")
        ref_logits = []
        for _ in range(2):
            lg, cache = tfm.decode_step(cfg, fresh, sb, cache)
            ref_logits.append(lg.clone())
        sharded = copy.deepcopy(fresh)
        shd.shard_params(sharded, mesh, shd.param_specs(cfg, rules))
        scache = shd.shard_cache(tfm.init_cache(cfg, 8, 16, device="cpu"),
                                 mesh, shd.cache_specs(cfg, rules))
        logits = []
        with shd.use_rules(rules), implicit_replication():
            ssb = place(sb, "decode")
            for _ in range(2):
                lg, scache = tfm.decode_step(cfg, sharded, ssb, scache)
                logits.append(lg.full_tensor())
        if rank == 0:
            torch.save({"params": got, "loss": loss, "logits": logits},
                       f"{d}/{arch}.sharded.pt")
            errs = {n: (got[n] - p.detach()).abs() for n, p in
                    ref_p.named_parameters()}
            flat = torch.cat([e.flatten() for e in errs.values()])
            out[arch] = {
                "loss_ref": float(ref_m["loss"]), "loss": loss,
                "lr": lr, "param_max": float(flat.max()),
                "param_off": int((flat > PARAM_ATOL).sum()),
                "param_total": int(flat.numel()),
                "logit_err": max(float((a - b).abs().max())
                                 for a, b in zip(logits, ref_logits)),
                "logits_finite": all(bool(torch.isfinite(a).all())
                                     for a in logits)}
    if rank == 0:
        with open(d + "/result.json", "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
""").replace("PARAM_ATOL", repr(PARAM_ATOL))


def _reference_runs(arch):
    """The JAX package's train step (two microbatches) and two decode
    steps on the parameters and data the ranks use: (loss, parameters
    under the port's names, logits per step)."""
    import jax
    import numpy as np
    from repro.data import pipeline as ref_data
    from repro.models import transformer as ref_tf
    from repro.optim import adamw as ref_adamw
    from repro.train import step as ref_step
    from torch_port_helpers import lm_params_pair, ref_named
    rcfg, rparams, cfg, _ = lm_params_pair(arch)
    ocfg = ref_adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1,
                                 total_steps=5)
    step = jax.jit(ref_step.make_train_step(rcfg, ref_step.TrainConfig(
        microbatches=2, optimizer=ocfg)))
    batch = ref_data.make_batch(ref_data.DataConfig(
        vocab_size=rcfg.vocab_size, seq_len=32, global_batch=8,
        frontend=rcfg.frontend, d_model=rcfg.d_model, m_rope=rcfg.m_rope),
        0)
    rp, _, m = step(rparams, ref_adamw.init_opt_state(rparams, ocfg), batch)
    if rcfg.frontend == "tokens":
        sb = {"tokens": batch["tokens"][:, :1]}
    else:
        sb = {"embeddings": batch["embeddings"][:, :1]}
        if rcfg.m_rope:
            sb["positions3"] = batch["positions3"][:, :, :1]
    decode = jax.jit(lambda p, b, c: ref_tf.decode_step(rcfg, p, b, c))
    cache = ref_tf.init_cache(rcfg, 8, 16)
    logits = []
    for _ in range(2):
        lg, cache = decode(rparams, sb, cache)
        logits.append(np.asarray(lg))
    return float(m["loss"]), ref_named(cfg, rp), logits


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The ranks' results (rank 0's, against the unsharded port), the
    JAX package's runs and rank 0's sharded outputs, per architecture."""
    import torch
    from torch_port_helpers import lm_params_pair
    d = tmp_path_factory.mktemp("dist")
    for arch in ARCHS:
        torch.save(lm_params_pair(arch)[3].state_dict(),
                   d / f"{arch}.params.pt")
    env = dict(os.environ, PYTHONPATH=SRC)
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(d), str(r), str(WORLD),
         *ARCHS], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    errs = []
    try:
        # the reference runs while the ranks do
        refs = {arch: _reference_runs(arch) for arch in ARCHS}
        for p in ranks:
            _, err = p.communicate(timeout=TIMEOUT_S)
            errs.append(err)
    finally:
        for p in ranks:
            p.kill()
    assert [p.returncode for p in ranks] == [0] * WORLD, \
        "\n".join(e[-2000:] for e in errs)
    with open(d / "result.json") as f:
        res = json.load(f)
    return {arch: (res[arch], refs[arch],
                   torch.load(d / f"{arch}.sharded.pt")) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(sharded_runs, arch):
    r = sharded_runs[arch][0]
    assert r["loss"] == pytest.approx(r["loss_ref"], rel=LOSS_RTOL), r
    assert r["param_off"] <= 1e-3 * r["param_total"], r
    assert r["param_max"] <= 2 * r["lr"], r


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_unsharded(sharded_runs, arch):
    r = sharded_runs[arch][0]
    assert r["logits_finite"], r
    assert r["logit_err"] <= LOGIT_ATOL, r


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_the_reference(sharded_runs, arch):
    import numpy as np
    r, (loss, params, _), got = sharded_runs[arch]
    assert got["loss"] == pytest.approx(loss, rel=LOSS_RTOL)
    flat = np.concatenate([np.abs(got["params"][n].numpy() - want).ravel()
                           for n, want in params.items()])
    assert int((flat > PARAM_ATOL).sum()) <= 1e-3 * flat.size, flat.max()
    assert float(flat.max()) <= 2 * r["lr"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_the_reference(sharded_runs, arch):
    import numpy as np
    _, (_, _, logits), got = sharded_runs[arch]
    for lg, want in zip(got["logits"], logits, strict=True):
        np.testing.assert_allclose(lg.numpy(), want, rtol=0,
                                   atol=LOGIT_ATOL)
