"""The port's LM serving engine, its int8 KV cache and decoding past the
cache's end, against the JAX package on the CPU.

* ``decode_step`` past the cache's end: the reference writes the last
  slot there (``dynamic_update_slice`` clamps its start index) and keeps
  masking ``idx <= pos``; the port does the same where it once raised
  ``IndexError``. Six steps into a 4-slot cache on the hybrid, a dense
  and a moe smoke config, logits and cache fields step by step within
  the LM tests' 1e-4 absolute + 1e-4 relative.
* ``ServingEngine``: the reference's semantics (prompts replayed token by
  token, one shared ``pos``, token 0 fed to every slot while decoding),
  3 requests on 2 slots, the same tokens request for request; once with
  a cache long enough and once with one the shared ``pos`` runs past.
* ``quantize_kv`` / ``dequantize_kv`` / ``quantized_cache_bytes``: int8
  values equal (half-way cases round to even in both), scales within
  1e-7, byte counts equal; and the reference's own 2e-2 bound on a
  decode attention output from the dequantized cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine
from repro.serve import quant as ref_quant
from repro_torch.configs import base as port_configs
from repro_torch.models import attention, transformer
from repro_torch.serve import engine, quant
from torch_port_helpers import lm_params_pair

LOGIT_RTOL = LOGIT_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen3-14b",
                                  "granite-moe-3b-a800m"])
def test_decode_past_the_cache_end_matches_the_reference(arch):
    """Steps 0–3 fill a 4-slot cache; steps 4 and 5 write its last slot
    again, as the reference does (before the repair the port raised
    ``IndexError: index 4 is out of bounds`` at step 4)."""
    rcfg, rparams, cfg, params = lm_params_pair(arch)
    rcache = ref_tf.init_cache(rcfg, 2, 4)
    cache = transformer.init_cache(cfg, 2, 4, device="cpu")
    step = jax.jit(lambda p, b, c: ref_tf.decode_step(rcfg, p, b, c))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (6, 2, 1)).astype(np.int32)
    for i, tok in enumerate(toks):
        want, rcache = step(rparams, {"tokens": jnp.asarray(tok)}, rcache)
        got, cache = transformer.decode_step(
            cfg, params, {"tokens": _t(tok).long()}, cache)
        _close(got.numpy(), np.asarray(want))
        assert cache["pos"] == int(rcache["pos"]) == i + 1
        for key in set(rcache) - {"pos"}:
            _close(cache[key].numpy(), np.asarray(rcache[key]))


@pytest.mark.parametrize("max_len", [64, 8])
@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m"])
def test_serving_engine_matches_the_reference(arch, max_len):
    """3 seeded prompts on 2 slots (the reference's own test's shape):
    every request finishes with 4 in-vocabulary tokens, equal to the
    reference's request for request. The shared ``pos`` ends at the sum
    of the prompts plus the decode steps: 18 here, past ``max_len`` 8."""
    rcfg, rparams, cfg, params = lm_params_pair(arch)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (3, 5, 2)]
    ref = ref_engine.ServingEngine(rcfg, rparams, slots=2, max_len=max_len)
    reqs_ref = [ref_engine.Request(prompt=p, max_new_tokens=4)
                for p in prompts]
    port = engine.ServingEngine(cfg, params, slots=2, max_len=max_len)
    reqs = [engine.Request(prompt=p, max_new_tokens=4) for p in prompts]
    for eng, rs in ((ref, reqs_ref), (port, reqs)):
        for r in rs:
            eng.submit(r)
        eng.run(steps=32)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
    assert [r.out for r in reqs] == [r.out for r in reqs_ref]
    assert port.cache["pos"] == int(ref.cache["pos"]) == 10 + 2 * 4
    assert list(port.positions) == list(ref.positions)


def test_serving_engine_follows_the_parameters():
    """The engine's cache takes the parameters' device and dtype (the
    reference takes the dtype of its first parameter leaf); an eos token
    ends a request early."""
    cfg = port_configs.smoke_config("qwen3-14b")
    params = transformer.init_params(cfg, 1, device="cpu",
                                     dtype=torch.bfloat16)
    eng = engine.ServingEngine(cfg, params, slots=2, max_len=16)
    assert eng.cache["k"].dtype == torch.bfloat16
    assert eng.cache["k"].device.type == "cpu"
    req = engine.Request(prompt=np.asarray([1, 2]), max_new_tokens=8)
    eng.submit(req)
    eng.run(steps=1)
    first = req.out[0]
    eng2 = engine.ServingEngine(cfg, params, slots=2, max_len=16,
                                eos_id=first)
    req2 = engine.Request(prompt=np.asarray([1, 2]), max_new_tokens=8)
    eng2.submit(req2)
    eng2.run(steps=8)
    assert req2.done and req2.out == [first]


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------


def _kv_cache(rng):
    k = rng.standard_normal((2, 3, 16, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 3, 16, 2, 32)).astype(np.float32)
    # half-way cases: a row whose largest value is 127 has scale 1, so
    # k + 0.5 rounds to the even neighbour
    k[0, 0, 0, 0] = np.r_[127.0, np.arange(31) - 15.5]
    return {"k": k, "v": v, "pos": 9}


def test_quantize_kv_matches_the_reference():
    cache = _kv_cache(np.random.default_rng(2))
    rq = ref_quant.quantize_kv({k: jnp.asarray(v) for k, v in cache.items()})
    q = quant.quantize_kv({k: (_t(v) if k != "pos" else v)
                           for k, v in cache.items()})
    assert set(q) == set(rq) == {"k_q", "k_scale", "v_q", "v_scale", "pos"}
    for key in ("k", "v"):
        assert q[key + "_q"].dtype == torch.int8
        assert np.array_equal(q[key + "_q"].numpy(),
                              np.asarray(rq[key + "_q"]))
        np.testing.assert_allclose(q[key + "_scale"].numpy(),
                                   np.asarray(rq[key + "_scale"]),
                                   rtol=0, atol=1e-7)
    assert q["k_q"][0, 0, 0, 0, 1:5].tolist() == [-16, -14, -14, -12]
    for dtype, rdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        dq = quant.dequantize_kv(q, dtype=dtype)
        rdq = ref_quant.dequantize_kv(rq, dtype=rdtype)
        assert dq["pos"] == 9 and dq["k"].dtype == dtype
        np.testing.assert_allclose(dq["k"].float().numpy(),
                                   np.asarray(rdq["k"], np.float32),
                                   rtol=1e-6, atol=1e-7)
    full = {"k": torch.zeros((2, 4, 64, 4, 32)),
            "v": torch.zeros((2, 4, 64, 4, 32))}
    got = quant.quantized_cache_bytes(full)
    want = ref_quant.quantized_cache_bytes(
        {k: jnp.zeros(v.shape, jnp.bfloat16) for k, v in full.items()})
    assert got == tuple(int(x) for x in want)
    assert got[1] < 0.6 * got[0]


def test_quantized_cache_attention_output_within_the_reference_bound():
    """The reference's own check (``tests/test_extensions.py``): decode
    attention from the dequantized cache within 2e-2 of the full one."""
    rng = np.random.default_rng(1)
    bsz, smax, hkv, hd, hq = 2, 64, 2, 32, 8
    kc = _t(rng.standard_normal((bsz, smax, hkv, hd)).astype(np.float32))
    vc = _t(rng.standard_normal((bsz, smax, hkv, hd)).astype(np.float32))
    q = _t(rng.standard_normal((bsz, 1, hq, hd)).astype(np.float32))
    want = attention.decode_attention(q, kc, vc, 40)
    dq = quant.dequantize_kv(quant.quantize_kv({"k": kc, "v": vc, "pos": 40}),
                             dtype=torch.float32)
    got = attention.decode_attention(q, dq["k"], dq["v"], 40)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)
    ref = ref_attention.decode_attention(
        jnp.asarray(q.numpy()), jnp.asarray(dq["k"].numpy()),
        jnp.asarray(dq["v"].numpy()), jnp.asarray(40))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
