"""Serving entry point: batched prefill + greedy decode throughput demo.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --no-smoke --batch 4 --prompt-len 1024 --gen 32

Any architecture of ``ARCH_IDS``; runs on the card unless ``--device cpu``
is given. The prefill's attention and SSD scans run the flash-attention
and fused SSD chunk-scan kernels (``run_serving(use_pallas=False)`` takes
the model's own chunked path instead); decoding runs plain torch ops. The
audio and vlm architectures take seeded random frame/patch embeddings in
place of tokens (and M-RoPE positions for vlm), drawn as the reference
draws them: the prompt's first, then one (B, 1, D) draw per decode step.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import (ARCH_IDS, ModelConfig, get_config,
                                      smoke_config)
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.transformer import check_family, init_params, prefill
from repro_torch.serve.engine import make_serve_step

__all__ = ["run_serving", "main"]


def run_serving(arch: str | ModelConfig, *, smoke: bool = True,
                batch: int = 4, prompt_len: int = 32, gen: int = 32,
                seed: int = 0, device="cuda", use_pallas: bool = True
                ) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (from
    ``seed``) on a randomly initialised ``arch`` (its smoke config with
    ``smoke``; a :class:`ModelConfig` is taken as it is, e.g. a published
    config cut in depth), then decode ``gen`` tokens greedily. Returns
    ``{"prefill_s", "decode_s", "decode_tok_per_s", "tokens" (batch,
    gen)}``; both times end in a device sync."""
    if isinstance(arch, ModelConfig):
        cfg = arch
    else:
        cfg = smoke_config(arch) if smoke else get_config(arch)
    check_family(cfg)
    dev = resolve_device(device)
    params = init_params(cfg, seed, device=dev)
    rng = np.random.default_rng(seed)
    max_len = prompt_len + gen

    def embeddings(seq):
        return torch.from_numpy(rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)).to(dev)

    if cfg.frontend == "tokens":
        batch_in = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(dev)}
    else:
        batch_in = {"embeddings": embeddings(prompt_len)}
        if cfg.m_rope:
            batch_in["positions3"] = torch.arange(
                prompt_len, device=dev)[None, None].expand(
                    3, batch, prompt_len)

    synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, batch_in, max_len,
                            use_pallas=use_pallas)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    synchronize(dev)
    t_prefill = time.perf_counter() - t0
    del logits

    step = make_serve_step(cfg)
    out_tokens = [tok[:, 0]]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        if cfg.frontend == "tokens":
            step_in = {"tokens": tok}
        else:
            step_in = {"embeddings": embeddings(1)}
            if cfg.m_rope:
                step_in["positions3"] = torch.full((3, batch, 1),
                                                   prompt_len + i,
                                                   device=dev)
        nxt, cache = step(params, cache, step_in)
        tok = nxt[:, None]
        out_tokens.append(nxt)
    synchronize(dev)
    t_decode = time.perf_counter() - t0
    toks = torch.stack(out_tokens, dim=1).cpu().numpy()
    return {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "tokens": toks,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the architecture's reduced config (--no-smoke: "
                         "its published size)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_serving(args.arch, smoke=args.smoke, batch=args.batch,
                      prompt_len=args.prompt_len, gen=args.gen,
                      device=args.device)
    print(f"[serve] prefill {out['prefill_s']:.2f}s, "
          f"decode {out['decode_s']:.2f}s "
          f"({out['decode_tok_per_s']:.1f} tok/s), "
          f"sample tokens: {out['tokens'][0][:8].tolist()}")


if __name__ == "__main__":
    main()
