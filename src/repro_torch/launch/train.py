"""End-to-end training driver.

The counterpart of the JAX package's ``launch/train.py``: deterministic
resumable data, checkpoint/restart, the NaN guard, the straggler monitor
and optional gradient compression, on the card unless the caller asks
for the CPU. The forward pass runs the model's own chunked attention and
SSD scan (``use_pallas=False``, as the reference's training path does:
the kernels have no backward).

Example (a smoke config on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --steps 20 --batch 4 --seq 64 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import (ARCH_IDS, ModelConfig, get_config,
                                      smoke_config)
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.compression import init_residuals
from repro_torch.distributed.elastic import NaNGuard, StragglerMonitor
from repro_torch.models.transformer import check_family, init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.step import TrainConfig, make_train_step

__all__ = ["run_training", "main"]


def run_training(arch: str | ModelConfig, *, smoke: bool = True,
                 steps: int = 50, batch: int = 8, seq: int = 128,
                 lr: float = 3e-4, microbatches: int = 1,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 compress: bool = False, seed: int = 0, log_every: int = 10,
                 param_dtype=torch.float32, device="cuda") -> dict:
    """Train ``arch`` (its smoke config with ``smoke``; a
    :class:`ModelConfig` is taken as it is, e.g. a published config cut in
    depth) from random weights (``seed``) for steps ``start..steps-1``,
    ``start`` the latest checkpoint in ``ckpt_dir`` or 0. Returns the
    reference's ``{"losses", "params", "final_loss", "first_loss"}`` plus
    ``"step_s"`` (each step's wall time, data included, ending in a
    device sync) and ``"peak_device_bytes"`` (the card's peak allocation
    over the run; None on the CPU)."""
    if isinstance(arch, ModelConfig):
        cfg = arch
    else:
        cfg = smoke_config(arch) if smoke else get_config(arch)
    check_family(cfg)
    dev = resolve_device(device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed,
                      frontend=cfg.frontend, d_model=cfg.d_model,
                      m_rope=cfg.m_rope)
    ocfg = AdamWConfig(lr_peak=lr, warmup_steps=max(steps // 10, 5),
                       total_steps=steps)
    tcfg = TrainConfig(microbatches=microbatches, optimizer=ocfg,
                       compress_grads=compress)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, seed, device=dev, dtype=param_dtype)
    opt_state = init_opt_state(params, ocfg, device=dev)
    residuals = init_residuals(params) if compress else None
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr is not None:
        got = mgr.restore_latest({"params": params, "opt": opt_state})
        if got is not None:
            start = got[0]
            print(f"[train] restored checkpoint at step {start}")

    guard = NaNGuard()
    monitor = StragglerMonitor()
    losses, step_s = [], []
    nparams = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name}: {nparams/1e6:.1f}M params, "
          f"batch={batch}×{seq}, steps {start}→{steps}")

    for step in range(start, steps):
        t0 = time.perf_counter()
        data = make_batch(dcfg, step, device=dev)
        if compress:
            params, opt_n, residuals_n, metrics = step_fn(
                params, opt_state, data, residuals)
        else:
            params, opt_n, metrics = step_fn(params, opt_state, data)
        loss = float(metrics["loss"])
        synchronize(dev)
        dt = time.perf_counter() - t0
        monitor.record(0, dt)
        step_s.append(dt)
        if guard.check(loss):
            opt_state = opt_n
            if compress:
                residuals = residuals_n
        else:
            print(f"[train] step {step}: non-finite loss — update skipped")
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} {dt:.2f}s")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     extra={"loss": loss})
    if mgr is not None:
        mgr.save(steps, {"params": params, "opt": opt_state},
                 extra={"loss": losses[-1] if losses else None})
    return {"losses": losses, "params": params,
            "final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "step_s": step_s,
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the architecture's published size")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_training(args.arch, smoke=args.smoke, steps=args.steps,
                       batch=args.batch, seq=args.seq, lr=args.lr,
                       microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       compress=args.compress, seed=args.seed,
                       device=args.device)
    print(f"[train] done: loss {out['first_loss']:.3f} → "
          f"{out['final_loss']:.3f}, {np.median(out['step_s']):.3f} s a step")


if __name__ == "__main__":
    main()
