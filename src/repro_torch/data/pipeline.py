"""Deterministic synthetic data pipeline with sharded loading.

The counterpart of the JAX package's ``data/pipeline.py``: the same numpy
generation, line for line, so a batch equals the reference's for the same
(config, step, shard); it is handed over as tensors on ``device``.

The loader is *stateless given (step, shard)* — every batch is a pure
function of (seed, step, data_shard_index), so

* restart-after-failure resumes mid-epoch exactly (checkpoint stores only
  the step counter);
* elastic re-sharding is a pure re-indexing (no data re-shuffling);
* stragglers can be re-assigned a shard without coordination.

Token streams are a mixture of Zipfian unigram draws and short Markov
motifs, giving a learnable (compressible) distribution, so a short run
shows a real loss curve rather than log(V) noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["DataConfig", "make_batch", "host_batch_iterator", "batch_spec"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    num_motifs: int = 256
    frontend: str = "tokens"      # "tokens" | "embeddings"
    d_model: int = 0              # for embeddings frontend
    m_rope: bool = False


def _motif_table(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + 1234)
    return rng.integers(0, cfg.vocab_size,
                        (cfg.num_motifs, cfg.motif_len)).astype(np.int32)


def _host_batch(cfg: DataConfig, step: int, shard: int,
                num_shards: int) -> dict:
    """The batch for (step, shard) as numpy arrays."""
    bsz = cfg.global_batch // num_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))
    motifs = _motif_table(cfg)
    s = cfg.seq_len + 1
    # zipf-ish unigram background
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab_size, size=(bsz, s), p=probs).astype(np.int32)
    # plant motifs: ~50% of positions covered by repeated motifs
    n_plant = max(1, s // (2 * cfg.motif_len))
    for b in range(bsz):
        ids = rng.integers(0, cfg.num_motifs, n_plant)
        offs = rng.integers(0, max(s - cfg.motif_len, 1), n_plant)
        for mid, off in zip(ids, offs):
            toks[b, off: off + cfg.motif_len] = \
                motifs[mid][: max(0, min(cfg.motif_len, s - off))]
    batch: dict = {"labels": toks[:, 1:]}
    if cfg.frontend == "tokens":
        batch["tokens"] = toks[:, :-1]
    else:
        # modality-frontend stub: pretend an encoder produced embeddings
        emb_rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed + 77, step, shard]))
        batch["embeddings"] = emb_rng.standard_normal(
            (bsz, cfg.seq_len, cfg.d_model)).astype(np.float32)
        if cfg.m_rope:
            batch["positions3"] = np.broadcast_to(
                np.arange(cfg.seq_len, dtype=np.int32),
                (3, bsz, cfg.seq_len))
    return batch


def make_batch(cfg: DataConfig, step: int, shard: int = 0,
               num_shards: int = 1, *, device="cuda") -> dict:
    """Batch for (step, shard) on ``device`` (the card unless the caller
    asks for the CPU): int32 ``tokens``/``labels`` (B/num_shards, S), or
    fp32 ``embeddings`` (B/num_shards, S, D) with int32 ``positions3``
    (3, B/num_shards, S) for M-RoPE."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in _host_batch(cfg, step, shard, num_shards).items()}


def host_batch_iterator(cfg: DataConfig, start_step: int = 0,
                        shard: int = 0, num_shards: int = 1, *,
                        device="cuda"):
    step = start_step
    while True:
        yield step, make_batch(cfg, step, shard, num_shards, device=device)
        step += 1


def batch_spec(cfg: DataConfig, *, mode=None,
               float_dtype=torch.float32) -> dict:
    """Abstract stand-ins for one *global* batch (the dry-run's input):
    fake tensors of :func:`make_batch`'s shapes and dtypes (embeddings in
    ``float_dtype``, to meet weights of another dtype), in ``mode`` (a
    :class:`~torch._subclasses.fake_tensor.FakeTensorMode`; the shared one
    of :func:`repro_torch.launch.flop_cost.fake_mode` by default). They
    allocate nothing."""
    from repro_torch.launch.flop_cost import abstract
    b, s = cfg.global_batch, cfg.seq_len
    spec: dict = {"labels": abstract((b, s), torch.int32, mode=mode)}
    if cfg.frontend == "tokens":
        spec["tokens"] = abstract((b, s), torch.int32, mode=mode)
    else:
        spec["embeddings"] = abstract((b, s, cfg.d_model), float_dtype,
                                      mode=mode)
        if cfg.m_rope:
            spec["positions3"] = abstract((3, b, s), torch.int32, mode=mode)
    return spec
