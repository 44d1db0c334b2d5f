"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model 2048, 32H (kv=32), d_ff 8192, vocab 2048 (EnCodec codebook).
Modality frontend is a STUB per assignment: inputs are precomputed frame
embeddings (B, S, d_model); the backbone + vocab head are real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, frontend="embeddings")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=64, frontend="embeddings")
