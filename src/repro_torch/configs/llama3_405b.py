"""llama3-405b — dense GQA decoder [arXiv:2407.21783].

126L d_model 16384, 128H GQA kv=8 (head_dim 128), SwiGLU d_ff 53248,
vocab 128256, rope theta 5e5. Full attention: long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128, rope_theta=5.0e5)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=192, vocab_size=128, head_dim=8, rope_theta=5.0e5)
