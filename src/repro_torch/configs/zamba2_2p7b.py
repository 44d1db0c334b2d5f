"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers, d_model 2560, ssm_state 64; a single *shared* transformer
block (32H GQA kv=32, SwiGLU d_ff 10240) applied every 6 SSM blocks — the
Zamba2 parameter-sharing scheme. Sub-quadratic backbone: long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    hybrid_attn_every=6, rope_theta=1.0e4)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128, head_dim=16,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32,
        hybrid_attn_every=2)
