"""mamba2-370m — attention-free SSD (state-space duality) [arXiv:2405.21060].

48L d_model 1024, ssm_state 128, expand 2 (d_inner 2048, 32 heads of 64),
vocab 50280. Attention-free: decode cache is O(heads*headdim*state) per
layer, independent of context length; long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        num_layers=3, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=128,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32)
