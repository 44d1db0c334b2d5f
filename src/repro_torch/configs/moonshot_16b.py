"""moonshot-v1-16b-a3b — kimi/moonlight MoE [hf:moonshotai/Moonlight-16B-A3B].

48L d_model 2048, 16H GQA kv=16 (head_dim 128), per-expert d_ff 1408,
64 experts top-6, vocab 163840. 64 % 16 == 0 -> expert-parallel over the
model axis.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    num_experts=64, experts_per_token=6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=48, vocab_size=128, head_dim=16,
        num_experts=8, experts_per_token=2)
