"""qwen3-14b — dense GQA decoder with QK-norm [hf:Qwen/Qwen3-8B family].

40L d_model 5120, 40H GQA kv=8 (head_dim 128), d_ff 17408, vocab 151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=17408, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1.0e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, head_dim=16, qk_norm=True)
