"""granite-34b — llama-arch code model, MQA [arXiv:2405.04324].

88L d_model 6144, 48H with kv=1 (multi-query), d_ff 24576, vocab 49152.
MQA note: the single KV head cannot shard over the 16-way model axis —
KV projections/cache replicate across `model` (see distributed/sharding.py).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=128, head_dim=16)
