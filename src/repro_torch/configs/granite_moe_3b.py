"""granite-moe-3b-a800m — fine-grained MoE [hf:ibm-granite family].

32L d_model 1536, 24H GQA kv=8 (head_dim 64), per-expert d_ff 512,
40 experts top-8, vocab 49155. 40 % 16 != 0 -> TP-on-d_ff expert sharding
policy (see distributed/sharding.py). MoE dispatch uses the paper's
cluster-wise dataflow (models/moe.py).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    num_experts=40, experts_per_token=8,
    moe_pad_experts=48)   # 48 % 16 == 0 -> expert-parallel (8 dummy experts)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=32, vocab_size=128, head_dim=16,
        num_experts=8, experts_per_token=2)
