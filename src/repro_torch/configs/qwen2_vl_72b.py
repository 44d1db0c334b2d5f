"""qwen2-vl-72b — VLM backbone with M-RoPE [arXiv:2409.12191].

80L d_model 8192, 64H GQA kv=8 (head_dim 128), d_ff 29568, vocab 152064.
M-RoPE: rotary position split into (t, h, w) sections of the half head-dim
(16/24/24). Vision frontend is a STUB per assignment: inputs are precomputed
patch embeddings plus 3-D position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128, m_rope=True,
    m_rope_sections=(16, 24, 24), rope_theta=1.0e6,
    frontend="embeddings")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, head_dim=16, m_rope=True,
        m_rope_sections=(2, 3, 3), frontend="embeddings")
